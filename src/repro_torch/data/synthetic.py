"""Synthetic token streams for the serving CLI (numpy only).

Language modeling: a sparse random bigram/trigram process over a vocab —
fast models capture bigram mass, bigger models also capture the trigram
exceptions.  A copy of ``bigram_lm`` from the JAX package's
``repro/data/synthetic.py``; the same seed gives the same tokens.
"""
from __future__ import annotations

import numpy as np


def bigram_lm(num_seqs: int = 2000, seq_len: int = 128, vocab: int = 256,
              branching: int = 4, trigram_frac: float = 0.3,
              seed: int = 0, table_seed=None) -> np.ndarray:
    """Token sequences from a sparse bigram table with trigram 'exceptions'.

    Each token has `branching` plausible successors (uniform).  With
    probability `trigram_frac`, the successor is instead determined by the
    previous *two* tokens — structure only a higher-capacity model captures.
    Returns int32 [num_seqs, seq_len].
    """
    # transition tables come from table_seed so held-out splits can sample
    # NEW sequences from the SAME process (table_seed fixed, seed varied)
    trng = np.random.default_rng(seed if table_seed is None else table_seed)
    bigram = trng.integers(0, vocab, size=(vocab, branching))
    trigram = trng.integers(0, vocab, size=(vocab, vocab))
    rng = np.random.default_rng(seed)
    out = np.empty((num_seqs, seq_len), np.int32)
    tok = rng.integers(0, vocab, size=num_seqs)
    prev = rng.integers(0, vocab, size=num_seqs)
    for t in range(seq_len):
        out[:, t] = tok
        use_tri = rng.random(num_seqs) < trigram_frac
        nxt_bi = bigram[tok, rng.integers(0, branching, size=num_seqs)]
        nxt_tri = trigram[prev, tok]
        nxt = np.where(use_tri, nxt_tri, nxt_bi)
        prev, tok = tok, nxt.astype(np.int64)
    return out
