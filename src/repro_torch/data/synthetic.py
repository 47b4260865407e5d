"""Synthetic datasets (numpy only): a copy of the JAX package's
``repro/data/synthetic.py``, so the same seed gives the same arrays, bit
for bit.

Classification: a Gaussian-mixture task whose difficulty is set by class
overlap (``noise``) plus a fraction of ambiguous samples, and a deep
random teacher's task (the stand-ins for CIFAR-100 / ImageNet).  The
task must hold samples a small model gets wrong and a big model gets
right, *and* samples both get wrong — otherwise the LtC loss's
distinguishing term (1[exp wrong]) is inert.

Language modeling: a sparse random bigram/trigram process over a vocab —
fast models capture bigram mass, bigger models also capture the trigram
exceptions.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Dataset(NamedTuple):
    x: np.ndarray
    y: np.ndarray

    def split(self, fracs=(0.8, 0.1, 0.1), seed: int = 0):
        """train/val/test split (paper: 9:1 train/val + test)."""
        n = self.x.shape[0]
        rng = np.random.default_rng(seed)
        idx = rng.permutation(n)
        out = []
        start = 0
        for f in fracs:
            m = int(round(f * n))
            sl = idx[start:start + m]
            out.append(Dataset(self.x[sl], self.y[sl]))
            start += m
        return out


def gaussian_mixture(num_samples: int = 20000, num_classes: int = 20,
                     dim: int = 64, noise: float = 1.6,
                     hard_frac: float = 0.25, seed: int = 0) -> Dataset:
    """Class centers on a random simplex-ish arrangement; `hard_frac` of
    samples are drawn from midpoints of class pairs (ambiguous)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(num_classes, dim)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    centers *= 3.0
    y = rng.integers(0, num_classes, size=num_samples)
    x = centers[y] + noise * rng.normal(size=(num_samples, dim)).astype(np.float32)
    n_hard = int(hard_frac * num_samples)
    if n_hard:
        j = rng.integers(0, num_classes, size=n_hard)
        mid = 0.5 * (centers[y[:n_hard]] + centers[j])
        x[:n_hard] = mid + noise * rng.normal(size=(n_hard, dim)).astype(np.float32)
    return Dataset(x.astype(np.float32), y.astype(np.int32))


def teacher_task(num_samples: int = 200000, num_classes: int = 10,
                 latent_dim: int = 16, dim: int = 12, depth: int = 2,
                 obs_noise: float = 0.25, boundary_frac: float = 0.35,
                 seed: int = 0, return_info: bool = False):
    """Labels from a fixed random *deep* teacher network applied to the
    observed features — the decision boundary is genuinely nonlinear, so
    student capacity/depth buys accuracy (recreating the paper's Table-1
    ordering: ResNet152 > ResNet18 > compact models).

    `boundary_frac` of samples are rejection-sampled near the teacher's
    decision boundary (small top-2 margin) and labels are
    temperature-sampled: the low-margin pool carries irreducible label
    noise — samples where the fast model errs and part of which the
    expensive model also gets wrong, exactly the structure the LtC loss
    exploits (paper Fig 5).  latent_dim is unused in this observed-space
    variant (kept for config stability).
    """
    rng = np.random.default_rng(seed)
    sizes = [dim] + [96] * depth + [num_classes]
    ws = [rng.normal(size=(a, b)).astype(np.float32) * np.sqrt(2.0 / a)
          for a, b in zip(sizes[:-1], sizes[1:])]

    def teacher(x):
        h = x
        for w in ws[:-1]:
            h = np.tanh(h @ w)
        return h @ ws[-1]

    # oversample, keep a boundary_frac pool of low-margin samples
    x = rng.normal(size=(num_samples * 3, dim)).astype(np.float32)
    lg = teacher(x)
    srt = np.sort(lg, axis=-1)
    margin = srt[:, -1] - srt[:, -2]
    order = np.argsort(margin)
    n_hard = int(boundary_frac * num_samples)
    idx = np.concatenate([order[:n_hard], order[n_hard:num_samples]])
    x, lg = x[idx], lg[idx]
    # temperature-sampled labels: low-margin samples carry irreducible
    # label noise (the 'both models wrong' pool); obs_noise here acts as
    # the sampling temperature.  Teacher logits are normalized so the
    # temperature is meaningful across seeds.
    lg = lg / np.std(lg) * 4.0
    tau = max(obs_noise, 1e-3)
    g = rng.gumbel(size=lg.shape).astype(np.float32)
    y = (lg / tau + g).argmax(-1)
    perm = rng.permutation(len(x))
    ds = Dataset(x[perm].astype(np.float32), y[perm].astype(np.int32))
    if return_info:
        p = np.exp(lg / tau - (lg / tau).max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
        info = {"bayes_acc": float(p.max(-1).mean())}
        return ds, info
    return ds



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
