"""Run ``chip_smoke.py``'s phase 15 alone: the sequence-split decode.

Draws phase 4's published-width gemma3-1b (f32, seed 0) and runs
``chip_smoke.check_seq_split``: a batch of 1 over a dense f32 cache of
``long_500k``'s 524288 positions (27.9 GB), the unsharded
``make_serve_step`` first, then ``make_serve_step(mesh=)`` on ``2x1``
(the keys split over the data shards) and on ``1x2`` and ``2x2`` with
``seq_over_model``, each over the first card on the same cache drawn
again: logits, argmax, written rows and untouched rows against
unsharded, step ms and peak memory; then the dry-run's trace of
``long_500k`` on ``2x1`` against the card.  The path runs no
hand-written kernel (the dense decode and ``conf`` are plain torch, as
in the JAX package), so nothing is built.  From the repo root:

    python3 scripts/torch_seq_split_phase.py

prints the card's ``name, power.limit`` line and the phase's JSON
records; exits non-zero if a check fails.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: this script needs an "
              "NVIDIA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke.card_line()
    print(card, flush=True)
    dev = torch.device("cuda:0")
    gemma = chip_smoke.init_params(
        chip_smoke.get_config("gemma3-1b", ""),
        chip_smoke.main_path_args().seed, torch.float32, dev)
    t0 = time.perf_counter()
    counts = chip_smoke.check_seq_split(card, dev, gemma)
    chip_smoke.emit(phase="sequence split alone", card=card,
                    phase_s=time.perf_counter() - t0, launches=counts)
    return 0


if __name__ == "__main__":
    sys.exit(main())
