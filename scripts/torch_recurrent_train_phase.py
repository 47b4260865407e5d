"""Run ``chip_smoke.py``'s recurrent training phase (7e) alone on one
card.

Builds the port's CUDA kernels, draws phase 4's published-width
gemma3-1b -> phi4-mini-3.8b weights and runs
``chip_smoke.check_recurrent_training``: one train step of rwkv6-3b
(published widths, 2 layers), of the narrow jamba period, of LtC
gemma3-1b -> rwkv6-3b and -> jamba-v0.1-52b (smoke widths) and of the
one-period gemma3-1b with an exit head, each on the card against the
CPU with exact ``rwkv6_scan``, ``mamba_scan`` and ``moe_route``
launches; 8 LtC steps of the published gemma3-1b against the frozen
published rwkv6-3b; and that pair served untrained and trained.  From
the repo root:

    python3 scripts/torch_recurrent_train_phase.py

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
from repro_torch import kernels  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: this script needs an "
              "NVIDIA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke.card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    kernels.build(kernels.KERNELS)
    build_s = time.perf_counter() - t0
    params = chip_smoke.serve_async.build_params(chip_smoke.main_path_args())
    t0 = time.perf_counter()
    counts = chip_smoke.check_recurrent_training(
        card, torch.device("cuda:0"), params)
    chip_smoke.emit(phase="recurrent training alone", card=card,
                    build_s=build_s, phase_s=time.perf_counter() - t0,
                    launches=counts)
    return 0


if __name__ == "__main__":
    sys.exit(main())
