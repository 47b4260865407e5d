"""Run ``chip_smoke.py``'s multi-device phase (9) alone.

Builds the port's CUDA kernels, draws phase 4's published-width
gemma3-1b -> phi4-mini-3.8b weights and runs
``chip_smoke.check_multidevice``: (9a) the workload unsharded and with
both tiers on ``2x1`` meshes over the first card twice (two data shards
a tier), in turns, then two shards over 64 KV blocks under ``youngest``
preemption; (9b, only where two cards or more are visible) the tiers on
``cuda:0`` and ``cuda:1``, tier 1 on a ``2x1`` mesh over both, and each
kernel launched on ``cuda:1`` while ``cuda:0`` is current.  From the repo
root:

    python3 scripts/torch_multidevice_phase.py

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
    counts = chip_smoke.check_multidevice(card, params)
    chip_smoke.emit(phase="multidevice alone", card=card, build_s=build_s,
                    phase_s=time.perf_counter() - t0, launches=counts)
    return 0


if __name__ == "__main__":
    sys.exit(main())
