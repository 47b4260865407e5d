"""Profile ``chip_smoke.py``'s speculation runs (phase 4b) alone.

Builds the port's CUDA kernels, draws phase 4's published-width
gemma3-1b -> phi4-mini-3.8b weights and runs
``chip_smoke.profile_speculation``: the phi4 and the gemma3-1b
self-speculation cascades at ``--speculate 0`` and ``4``, ``gen_len`` 8,
each served under a virtual clock inside ``torch.profiler`` (device time
by kernel kind, the device's idle share).  From the repo root:

    python3 scripts/torch_speculation_profiles.py

prints the card's ``name, power.limit`` line and the profiles' JSON
records.
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
    chip_smoke.profile_speculation(card, params)
    chip_smoke.emit(phase="speculation profiles alone", card=card,
                    build_s=build_s, phase_s=time.perf_counter() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
