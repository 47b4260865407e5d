"""Run ``chip_smoke.py``'s observability phase (4e) alone on one card.

Builds the port's CUDA kernels, draws phase 4's published-width
gemma3-1b -> phi4-mini-3.8b weights and runs
``chip_smoke.check_observability``: the phase-4 workload on the ragged
executor under a virtual clock untraced, with ``--trace-out``,
``--profile`` and ``--metrics-interval``, and with ``--trace-out`` alone
(equal streams, launches and host syncs; the trace checked by
``scripts/check_trace.py``; one ``run_ragged/<tier>`` profiler range a
launch; the host milliseconds per engine phase beside the device idle
share), then with ``--flat-buckets 16 48 160 512`` under the margin rule
(the bounds measured here as phase 4b measures them).  From the repo
root:

    python3 scripts/torch_observability_phase.py

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
    counts = chip_smoke.check_observability(card, params)
    chip_smoke.emit(phase="observability alone", card=card,
                    build_s=build_s, phase_s=time.perf_counter() - t0,
                    launches=counts)
    return 0


if __name__ == "__main__":
    sys.exit(main())
