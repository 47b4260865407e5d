"""Run ``chip_smoke.py``'s phase 14 alone: the dry-run's accounting
against the card.

Builds the port's CUDA kernels, runs phase 2's checks of the kernels the
phase's steps launch (``chip_smoke.check_flash``: ``flash_attention`` at
phi4-mini-3.8b's [8, 24, 640, 128] and a model shard's [8, 12, 640,
128] among its cases; ``chip_smoke.check_router``: every ``moe_route``
case, granite's train route [1, 1024, 40] among them), draws phase 4's
published-width phi4-mini-3.8b and runs ``chip_smoke.check_dryrun``:
each step traced on a mesh of ``meta`` devices by
``repro_torch.launch.dryrun.trace_cfg``, then run on the same mesh over
the first card under the same counting mode — phi4's prefill of 8 x 640
tokens on ``1x1`` and ``1x2``, its decode over a 640-token dense cache
on ``1x1`` and ``2x1``, granite-moe-3b-a800m cut to 2 layers training on
``2x1`` — with counts, launches and argument bytes held equal, each
step's median time beside its H100 roofline, and the peak estimate
beside ``max_memory_allocated``.  ``--cases`` first runs the card test
of the wrappers' counts (``-k count_on_card``).  From the repo root:

    python3 scripts/torch_dryrun_phase.py [--cases]

prints the card's ``name, power.limit`` line and the phase's JSON
records; exits non-zero if a check fails.
"""
from __future__ import annotations

import os
import subprocess
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
    if "--cases" in sys.argv[1:]:
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        tests = subprocess.run(
            [sys.executable, "-m", "pytest", "-q", "-m", "cuda", "-p",
             "no:cacheprovider", "-k", "count_on_card",
             str(ROOT / "tests" / "test_torch_kernels_cuda.py")],
            capture_output=True, text=True, env=env, timeout=600)
        last = (tests.stdout.strip().splitlines() or [""])[-1]
        chip_smoke.emit(check="dry-run kernel counts", card=card,
                        rc=tests.returncode, tests=last)
        if tests.returncode != 0:
            print(tests.stdout[-6000:], flush=True)
            return 1
    dev = torch.device("cuda:0")
    flush = torch.empty(128 * 2 ** 20 // 4, device=dev)   # > 50 MB L2
    chip_smoke.check_flash(dev, flush)
    chip_smoke.check_router(dev, flush)
    del flush
    torch.cuda.empty_cache()
    phi4 = chip_smoke.init_params(
        chip_smoke.get_config(chip_smoke.PHI4_NAME, ""),
        chip_smoke.main_path_args().seed + 1, torch.float32, dev)
    t0 = time.perf_counter()
    counts = chip_smoke.check_dryrun(card, dev, phi4)
    chip_smoke.emit(phase="dry-run alone", card=card, build_s=build_s,
                    phase_s=time.perf_counter() - t0, launches=counts)
    return 0


if __name__ == "__main__":
    sys.exit(main())
