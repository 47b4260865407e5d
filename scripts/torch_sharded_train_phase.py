"""Run ``chip_smoke.py``'s phase 13 alone: sharded training.

Builds the port's CUDA kernels, runs phase 2's checks of the kernels
the sharded train step launches (``chip_smoke.check_router``: every
``moe_route`` case, granite's train route [1, 1024, 40] among them;
``chip_smoke.check_rwkv``: ``rwkv6_scan`` and the differentiable
``_RWKV6Scan`` at a model shard's [4, 20, 256, 64]), draws phase 4's
published-width phi4-mini-3.8b (the frozen expensive model) and runs
``chip_smoke.check_sharded_training``: two steps of the train and LtC
steps built with ``mesh=`` on ``2x1`` and ``1x2`` meshes over the first
card against the unsharded steps on the same batches (phase 7b's 4 x
256 tokens, adafactor, lr 1e-3) — (a) LtC of the published gemma3-1b
against phi4-mini-3.8b (and on ``2x1`` over two cards where two are
visible), (b) granite-moe-3b-a800m at its published widths cut to 2
layers, (c) rwkv6-3b cut to 2 layers on ``1x2`` — with per-step losses,
params and Adafactor state against unsharded, exact ``moe_route`` /
``rwkv6_scan`` launches, step ms, tokens/s and peak memory.  ``--cases`` first runs the
card tests of the sharded train step's kernel shapes (``-k
"granite-train or model-shard-train or train_route"``).  From the repo
root:

    python3 scripts/torch_sharded_train_phase.py [--cases]

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

CASES = "granite-train or model-shard-train or train_route"


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
             "no:cacheprovider", "-k", CASES,
             str(ROOT / "tests" / "test_torch_kernels_cuda.py")],
            capture_output=True, text=True, env=env, timeout=600)
        last = (tests.stdout.strip().splitlines() or [""])[-1]
        chip_smoke.emit(check="sharded training kernel cases", card=card,
                        rc=tests.returncode, tests=last)
        if tests.returncode != 0:
            print(tests.stdout[-6000:], flush=True)
            return 1
    dev = torch.device("cuda:0")
    flush = torch.empty(128 * 2 ** 20 // 4, device=dev)   # > 50 MB L2
    chip_smoke.check_router(dev, flush)
    chip_smoke.check_rwkv(dev, flush)
    del flush
    phi4 = chip_smoke.init_params(
        chip_smoke.get_config(chip_smoke.PHI4_NAME, ""),
        chip_smoke.main_path_args().seed + 1, torch.float32, dev)
    t0 = time.perf_counter()
    counts = chip_smoke.check_sharded_training(card, dev, phi4)
    chip_smoke.emit(phase="sharded training alone", card=card,
                    build_s=build_s, phase_s=time.perf_counter() - t0,
                    launches=counts)
    return 0


if __name__ == "__main__":
    sys.exit(main())
