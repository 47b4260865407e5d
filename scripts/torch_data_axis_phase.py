"""Run ``chip_smoke.py``'s data-axis phase (11) alone.

Builds the port's CUDA kernels, then, with both tiers on ``2x1`` meshes
over the first card twice against unsharded: draws phase 4's
published-width gemma3-1b -> phi4-mini-3.8b weights and runs
``chip_smoke.check_data_axis`` (11a the uniform prefill path and the
dense arena, 11b speculation at k = 4); draws granite-moe-3b-a800m's in
place of phi4-mini-3.8b's and runs ``check_data_axis_moe`` (11c: 2 layers
teacher-forced on two data shards against unsharded and the CPU, then
the cascade served unsharded and on ``2x1``); draws rwkv6-3b's and runs
``check_data_axis_rwkv`` (11d).  ``--cases`` first runs the card tests
of the shard shapes (``flash_attention`` at a shard's prefill batch,
``moe_route`` over two shards' logits).  From the repo root:

    python3 scripts/torch_data_axis_phase.py [--cases]

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
             "no:cacheprovider", "-k", "data_shard",
             str(ROOT / "tests" / "test_torch_kernels_cuda.py")],
            capture_output=True, text=True, env=env, timeout=600)
        last = (tests.stdout.strip().splitlines() or [""])[-1]
        chip_smoke.emit(check="data axis kernel cases", card=card,
                        rc=tests.returncode, tests=last)
        if tests.returncode != 0:
            print(tests.stdout[-6000:], flush=True)
            return 1
    t0 = time.perf_counter()
    args = chip_smoke.main_path_args()
    params = chip_smoke.serve_async.build_params(args)
    counts = chip_smoke.check_data_axis(card, params)
    dev = chip_smoke.card_devices()[0]
    for name, check in ((chip_smoke.MOE_NAME, chip_smoke.check_data_axis_moe),
                        (chip_smoke.RWKV_NAME,
                         chip_smoke.check_data_axis_rwkv)):
        params = (params[0], None)
        torch.cuda.empty_cache()
        params = (params[0], chip_smoke.init_params(
            chip_smoke.get_config(name, args.variant), args.seed + 1,
            torch.float32, dev))
        counts.update(check(card, params))
    chip_smoke.emit(phase="data axis alone", card=card, build_s=build_s,
                    phase_s=time.perf_counter() - t0, launches=counts)
    return 0


if __name__ == "__main__":
    sys.exit(main())
