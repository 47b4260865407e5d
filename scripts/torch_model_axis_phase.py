"""Run ``chip_smoke.py``'s model-axis phase (10) alone.

Builds the port's CUDA kernels, draws phase 4's published-width
gemma3-1b -> phi4-mini-3.8b weights and runs
``chip_smoke.check_model_axis``: (10a) teacher-forced full-bucket ragged
steps of both tiers on two model shards over the first card twice
against unsharded, the workload unsharded and with both tiers on ``1x2``
meshes (``--shard-params``) in turns, and moonshot-v1-16b-a3b cut to 1 +
8 layers teacher-forced on two model shards; (10b, only where two cards
or more are visible) moonshot-v1-16b-a3b at its 48 layers on a ``1x2``
mesh over two cards, serving the workload behind gemma3-1b.  ``--cases``
first runs the card tests of the kernels at one model shard's head
layouts and the collectives across two cards; ``--cards-only`` runs 10b
alone (with ``--cases``, the collectives' test alone before it), for a
host of several cards.  From the repo root:

    python3 scripts/torch_model_axis_phase.py [--cases] [--cards-only]

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
    cards_only = "--cards-only" in sys.argv[1:]
    if "--cases" in sys.argv[1:]:
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        tests = subprocess.run(
            [sys.executable, "-m", "pytest", "-q", "-m", "cuda", "-p",
             "no:cacheprovider", "-k", "model_shard" if cards_only
             else "m2- or m8- or model_shard",
             str(ROOT / "tests" / "test_torch_kernels_cuda.py")],
            capture_output=True, text=True, env=env, timeout=900)
        last = (tests.stdout.strip().splitlines() or [""])[-1]
        chip_smoke.emit(check="model axis kernel cases", card=card,
                        rc=tests.returncode, tests=last)
        if tests.returncode != 0:
            print(tests.stdout[-6000:], flush=True)
            return 1
    params = chip_smoke.serve_async.build_params(chip_smoke.main_path_args())
    t0 = time.perf_counter()
    counts = (chip_smoke.check_model_axis_cards if cards_only
              else chip_smoke.check_model_axis)(card, params)
    chip_smoke.emit(phase="model axis alone", card=card, build_s=build_s,
                    phase_s=time.perf_counter() - t0, launches=counts)
    return 0


if __name__ == "__main__":
    sys.exit(main())
