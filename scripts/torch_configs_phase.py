"""Run ``chip_smoke.py``'s phase 8 (the rest of the registry) alone on
one card.

Builds the port's CUDA kernels, draws phase 4's published-width
gemma3-1b (seed 0) and runs ``chip_smoke.check_configs``: the steps of
kimi-k2-1t-a32b cut to its dense first layer (head width 112), of
qwen2-vl-72b cut to 1 layer and of the five configs' smoke widths on the
card against the CPU, then gemma3-1b -> starcoder2-7b (ragged, padded,
split), -> musicgen-large and -> qwen2-vl-72b cut to 8 layers (uniform by
themselves) and -> moonshot-v1-16b-a3b cut to its dense first layer and 8
MoE layers (ragged) served with exact launch counts.  From the repo
root:

    python3 scripts/torch_configs_phase.py

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
    dev = torch.device("cuda:0")
    args = chip_smoke.main_path_args()
    fast = chip_smoke.init_params(
        chip_smoke.get_config(args.fast, args.variant), args.seed,
        torch.float32, dev)
    t0 = time.perf_counter()
    counts = chip_smoke.check_configs(card, dev, fast)
    chip_smoke.emit(phase="registry alone", card=card, build_s=build_s,
                    phase_s=time.perf_counter() - t0, launches=counts)
    return 0


if __name__ == "__main__":
    sys.exit(main())
