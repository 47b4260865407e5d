"""Profile ``chip_smoke.py``'s other cascades (phase 6) alone.

Builds the port's CUDA kernels, draws phase 4's published-width
gemma3-1b weights and runs ``chip_smoke.profile_families``: the
gemma3-1b -> granite-moe-3b-a800m cascade under the ragged executor, and
gemma3-1b -> rwkv6-3b and -> jamba-v0.1-52b (1 of its 4 periods) on the
uniform path, each expensive tier's weights drawn in turn, each workload
cut to ``chip_smoke.PROFILE_REQUESTS`` requests and served under a
virtual clock inside ``torch.profiler`` (device time by kernel kind, the
device's idle share).  From the repo root:

    python3 scripts/torch_family_profiles.py

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
    args = chip_smoke.main_path_args()
    fast = chip_smoke.init_params(
        chip_smoke.get_config("gemma3-1b", args.variant), args.seed,
        torch.float32, torch.device("cuda:0"))
    t0 = time.perf_counter()
    chip_smoke.profile_families(card, fast)
    chip_smoke.emit(phase="family profiles alone", card=card,
                    build_s=build_s, phase_s=time.perf_counter() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
