"""Device time of the paged tile body's decode layout against its prefill
layout alone, on the decode cases.

``csrc/paged_tile.cuh`` attends an item of at most 16 live MMA rows (a
decode token's G query heads) in its decode layout, where the 4 warps
share those rows and each multiplies a quarter of every K/V tile, and
any larger item in its prefill layout (16 rows a warp).  This script
builds a second copy of the ragged and paged kernels in which every item
takes the prefill layout (the copy of ``csrc/`` under
``build/paged_layouts/`` differs in the one line that picks the layout),
then times the decode cases of ``scripts/torch_paged_splits.py``
(gemma3-1b, phi4-mini-3.8b and granite-moe-3b-a800m, 8 rows at positions
590-625, f32, the launcher's split plan) under both builds, in the order
both, one-layout, one-layout, both, and prints one JSON line per case
with the profiler's device ms of each run (L2 flushed before each call).
Needs one NVIDIA card:

    PYTHONPATH=src python3 scripts/torch_paged_layouts.py
"""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke as cs  # noqa: E402
import torch_paged_splits as tps  # noqa: E402
from repro_torch import kernels  # noqa: E402

CHOICE = """  if (it.ntok * a.G <= 16)
    attend<QT, KT, D, kWarps>(a, it, smem);
  else
    attend<QT, KT, D, 1>(a, it, smem);"""
ONE_LAYOUT = "  attend<QT, KT, D, 1>(a, it, smem);"
NAMES = ("ragged_attention", "paged_attention")


def one_layout_csrc() -> Path:
    """A copy of ``csrc/`` whose tile body takes the prefill layout for
    every item."""
    dst = ROOT / "build" / "paged_layouts" / "csrc"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(kernels.CSRC, dst)
    tile = dst / "paged_tile.cuh"
    src = tile.read_text()
    if src.count(CHOICE) != 1:
        raise RuntimeError("paged_tile.cuh: the layout choice was not found "
                           "once; update CHOICE to the source")
    tile.write_text(src.replace(CHOICE, ONE_LAYOUT))
    return dst


def use(csrc: Path) -> None:
    """Load the ragged and paged kernels from ``csrc`` from now on."""
    kernels.CSRC = csrc
    kernels._LIBS.clear()


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_paged_layouts: needs an NVIDIA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    flush = torch.empty(128 * 2 ** 20 // 4, device=dev)
    print(json.dumps({"card": cs.card_line()}), flush=True)
    variants = {"both layouts": kernels.CSRC,
                "prefill layout only": one_layout_csrc()}
    for csrc in variants.values():
        use(csrc)
        kernels.build(NAMES)
    cases = [c for c in tps.cases(dev) if "decode" in c[0]]
    order = ["both layouts", "prefill layout only", "prefill layout only",
             "both layouts"]
    res = {name: {v: [] for v in variants} for name, _, _ in cases}
    for v in order:
        use(variants[v])
        for name, kind, fn in cases:
            res[name][v].append(
                cs.kernel_ms(lambda f=fn: f(None), kind, flush, iters=20))
    for name, _, _ in cases:
        print(json.dumps({"case": name, "kernel_ms": res[name]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
