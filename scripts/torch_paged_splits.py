"""Device time of the ragged and paged attention kernels by page-split count.

At ``chip_smoke.py``'s phase-2 timed shapes (gemma3-1b, phi4-mini-3.8b
and granite-moe-3b-a800m: the full 8 x 64 prefill bucket and the decode
tick of 8 rows at positions 590-625, f32, pools of 41 pages of 16), runs
each kernel under the launcher's own split plan (``plan_page_splits``)
and forced to 1, 2, 4, 8 and 16 splits, and prints one JSON line per
case: for each split count the profiler's device time of the kernel and
its merge kernel (L2 flushed before each call), the CUDA-event time of
one call and the back-to-back time.  Needs one NVIDIA card:

    PYTHONPATH=src python3 scripts/torch_paged_splits.py
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import paged_attention as paged_mod  # noqa: E402
from repro_torch.kernels import ragged_attention as ragged_mod  # noqa: E402

SPLITS = (None, 1, 2, 4, 8, 16)
SHAPES = (("gemma3", cs.GEMMA, 512), ("phi4", cs.PHI4, None),
          ("granite", cs.GRANITE, None))


def cases(dev):
    """(name, kind, fn(splits)) at the phase-2 timed shapes."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    starts = [0, 100, 200, 300, 400, 500, 560, 580]
    out = []
    for label, shape, window in SHAPES:
        for tick, qlens, q_start in (("full bucket", [64] * 8, starts),
                                     ("decode", [1] * 8, cs.NEAR600)):
            args, kw = cs.ragged_case(gen, dev, qlens=qlens, q_start=q_start,
                                      window=window, dtype=torch.float32,
                                      kv_dtype=torch.float32, **shape)
            out.append((f"ragged {label} {tick}", "ragged_attention",
                        lambda s, a=args, k=kw: ragged_mod.ragged_attention(
                            *a, **k, splits=s)))
        kp, vp, _, _, pt = cs.paged_pool(gen, dev, kv_dtype=torch.float32,
                                         R=8, P=41, bs=16, KV=shape["KV"],
                                         hd=shape["hd"])
        pos = torch.tensor(cs.NEAR600, dtype=torch.int32, device=dev)
        q = torch.randn(8, shape["KV"], shape["G"], shape["hd"],
                        generator=gen, device=dev)
        out.append((f"paged {label} decode", "paged_attention",
                    lambda s, q=q, kp=kp, vp=vp, pt=pt, pos=pos, w=window:
                    paged_mod.paged_attention(q, kp, vp, pt, pos, window=w,
                                              splits=s)))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_paged_splits: needs an NVIDIA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    flush = torch.empty(128 * 2 ** 20 // 4, device=dev)
    print(json.dumps({"card": cs.card_line()}), flush=True)
    for name, kind, fn in cases(dev):
        rec = {"case": name}
        for s in SPLITS:
            call = (lambda s=s: fn(s))
            rec[str(s)] = dict(kernel_ms=cs.kernel_ms(call, kind, flush),
                               event_ms=cs.time_ms(call, 20, flush),
                               back_to_back_ms=cs.device_ms(call))
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
