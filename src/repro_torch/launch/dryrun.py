"""Dry-run: trace every (architecture x input shape) on the production
meshes with no allocation, and account each step's per-device work (the
torch twin of the JAX package's ``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun \
        --arch musicgen-large --shape decode_32k [--multi-pod] [--out DIR]

The JAX dry-run lowers and compiles each step with XLA and reads the
compiled program's memory, cost and collectives.  The port compiles
nothing: a step is *traced* — run once over placed ``meta``-device
tensors of the per-device shapes (params by ``param_specs``, optimizer
state by ``opt.init`` of each device's slices, inputs and dense cache by
``shapes.input_specs``' specs) under a counting mode
(``kernels.counting.Count``), which records the step's matrix-product
FLOPs, the bytes its aten ops move, each hand-written kernel's work from
its shapes, and each collective the port writes out.  Nothing is
allocated.  The record:

* **FLOPs, bytes, wire bytes** (``launch.hlo``), **collectives by op**:
  the whole mesh's program runs on one host thread, so each is the
  mesh's total divided by the device count — the per-device mean;
* **kernel calls** by kernel: the mesh's totals (the launches the card
  would count);
* **memory**: argument bytes per device, exact from the specs (the
  largest device's placed params, optimizer state, inputs and cache);
  the peak estimate adds the count's high-water mark of live bytes
  (``Count.peak_live_bytes``: each tensor an op allocates, freed with
  its tensor) over the device count;
* the H100 roofline of those counts (``launch.roofline``).

Left out of the JAX module: ``corrected_costs`` (XLA counts a scan body
once whatever its trip count; the port loops over periods in Python, so
every period is counted) and ``donate`` (torch updates in place).  A
pair the port cannot place is listed with its error, as JAX's
``--keep-going`` lists failures: a model axis of 16 that
``sharding.check_model_axis`` refuses (gemma3-1b, phi4-mini-3.8b,
starcoder2-7b, rwkv6-3b, granite-moe-3b-a800m).  ``long_500k``'s batch
of 1, which the data axes do not divide, splits the cache's sequence
over them (``shapes.input_pspecs``): its trace runs the sequence-split
decode, one merge an attention layer a group of devices that split the
keys (``launch.mesh.lse_merge``) among its collectives.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Optional

import torch

from repro_torch.configs import ASSIGNED, get_config, long_context_variant
from repro_torch.kernels.counting import Count
from repro_torch.launch import hlo as hlo_lib
from repro_torch.launch import roofline as roofline_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import (axis_sizes, make_production_mesh,
                                     num_chips)
from repro_torch.launch.shapes import (SHAPES, global_inputs, input_pspecs,
                                       input_specs)
from repro_torch.models import params as params_lib
from repro_torch.models.cache import cache_shapes
from repro_torch.models.params import tree_leaves, tree_map

NOTE = ("per-device FLOPs, bytes, wire bytes and collectives are the "
        "mesh's totals over its device count (one host thread traces the "
        "whole mesh); kernel calls are the mesh's totals")


def config_for(arch: str, shape_name: str):
    """Resolve the config (long_500k uses the documented sliding-window
    variant for full-attention archs; see DESIGN.md)."""
    cfg = get_config(arch)
    note = ""
    if shape_name == "long_500k" and not cfg.supports_long_natively:
        cfg = long_context_variant(cfg)
        note = f"sliding-window variant (w={cfg.long_variant_window})"
    return cfg, note


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def step_call(cfg, shape_name: str, mesh, params, inputs: dict,
              seq_over_model: bool = False):
    """``(step, args)``: the step of the shape's kind built over ``mesh``
    and its arguments, from global ``params`` and ``inputs`` (``tokens``
    (+ ``frontend_embeds``) to train or prefill; ``token``, ``pos`` and
    the dense ``cache`` to serve) placed by their specs: params by
    ``param_specs``, a train step's optimizer state by ``opt.init`` of
    each device's slices, the cache by ``input_pspecs``' (with
    ``seq_over_model``, which the serve step is built with too; the
    batch is split, or replicated, by the step itself)."""
    kind = SHAPES[shape_name].kind
    placed = steps_lib.place(params, params_lib.param_specs(cfg, mesh), mesh)
    if kind == "train":
        step, opt = steps_lib.make_train_step(cfg, mesh=mesh)
        state = [[opt.init(p) for p in row] for row in placed]
        return step, (placed, state, inputs)
    if kind == "prefill":
        return steps_lib.make_prefill_step(cfg, mesh=mesh), (placed, inputs)
    step = steps_lib.make_serve_step(cfg, mesh=mesh,
                                     seq_over_model=seq_over_model,
                                     seq_len=SHAPES[shape_name].seq_len)
    cache = steps_lib.place(inputs["cache"], input_pspecs(
        cfg, shape_name, mesh, seq_over_model)["cache"], mesh)
    return step, (placed, inputs["token"], inputs["pos"], cache)


def argument_bytes(args) -> int:
    """The largest device's bytes of a step's placed arguments (params,
    optimizer state, cache); the batch, which the step splits itself,
    is not among them."""
    grids = [a for a in args if isinstance(a, list)]
    E, M = len(grids[0]), len(grids[0][0])
    return max(sum(t.numel() * t.element_size()
                   for g in grids for t in tree_leaves(g[e][j]))
               for e in range(E) for j in range(M))


def _batch_bytes(cfg, shape_name: str, mesh, dtype) -> int:
    """One device's rows of the batch: ``input_specs`` but the cache, and
    but ``pos`` for an attention-free model, which never reads it (nor
    does the JAX program, which drops an argument it never reads)."""
    skip = {"cache", "pos"} if cfg.attn_free else {"cache"}
    return sum(t.numel() * t.element_size()
               for k, t in input_specs(cfg, shape_name, mesh,
                                       dtype).items() if k not in skip)


@dataclasses.dataclass
class Trace:
    """One traced step: its count, the mesh's device count, the largest
    device's argument bytes, the peak estimate per device and the
    trace's host seconds."""
    count: Count
    devices: int
    argument_bytes: int
    peak_bytes: float
    seconds: float


def run_counted(step, args, devices: int, arg_bytes: int) -> Trace:
    """``step(*args)`` once under a fresh count."""
    t0 = time.perf_counter()
    with Count() as count:
        step(*args)
    return Trace(count, devices, arg_bytes,
                 arg_bytes + count.peak_live_bytes / devices,
                 time.perf_counter() - t0)


def trace_cfg(cfg, shape_name: str, mesh, dtype=torch.bfloat16,
              seq_over_model: bool = False) -> Trace:
    """Trace one step of ``cfg`` at ``shape_name`` on ``mesh`` (the
    counterpart of JAX's ``lower_cfg``): per-device ``meta`` params,
    optimizer state, inputs and cache (``seq_over_model`` as
    :func:`step_call` takes it), the step of the shape's kind run once
    under the counting mode."""
    s = SHAPES[shape_name]
    params = tree_map(lambda p: _meta(p.shape, dtype),
                      params_lib.declare_model(cfg))
    inputs = {k: _meta(shp, dt) for k, (shp, dt)
              in global_inputs(cfg, shape_name, dtype).items()}
    if s.kind == "decode":
        inputs["cache"] = cache_shapes(cfg, s.global_batch, s.seq_len,
                                       dtype=dtype)
    step, args = step_call(cfg, shape_name, mesh, params, inputs,
                           seq_over_model)
    nbytes = argument_bytes(args) + _batch_bytes(cfg, shape_name, mesh,
                                                 dtype)
    return run_counted(step, args, num_chips(mesh), nbytes)


def record(arch: str, shape_name: str, mesh_name: str, cfg, trace: Trace,
           note: str = "") -> roofline_lib.Roofline:
    """The roofline record of a trace (``launch.roofline.analyze``): its
    counts per device."""
    shape = SHAPES[shape_name]
    c, n = trace.count, trace.devices
    return roofline_lib.analyze(
        arch=arch, shape=shape_name, mesh_name=mesh_name, chips=n,
        cost={"flops": {k: v / n for k, v in c.flops.items()},
              "bytes accessed": c.bytes / n},
        collectives=hlo_lib.collective_stats(c.collectives, n),
        model_flops=roofline_lib.model_flops_for(cfg, shape, shape.kind),
        memory={"argument_bytes": trace.argument_bytes,
                "peak_bytes": trace.peak_bytes},
        note="; ".join(x for x in (note, NOTE) if x))


def run_pair(arch: str, shape_name: str, *, multi_pod: bool = False,
             out_dir: Optional[str] = None, verbose: bool = True):
    mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_name = "x".join(str(n) for n in axis_sizes(mesh).values())
    cfg, note = config_for(arch, shape_name)
    trace = trace_cfg(cfg, shape_name, mesh)
    rl = record(arch, shape_name, mesh_name, cfg, trace, note)
    kernels = {k: v["calls"] for k, v in trace.count.kernels.items()}
    if verbose:
        print(f"[{arch} x {shape_name} @ {mesh_name}] "
              f"trace {trace.seconds:.1f}s")
        print(f"  memory: arguments/device={trace.argument_bytes:.4e} B "
              f"peak estimate/device={trace.peak_bytes:.4e} B")
        print(f"  cost: flops/chip={rl.flops_per_chip:.3e} "
              f"bytes/chip={rl.bytes_per_chip:.3e} kernels={kernels}")
        print(f"  collectives: {rl.collective_detail['count_by_op']} "
              f"wire_bytes/chip={rl.wire_bytes_per_chip:.3e}")
        print(f"  roofline (H100 SXM, 700 W): "
              f"compute={rl.t_compute * 1e3:.2f}ms "
              f"memory={rl.t_memory * 1e3:.2f}ms "
              f"collective={rl.t_collective * 1e3:.2f}ms "
              f"-> {rl.bottleneck}-bound "
              f"(useful-flops {rl.useful_flops_ratio:.2f})")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        rec = dataclasses.asdict(rl)
        rec["trace_s"] = trace.seconds
        rec["kernel_calls"] = kernels
        rec["flops_by_rate"] = {k: v / trace.devices
                                for k, v in trace.count.flops.items()}
        path = os.path.join(out_dir,
                            f"{arch}__{shape_name}__{mesh_name}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
    return rl


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all",
                    help="architecture id or 'all'")
    ap.add_argument("--shape", default="all",
                    help="input shape name or 'all'")
    ap.add_argument("--multi-pod", action="store_true",
                    help="use the (2,16,16) 512-device mesh")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch",
                    help="JSON output dir")
    ap.add_argument("--keep-going", action="store_true")
    ap.add_argument("--resume", action="store_true",
                    help="skip pairs whose JSON already exists in --out")
    args = ap.parse_args()

    archs = ASSIGNED if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    failures = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                mesh_name = "2x16x16" if mp else "16x16"
                if args.resume and os.path.exists(os.path.join(
                        args.out, f"{arch}__{shape}__{mesh_name}.json")):
                    print(f"skip [{arch} x {shape} @ {mesh_name}] (exists)")
                    continue
                try:
                    run_pair(arch, shape, multi_pod=mp, out_dir=args.out)
                except Exception as e:  # noqa: BLE001
                    failures.append((arch, shape, mp, repr(e)))
                    print(f"FAIL [{arch} x {shape} multi_pod={mp}]: {e}")
                    if not args.keep_going:
                        traceback.print_exc()
                        raise SystemExit(1)
    if failures:
        print(f"\n{len(failures)} failures:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print("\nAll dry-runs passed.")


if __name__ == "__main__":
    main()
