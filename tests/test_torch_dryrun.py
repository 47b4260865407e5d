"""The dry-run and roofline tooling of the torch port, on the CPU, against
the JAX package.

* One JAX subprocess on 8 host devices (the test process never imports
  ``repro.launch.dryrun``, which forces 512 devices at import), started
  with the module's first test so that it runs beside the port's:
  - ``input_specs``' per-device shapes and dtypes on ``make_test_mesh(8)``
    (train, prefill, decode, and a batch-1 decode that takes
    ``shard_seq``) for gemma3-1b, rwkv6-3b, granite-moe-3b-a800m and
    qwen2-vl-72b (frontend) at smoke widths, at tiny ``InputShape``s,
    and on a ``(2, 2, 2)`` ``("pod", "data", "model")`` mesh for one
    config: exact;
  - ``cache_shapes``' per-device shapes for all ten smoke configs ×
    ``shard_seq`` × ``seq_over_model``: exact (``cache_specs`` in
    process, on stub meshes);
  - ``compiled.memory_analysis().argument_size_in_bytes`` of
    ``tests/test_dryrun_small.py``'s three pairs in f32 against the
    dry-run's argument bytes per device: exact;
  - the jitted prefill and serve steps under ``set_mesh`` on ``2x1`` and
    ``1x2`` (phi4-mini-3.8b also ``2x2``) for phi4-mini-3.8b, granite,
    rwkv6-3b and jamba at smoke widths, against
    ``make_prefill_step(mesh=)`` / ``make_serve_step(mesh=)`` on placed
    ``init_params`` weights: last logits, ``conf`` and each device's
    cache within atol = rtol = 1e-5.
* In process: ``model_flops_for`` for the ten configs × four ``SHAPES``,
  ``CollectiveStats.total_wire_bytes`` and the ``Roofline`` field names
  against the JAX package's; ``flat_work_layout`` against JAX's at two
  tile sizes.
* The port alone: the trace on ``meta`` devices equals the same step run
  on a mesh of 8 CPU devices, count for count (FLOPs by rate, bytes,
  kernel calls, collectives), for the three pairs; each ``ops`` wrapper
  on the CPU under a count records exactly its ``*_work`` and no aten
  FLOPs of its plain version, and returns its kernel's shapes on
  ``meta``; a dense smoke forward's FLOPs equal a hand count of its
  products; on a ``(2, 2, 2)`` pod mesh of CPU devices the train,
  prefill and serve steps equal the unsharded ones; the CLI lists a
  refused production pair and exits 1.

Torch runs on one intra-op thread.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels import ragged_attention as jax_ragged  # noqa: E402
from repro.launch import hlo as jax_hlo  # noqa: E402
from repro.launch import roofline as jax_roofline  # noqa: E402
from repro.launch import shapes as jax_shapes  # noqa: E402
from repro.models import cache as jax_cache  # noqa: E402
from repro_torch.configs import ASSIGNED, get_config  # noqa: E402
from repro_torch.kernels import confidence_gate as gate_mod  # noqa: E402
from repro_torch.kernels import counting, ops  # noqa: E402
from repro_torch.kernels import flash_attention as flash_mod  # noqa: E402
from repro_torch.kernels import mamba_scan as mamba_mod  # noqa: E402
from repro_torch.kernels import mixed_attention as mixed_mod  # noqa: E402
from repro_torch.kernels import paged_attention as paged_mod  # noqa: E402
from repro_torch.kernels import ragged_attention as ragged_mod  # noqa: E402
from repro_torch.kernels import router_gate as router_mod  # noqa: E402
from repro_torch.kernels import rwkv6_scan as rwkv_mod  # noqa: E402
from repro_torch.launch import dryrun, hlo, roofline, shapes  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import cache as cache_lib  # noqa: E402
from repro_torch.models import init_params, params, sharding  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.params import tree_leaves, tree_map  # noqa: E402
from tests.test_torch_model_axis import _flat  # noqa: E402
from tests.torch_one_thread import one_torch_thread  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_dryrun_small.py's pairs: (shape whose kind the tiny shape
# takes, arch)
SMALL_PAIRS = (("train_4k", "gemma3-1b"), ("decode_32k", "rwkv6-3b"),
               ("prefill_32k", "granite-moe-3b-a800m"))
SPEC_ARCHS = ("gemma3-1b", "rwkv6-3b", "granite-moe-3b-a800m",
              "qwen2-vl-72b")
# tiny shapes of each kind (tests/test_dryrun_small.py's 64 x 8), and a
# batch-1 decode whose cache the data axis splits by sequence
TINY = {"tiny_train": (64, 8, "train"), "tiny_prefill": (64, 8, "prefill"),
        "tiny_decode": (64, 8, "decode"), "tiny_long": (64, 1, "decode")}
POD = ((2, 2, 2), ("pod", "data", "model"))
CACHE = (8, 64)                   # batch, seq of the cache-shape cases
# the serving-step cases: model -> meshes
STEP_MODELS = {"phi4-mini-3.8b": ((2, 1), (1, 2), (2, 2)),
               "granite-moe-3b-a800m": ((2, 1), (1, 2)),
               "rwkv6-3b": ((2, 1), (1, 2)),
               "jamba-v0.1-52b": ((2, 1), (1, 2))}
B, S, T = 4, 16, 24               # rows, prompt length, dense cache length
STEP_TOL = dict(atol=1e-5, rtol=1e-5)
# rwkv6-3b against JAX: JAX's own 2x1 program sits 1.5e-5 from the port
# on 3 of 2048 prefill logits and 2.0e-5 on 8 of 16384 RWKV-6 state
# values, while the port's 2x1 outputs equal its unsharded ones bit for
# bit (8.2e-6 from JAX's unsharded logits); rwkv6-3b's sharded train
# parity (tests/test_torch_sharded_train.py) takes 1e-4 likewise
JAX_TOL = {"rwkv6-3b": dict(atol=1e-4, rtol=1e-4)}
# the sharded steps against the port's unsharded ones (f32 sums in
# another order where model shards all-reduce: 3.7e-6 at most)
SELF_TOL = dict(atol=1e-5, rtol=1e-5)


def _register_tiny(module):
    for name, (seq, batch, kind) in TINY.items():
        module.SHAPES[name] = module.InputShape(name, seq, batch, kind)


def _inputs():
    """Each serving case's numpy inputs: prompt tokens [B, S], the
    decode's token and pos [B, 1] and a random dense cache of T
    positions (the port's declaration, f32)."""
    out = {}
    for i, name in enumerate(STEP_MODELS):
        rng = np.random.default_rng(i)
        cfg = get_config(name, "smoke")
        cache = tree_map(
            lambda c: (rng.standard_normal(c.shape) * 0.5).astype(np.float32),
            cache_lib.declare_cache(cfg, B, T))
        out[name] = {
            "tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "token": rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32),
            "pos": rng.integers(S, T, (B, 1)).astype(np.int32),
            "cache": cache}
    return out


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Each serving case's smoke weights (the port's ``init_params``,
    seed its place in ``STEP_MODELS``) and inputs, and the subprocess's
    pickle of them."""
    tp = {m: init_params(get_config(m, "smoke"), i, device="cpu")
          for i, m in enumerate(STEP_MODELS)}
    ins = _inputs()
    path = tmp_path_factory.mktemp("dryrun")
    with open(path / "in.pkl", "wb") as f:
        pickle.dump({"weights": {m: tree_map(lambda t: t.numpy(), p)
                                 for m, p in tp.items()},
                     "inputs": ins, "models": STEP_MODELS,
                     "cache_len": T}, f)
    return tp, ins, str(path)


_JAX = """
    import pickle, sys
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec
    from repro.configs import ASSIGNED, get_config
    from repro.data import shard_batch
    from repro.launch import shapes as shp
    from repro.launch import steps as steps_lib
    from repro.launch.mesh import make_test_mesh
    from repro.models import cache as cache_lib
    from repro.models import params as params_lib
    from repro.models import sharding as sharding_lib

    assert jax.device_count() == 8, jax.device_count()
    inp = pickle.load(open(sys.argv[1] + "/in.pkl", "rb"))
    for name, (seq, batch, kind) in TINY.items():
        shp.SHAPES[name] = shp.InputShape(name, seq, batch, kind)

    def local(tree):
        return [(jax.tree_util.keystr(k), tuple(v.sharding.shard_shape(
            v.shape)), str(v.dtype))
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]]

    out = {"specs": {}, "cache": {}, "args": {}, "steps": {}}
    mesh = make_test_mesh(8)
    pod = Mesh(np.array(jax.devices()).reshape(POD[0]), POD[1])
    for arch in SPEC_ARCHS:
        cfg = get_config(arch, "smoke")
        for name in TINY:
            out["specs"][arch, name, "2x4"] = local(
                shp.input_specs(cfg, name, mesh, dtype=jnp.float32))
            if arch == SPEC_ARCHS[0]:
                out["specs"][arch, name, "2x2x2"] = local(
                    shp.input_specs(cfg, name, pod, dtype=jnp.float32))
    for arch in ASSIGNED:
        cfg = get_config(arch, "smoke")
        for seq in (False, True):
            for som in (False, True):
                out["cache"][arch, seq, som] = local(cache_lib.cache_shapes(
                    cfg, CACHE[0], CACHE[1], mesh=mesh, dtype=jnp.float32,
                    shard_seq=seq, seq_over_model=som))
    # tests/test_dryrun_small.py's lowering, f32
    for shape_name, arch in SMALL_PAIRS:
        cfg = get_config(arch, "smoke")
        kind = shp.SHAPES[shape_name].kind
        shp.SHAPES["tiny"] = shp.InputShape("tiny", 64, 8, kind)
        pshapes = params_lib.param_shapes(cfg, dtype=jnp.float32, mesh=mesh)
        inputs = shp.input_specs(cfg, "tiny", mesh, dtype=jnp.float32)
        with sharding_lib.set_mesh(mesh):
            if kind == "train":
                step, opt = steps_lib.make_train_step(cfg)
                osh = steps_lib.opt_state_shapes(opt, cfg, mesh)
                lowered = jax.jit(step).lower(pshapes, osh, inputs)
            elif kind == "prefill":
                lowered = jax.jit(steps_lib.make_prefill_step(cfg)).lower(
                    pshapes, inputs)
            else:
                lowered = jax.jit(steps_lib.make_serve_step(cfg)).lower(
                    pshapes, inputs["token"], inputs["pos"], inputs["cache"])
        out["args"][arch] = int(
            lowered.compile().memory_analysis().argument_size_in_bytes)

    def put(tree, specs, mesh):
        return jax.tree.map(lambda a, s: jax.device_put(
            jnp.asarray(a), NamedSharding(mesh, s)), tree, specs)

    for arch, meshes in inp["models"].items():
        cfg = get_config(arch, "smoke")
        x = inp["inputs"][arch]
        prefill = jax.jit(steps_lib.make_prefill_step(cfg))
        serve = jax.jit(steps_lib.make_serve_step(cfg))
        for d, m in meshes:
            mesh = Mesh(np.array(jax.devices()[:d * m]).reshape(d, m),
                        ("data", "model"))
            p = put(inp["weights"][arch], params_lib.param_specs(cfg, mesh),
                    mesh)
            cache = put(x["cache"], cache_lib.cache_specs(
                cfg, x["token"].shape[0], inp["cache_len"], mesh), mesh)
            with sharding_lib.set_mesh(mesh):
                lg, pc = prefill(p, shard_batch({"tokens": x["tokens"]},
                                                mesh))
                b = shard_batch({"token": x["token"], "pos": x["pos"]}, mesh)
                slg, conf, sc = serve(p, b["token"], b["pos"], cache)
            out["steps"][arch, d, m] = jax.tree.map(np.asarray, {
                "prefill_logits": lg, "prefill_cache": pc,
                "logits": slg, "conf": conf, "cache": sc})
    pickle.dump(out, open(sys.argv[1] + "/out.pkl", "wb"))
"""


@pytest.fixture(autouse=True, scope="module")
def _jax_process(weights):
    """The JAX subprocess, started with the module's first test so that
    it runs beside the port's; :func:`jax_out` waits for it."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    code = textwrap.dedent(_JAX)
    for k in ("TINY", "POD", "SPEC_ARCHS", "CACHE", "SMALL_PAIRS"):
        code = code.replace(k, repr(globals()[k]))
    proc = subprocess.Popen([sys.executable, "-c", code, weights[2]],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)
    yield proc
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def jax_out(_jax_process, weights):
    out, err = _jax_process.communicate(timeout=600)
    assert _jax_process.returncode == 0, f"STDOUT:\n{out}\nSTDERR:\n{err}"
    with open(os.path.join(weights[2], "out.pkl"), "rb") as f:
        return pickle.load(f)


def test_roofline_helpers_match_jax():
    """``model_flops_for`` for the ten configs × four ``SHAPES``, the
    ring factors of ``CollectiveStats.total_wire_bytes`` and the
    ``Roofline`` record's fields equal the JAX package's."""
    for arch in ASSIGNED:
        for name, shp in shapes.SHAPES.items():
            if name not in jax_shapes.SHAPES or name.startswith("tiny"):
                continue
            assert roofline.model_flops_for(
                get_config(arch), shp, shp.kind) == \
                jax_roofline.model_flops_for(jax_get_config(arch),
                                             jax_shapes.SHAPES[name],
                                             shp.kind), (arch, name)
    by_op = {"all-reduce": 1234.0, "all-gather": 56.0, "all-to-all": 7.0,
             "reduce-scatter": 8.0, "collective-permute": 9.0}
    assert hlo.CollectiveStats(dict(by_op)).total_wire_bytes == \
        jax_hlo.CollectiveStats(dict(by_op)).total_wire_bytes
    assert hlo.CollectiveStats(dict(by_op)).total_raw_bytes == \
        jax_hlo.CollectiveStats(dict(by_op)).total_raw_bytes
    assert [f.name for f in dataclasses.fields(roofline.Roofline)] == \
        [f.name for f in dataclasses.fields(jax_roofline.Roofline)]
    # the per-device mean of a mesh's events
    st = hlo.collective_stats([("all-reduce", 800, 4), ("all-gather", 40, 1),
                               ("all-reduce", 800, 4)], devices=4)
    assert st.bytes_by_op == {"all-reduce": 400.0, "all-gather": 10.0}
    assert st.count_by_op == {"all-reduce": 2.0, "all-gather": 0.25}


@pytest.mark.parametrize("tile", [16, 64])
def test_flat_work_layout_matches_jax(tile):
    """``flat_work_layout`` equals JAX's array by array for random
    ``q_len`` (zeros included)."""
    rng = np.random.default_rng(tile)
    for _ in range(16):
        # few (rows, tiles) shapes: JAX compiles each op once a shape
        b, nt = int(rng.choice([1, 5, 8])), int(rng.choice([1, 4, 8]))
        q_len = rng.integers(0, 2 * tile + 1, b).astype(np.int32)
        q_len[rng.random(b) < 0.3] = 0
        while q_len.sum() > nt * tile:
            q_len[rng.integers(b)] = 0
        got = ragged_mod.flat_work_layout(torch.from_numpy(q_len), nt, tile)
        want = jax_ragged.flat_work_layout(jnp.asarray(q_len), nt, tile)
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _counts(c: counting.Count) -> dict:
    """What a count must give alike on every device (its op histogram
    may not: a host upload is ``lift_fresh`` on the CPU, a copy
    elsewhere)."""
    return {"flops": dict(c.flops), "bytes": c.bytes,
            "kernels": {k: dict(v) for k, v in c.kernels.items()},
            "collectives": sorted(c.collectives)}


def _cpu_args(cfg, shape_name, mesh):
    """The arguments of ``dryrun.step_call`` with real CPU tensors: the
    port's smoke weights, random tokens, zero optimizer state and a
    random cache."""
    s = shapes.SHAPES[shape_name]
    gen = torch.Generator().manual_seed(0)
    p = init_params(cfg, 0, device="cpu")
    inputs = {k: (torch.randint(0, cfg.vocab_size, shp, generator=gen,
                                dtype=torch.int32) if k == "tokens" or
                  k == "token" else torch.randint(
                      0, s.seq_len, shp, generator=gen, dtype=torch.int32)
                  if k == "pos" else torch.randn(shp, generator=gen))
              for k, (shp, _) in shapes.global_inputs(
                  cfg, shape_name, torch.float32).items()}
    if s.kind == "decode":
        inputs["cache"] = tree_map(
            lambda c: torch.randn(c.shape, generator=gen),
            cache_lib.declare_cache(cfg, s.global_batch, s.seq_len))
    return dryrun.step_call(cfg, shape_name, mesh, p, inputs)


@pytest.mark.parametrize("shape_name,arch", SMALL_PAIRS)
def test_meta_trace_equals_cpu_run(shape_name, arch):
    """The dry-run's trace on 8 ``meta`` devices and the same step run
    on a mesh of 8 CPU devices (real weights, the kernels' plain
    versions) count alike: FLOPs by rate, bytes, kernel calls and their
    work, collectives."""
    shapes.SHAPES["tiny"] = shapes.InputShape(
        "tiny", 64, 8, shapes.SHAPES[shape_name].kind)
    cfg = get_config(arch, "smoke")
    meta = dryrun.trace_cfg(cfg, "tiny", mesh_lib.make_test_mesh(8),
                            dtype=torch.float32)
    mesh = mesh_lib.make_test_mesh(8, over=["cpu"] * 8)
    step, args = _cpu_args(cfg, "tiny", mesh)
    cpu = dryrun.run_counted(step, args, 8, 0)
    assert _counts(cpu.count) == _counts(meta.count)
    assert meta.count.total_flops > 0 and meta.count.collectives
    if arch == "granite-moe-3b-a800m":
        assert meta.count.kernels["router_gate"]["calls"] == 8


def _wrapper_cases():
    """(name, wrapper, its kernel's counter name, work function, args,
    kwargs) of every ``ops`` wrapper at small shapes on the CPU."""
    g = torch.Generator().manual_seed(3)

    def rn(*shape):
        return torch.randn(*shape, generator=g)
    N, bs, KV, G, hd, R, P = 9, 4, 2, 2, 32, 2, 4
    kp, vp = rn(N, bs, KV, hd), rn(N, bs, KV, hd)
    pt = torch.arange(1, 9, dtype=torch.int32).reshape(R, P)
    qs = torch.tensor([3, 0], dtype=torch.int32)
    ql = torch.tensor([2, 3], dtype=torch.int32)
    pos = torch.tensor([5, 9], dtype=torch.int32)
    w = torch.sigmoid(rn(1, 2, 6, 32))
    return [
        ("confidence_gate", ops.confidence_gate, "confidence_gate",
         gate_mod.confidence_gate_work, (rn(3, 50),), {}),
        ("router_gate", ops.router_gate, "router_gate",
         router_mod.router_gate_work, (rn(6, 8), 2), {}),
        ("moe_route", ops.moe_route, "router_gate", router_mod.moe_route_work,
         (rn(2, 6, 8), 2, 3), {}),
        ("ragged_attention", ops.ragged_attention, "ragged_attention",
         ragged_mod.ragged_attention_work, (rn(8, KV, G, hd), kp, vp, pt, qs,
                                            ql), {"window": 4}),
        ("paged_attention", ops.paged_attention, "paged_attention",
         paged_mod.paged_attention_work, (rn(R, KV, G, hd), kp, vp, pt, pos),
         {}),
        ("mixed_attention", ops.mixed_attention, "mixed_attention",
         mixed_mod.mixed_attention_work, (rn(R, 3, KV, G, hd), kp, vp, pt, qs,
                                          ql), {}),
        ("paged_prefill_attention", ops.paged_prefill_attention,
         "mixed_attention", mixed_mod.mixed_attention_work,
         (rn(R, 3, KV, G, hd), kp, vp, pt, qs, ql), {}),
        ("flash_attention", ops.flash_attention, "flash_attention",
         flash_mod.flash_attention_work, (rn(1, 4, 6, hd), rn(1, 2, 6, hd),
                                          rn(1, 2, 6, hd)), {"window": 3}),
        ("rwkv6_scan", ops.rwkv6_scan, "rwkv6_scan", rwkv_mod.rwkv6_scan_work,
         (rn(1, 2, 6, 32), rn(1, 2, 6, 32), rn(1, 2, 6, 32), w, rn(2, 32)),
         {}),
        ("mamba_scan", ops.mamba_scan, "mamba_scan", mamba_mod.mamba_scan_work,
         (rn(1, 5, 16), torch.rand(1, 5, 16, generator=g), rn(1, 5, 8),
          rn(1, 5, 8), -torch.rand(16, 8, generator=g)), {}),
    ]


def _shapes_of(out):
    return [(tuple(t.shape), t.dtype) for t in tree_leaves(
        out if not isinstance(out, dict) else [out[k] for k in sorted(out)])]


@pytest.mark.parametrize("case", [c[0] for c in _wrapper_cases()])
def test_wrapper_counts_its_work(case):
    """Each ``ops`` wrapper under a count, on the CPU: one call of its
    kernel with exactly its ``*_work`` (the plain version's aten ops not
    counted), and the same count on ``meta``, where it returns empty
    outputs of the plain version's shapes and dtypes without running
    it."""
    name, fn, kernel, work, args, kw = next(
        c for c in _wrapper_cases() if c[0] == case)
    nbytes, flops, kind = work(*args, **kw)
    with counting.Count() as cpu:
        out = fn(*args, **kw)
    assert cpu.kernels == {kernel: {"calls": 1, "bytes": nbytes,
                                    "flops": flops}}
    assert dict(cpu.flops) == {kind: flops} and cpu.bytes == nbytes
    assert not cpu.ops and not cpu.collectives
    meta_args = tree_map(lambda t: t.to("meta") if isinstance(
        t, torch.Tensor) else t, list(args))
    with counting.Count() as meta:
        got = fn(*meta_args, **kw)
    assert _counts(meta) == _counts(cpu) and not meta.ops
    assert _shapes_of(got) == _shapes_of(out)
    assert all(t.is_meta for t in tree_leaves(
        got if not isinstance(got, dict) else list(got.values())))


def test_dense_forward_flops_match_hand_count():
    """A dense smoke forward's counted FLOPs (phi4-mini-3.8b, train mode,
    f32) equal a hand count of its products: per layer the q, k, v and
    o projections, the scores and the weighted values of causal
    attention materialised over all S keys, the gated FFN's three
    products; the LM head; no kernel."""
    cfg = get_config("phi4-mini-3.8b", "smoke")
    b, s = 2, 8
    p = params.param_shapes(cfg, dtype=torch.float32)
    toks = torch.zeros(b, s, dtype=torch.int32, device="meta")
    with counting.Count() as c:
        transformer.forward(p, cfg, {"tokens": toks}, mode="train")
    d, H, KV, hd, V = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                       cfg.head_dim, cfg.vocab_size)
    n = b * s
    per_layer = 0
    for layer in cfg.layers:
        f = layer.ffn.d_ff
        per_layer += 2 * n * d * (H + 2 * KV) * hd + 2 * n * H * hd * d
        per_layer += 2 * 2 * b * H * s * s * hd
        per_layer += 2 * n * d * f * (3 if layer.ffn.act == "swiglu" else 2)
    want = per_layer + 2 * n * d * V
    assert dict(c.flops) == {"f32": want}
    assert not c.kernels


def _pod_mesh(over):
    grid = np.empty(8, dtype=object)
    grid[:] = [torch.device(over)] * 8
    return mesh_lib.TierMesh(grid.reshape(POD[0]), POD[1])


def test_pod_mesh_steps_match_unsharded():
    """On a ``(2, 2, 2)`` ``("pod", "data", "model")`` mesh of CPU
    devices (``pod × data`` data shards, fsdp leaves split over ``data``
    and replicated over ``pod``): a granite train step (fsdp on, every
    MoE layer routed over the global batch) and phi4's prefill and serve
    steps equal the unsharded ones — loss, gathered params and
    Adafactor state, logits and the decode's cache."""
    pod = _pod_mesh("cpu")
    sizes = mesh_lib.axis_sizes(pod)
    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m", "smoke"),
                              fsdp=True)
    p = init_params(cfg, 0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (8, 32)).astype(np.int32))
    step, opt = steps.make_train_step(cfg, lr=1e-2)
    want_p, want_s, want_m = step(p, opt.init(p), {"tokens": toks})
    specs = params.param_specs(cfg, pod)
    assert any("data" in s for s in mesh_lib.leaf_specs(p, specs))
    placed = steps.place(p, specs, pod)
    got_p, got_s, got_m = steps.make_train_step(cfg, lr=1e-2, mesh=pod)[0](
        placed, [[opt.init(x) for x in row] for row in placed],
        {"tokens": toks})
    torch.testing.assert_close(got_m["loss"], want_m["loss"], **SELF_TOL)
    for got, want, sp in ((got_p, want_p, specs),
                          (got_s, want_s,
                           steps.opt_state_specs(opt.name, cfg, pod))):
        for g, w in zip(tree_leaves(steps.gather(got, sp, sizes=sizes)),
                        tree_leaves(want)):
            torch.testing.assert_close(g, w, **SELF_TOL)
    cfg = get_config("phi4-mini-3.8b", "smoke")
    p = init_params(cfg, 1, device="cpu")
    placed = steps.place(p, params.param_specs(cfg, pod), pod)
    batch = {"tokens": toks % cfg.vocab_size}
    torch.testing.assert_close(
        steps.make_prefill_step(cfg, mesh=pod)(placed, batch)[0],
        steps.make_prefill_step(cfg)(p, batch)[0], **SELF_TOL)
    cache = tree_map(lambda c: torch.randn(c.shape),
                     cache_lib.declare_cache(cfg, 8, T))
    cspecs = cache_lib.cache_specs(cfg, 8, T, pod)
    token, pos = toks[:, :1] % cfg.vocab_size, torch.full((8, 1), S)
    placed_cache = tree_map(lambda t: t.clone(),
                            steps.place(cache, cspecs, pod))
    got = steps.make_serve_step(cfg, mesh=pod, seq_len=T)(placed, token, pos,
                                                          placed_cache)
    want = steps.make_serve_step(cfg)(p, token, pos, cache)
    torch.testing.assert_close(got[0], want[0], **SELF_TOL)
    for g, w in zip(tree_leaves(steps.gather(got[2], cspecs, sizes=sizes)),
                    tree_leaves(want[2])):
        torch.testing.assert_close(g, w, **SELF_TOL)


def test_cli_lists_refused_pairs(capsys, monkeypatch):
    """``--keep-going`` lists a pair ``check_model_axis`` refuses on the
    production mesh (gemma3-1b's one KV head and 4 query heads over a
    model axis of 16) and exits 1, as the JAX ``main`` does."""
    monkeypatch.setattr(sys, "argv", [
        "dryrun", "--arch", "gemma3-1b", "--shape", "train_4k",
        "--keep-going", "--out", "unused"])
    with pytest.raises(SystemExit) as exc:
        dryrun.main()
    assert exc.value.code == 1
    out = capsys.readouterr().out
    assert "1 failures:" in out and "model axis of 16" in out
    assert not os.path.exists("unused")


# ---- against the JAX subprocess (last: it runs beside the tests above) ----


def _local(tree) -> list:
    """A tree of meta tensors as ``(path, shape, dtype)`` rows in the
    JAX key order (sorted dict keys)."""
    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                yield from walk(t[k], f"{path}['{k}']")
        else:
            yield path, tuple(t.shape), str(t.dtype).replace("torch.", "")
    return list(walk(tree, ""))


def _tiny_shapes():
    _register_tiny(shapes)
    _register_tiny(jax_shapes)


def test_input_specs_match_jax(jax_out):
    """``input_specs``' per-device shapes and dtypes on ``2x4`` (and one
    config on ``2x2x2``) equal JAX's, for train, prefill, decode and the
    sequence-split batch-1 decode."""
    _tiny_shapes()
    mesh = mesh_lib.make_test_mesh(8)
    pod = _pod_mesh("meta")
    for arch in SPEC_ARCHS:
        cfg = get_config(arch, "smoke")
        for name in TINY:
            got = _local(shapes.input_specs(cfg, name, mesh,
                                            dtype=torch.float32))
            assert got == jax_out["specs"][arch, name, "2x4"], (arch, name)
            if arch == SPEC_ARCHS[0]:
                got = _local(shapes.input_specs(cfg, name, pod,
                                                dtype=torch.float32))
                assert got == jax_out["specs"][arch, name, "2x2x2"], name


@pytest.mark.parametrize("arch", ASSIGNED)
def test_cache_specs_and_shapes_match_jax(arch, jax_out):
    """``cache_specs`` (stub meshes ``2x4`` and ``1x8``) and
    ``cache_shapes`` (``2x4``) equal JAX's for every ``shard_seq`` ×
    ``seq_over_model``."""
    from tests.test_torch_model_axis import StubMesh
    cfg, jcfg = get_config(arch, "smoke"), jax_get_config(arch, "smoke")
    mesh = mesh_lib.make_test_mesh(8)
    for seq in (False, True):
        for som in (False, True):
            kw = dict(shard_seq=seq, seq_over_model=som)
            for stub in ((2, 4), (1, 8), (4, 2)):
                got = _flat(cache_lib.cache_specs(cfg, *CACHE, StubMesh(stub),
                                                  **kw))
                want = _flat(jax_cache.cache_specs(jcfg, *CACHE,
                                                   StubMesh(stub), **kw))
                assert got == {k: tuple(v) for k, v in want.items()}, \
                    (stub, kw)
            got = _local(cache_lib.cache_shapes(cfg, *CACHE, mesh=mesh,
                                                dtype=torch.float32, **kw))
            assert got == jax_out["cache"][arch, seq, som], kw


@pytest.mark.parametrize("shape_name,arch", SMALL_PAIRS)
def test_argument_bytes_match_jax(shape_name, arch, jax_out):
    """The dry-run's argument bytes per device equal the compiled JAX
    program's ``argument_size_in_bytes`` (tests/test_dryrun_small.py's
    pairs, f32, on ``2x4``)."""
    shapes.SHAPES["tiny"] = shapes.InputShape(
        "tiny", 64, 8, shapes.SHAPES[shape_name].kind)
    tr = dryrun.trace_cfg(get_config(arch, "smoke"), "tiny",
                          mesh_lib.make_test_mesh(8), dtype=torch.float32)
    assert tr.argument_bytes == jax_out["args"][arch]


def _cpu_mesh(d, m):
    return mesh_lib.make_tier_mesh(d, m, ["cpu"] * (d * m))


def _device_view(a, axes, cfg, e, j, E, M):
    """Device ``(e, j)``'s part of a global cache leaf ``a`` (numpy) by
    the shard rules: its rows of ``batch``, its KV heads
    (``kv_head_range``), its equal part of ``heads`` / ``d_inner``."""
    for dim, ax in enumerate(axes):
        if ax == "batch":
            n = a.shape[dim] // E
            a = np.take(a, range(e * n, (e + 1) * n), dim)
        elif ax == "kv_heads" and M > 1:
            first, count = sharding.kv_head_range(cfg, j, M)
            a = np.take(a, range(first, first + count), dim)
        elif ax in ("heads", "d_inner") and M > 1:
            n = a.shape[dim] // M
            a = np.take(a, range(j * n, (j + 1) * n), dim)
    return a


def _at(tree, path: str):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _check_cache(got_grid, want, cfg, seq, what, tol, view=None):
    """Each device's cache (``got_grid[e][j]``, through ``view(tree, j,
    M)`` where given) against its part of the JAX cache ``want``."""
    decl = _flat(cache_lib.declare_cache(cfg, B, seq))
    E, M = len(got_grid), len(got_grid[0])
    for e in range(E):
        for j in range(M):
            got = got_grid[e][j] if view is None else view(
                got_grid[e][j], cfg, j, M)
            for path, c in decl.items():
                np.testing.assert_allclose(
                    _at(got, path).numpy(),
                    _device_view(np.asarray(_at(want, path)), c.axes, cfg, e,
                                 j, E, M),
                    err_msg=f"{what} device ({e}, {j}) {path}", **tol)


@pytest.mark.parametrize("arch,mesh", [(a, m) for a, ms in STEP_MODELS.items()
                                       for m in ms])
def test_sharded_serving_steps_match_jax(arch, mesh, weights, jax_out):
    """``make_prefill_step(mesh=)`` and ``make_serve_step(mesh=)`` on
    placed weights against JAX's jitted steps under ``set_mesh`` on the
    same mesh (last logits, ``conf`` and each device's cache), and
    against the port's unsharded steps."""
    cfg = get_config(arch, "smoke")
    x, want = weights[1][arch], jax_out["steps"][(arch,) + mesh]
    tp = weights[0][arch]
    tmesh = _cpu_mesh(*mesh)
    placed = steps.place(tp, params.param_specs(cfg, tmesh), tmesh)
    batch = {"tokens": torch.from_numpy(x["tokens"])}
    tol = JAX_TOL.get(arch, STEP_TOL)
    lg, pc = steps.make_prefill_step(cfg, mesh=tmesh)(placed, batch)
    np.testing.assert_allclose(lg.numpy(), want["prefill_logits"], **tol)
    torch.testing.assert_close(
        lg, steps.make_prefill_step(cfg)(tp, batch)[0], **SELF_TOL)
    _check_cache(pc, want["prefill_cache"], cfg, S, "prefill", tol)
    host = tree_map(torch.from_numpy, x["cache"])
    cache = tree_map(lambda t: t.clone(), steps.place(
        host, cache_lib.cache_specs(cfg, B, T, tmesh), tmesh))
    token, pos = torch.from_numpy(x["token"]), torch.from_numpy(x["pos"])
    slg, conf, sc = steps.make_serve_step(cfg, mesh=tmesh, seq_len=T)(
        placed, token, pos, cache)
    np.testing.assert_allclose(slg.numpy(), want["logits"], **tol)
    np.testing.assert_allclose(conf.numpy(), want["conf"], **tol)
    one = steps.make_serve_step(cfg)(tp, token, pos,
                                     tree_map(lambda t: t.clone(), host))
    torch.testing.assert_close(slg, one[0], **SELF_TOL)
    torch.testing.assert_close(conf, one[1], **SELF_TOL)
    assert sc is cache
    _check_cache(sc, want["cache"], cfg, T, "serve", tol, steps._shard_cache)

