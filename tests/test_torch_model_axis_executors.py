"""The model axis of a tier mesh under every executor and tier family in
the torch port, on the CPU, against the JAX package.

* The blocks at m = 2, smoke widths: the JAX function on the port's
  weights (as numpy) against the port's two model shards
  (``model_shard_params``) summed by ``all_reduce`` or gathered, at atol =
  rtol = 1e-5: ``rwkv6`` over each shard's heads (its ``w0``, ``bonus``
  and ``ln_x`` narrowed) and ``rwkv_cmix`` (the value product
  all-reduced, each shard's gate columns gathered) in prefill and decode,
  state included; ``mamba`` over each shard's channels (``in_proj``'s
  columns of both halves, the ``x_proj`` product all-reduced between
  ``mamba_in`` and ``mamba_out``) in prefill and decode, conv and ssm
  caches included; ``_embed`` with a frontend (qwen2-vl-72b and
  musicgen-large: each shard's ``frontend_proj`` rows, all-reduced).
* Layouts the axis cannot split raise ValueError naming the shapes; a
  MoE draft tier is refused on ``1x2``.
* The port's engine on meshes of the CPU device repeated against the JAX
  engine on the same meshes over 8 host devices (one subprocess for the
  module): gemma3-1b -> phi4-mini-3.8b under uniform prefill on ``1x2``
  and ``2x2``, the dense arena and speculation (k = 2) on ``1x2``;
  gemma3-1b -> rwkv6-3b and -> qwen2-vl-72b on ``1x2``, -> jamba-v0.1-52b
  (Mamba + MoE at capacity factor 0.5, the data axis's joint route) on
  ``2x2``; ``shard_params`` in four of the seven.  The same tokens and
  final tiers (δ mid-way in the widest gap of the unsharded port's
  tier-0 confidences, 1.0 for jamba), sequence confidences within 1e-5,
  the same drafts launch by launch, each pool's per-device shapes the
  JAX arrays' shard shapes.
* Launches (the wrappers counting through their plain versions): the
  attention kernels, the scans and ``moe_route`` M times the same data
  axis without the model axis, the gate as many, host syncs equal, and
  both by the engine's formula.

Torch runs on one intra-op thread, as in ``tests/test_torch_model_axis.py``.
"""
import dataclasses
import json
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

from repro.models import blocks as jax_blocks  # noqa: E402
from repro.models import transformer as jax_transformer  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.models import blocks, init_params, sharding  # noqa: E402
from repro_torch.models import cache as cache_lib  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.params import tree_map  # noqa: E402
from repro_torch.serving import CascadeEngine, TierSpec  # noqa: E402
from repro_torch.serving import engine as engine_mod  # noqa: E402
from repro_torch.serving.engine import VirtualClock  # noqa: E402
from tests.test_torch_data_axis import (  # noqa: E402
    COUNTED, PLAIN, WORK, _layers, _recorded, smoke)
from tests.test_torch_model import configs_of  # noqa: E402
from tests.test_torch_model_axis import _flat, _shards  # noqa: E402
from tests.torch_one_thread import one_torch_thread  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAST, EXP, MOE = "gemma3-1b", "phi4-mini-3.8b", "granite-moe-3b-a800m"
RWKV, JAMBA, QWEN = "rwkv6-3b", "jamba-v0.1-52b", "qwen2-vl-72b"
MUSIC = "musicgen-large"
CPU = torch.device("cpu")
M = 2
BLOCK_TOL = dict(atol=1e-5, rtol=1e-5)
CONF_ATOL = 1e-5
N_REQ = 10
KW = dict(slots=8, prompt_len=16, gen_len=4, prefill_chunk=8)


# ---------------------------------------------------------------------------
# the blocks at m = 2 against the JAX functions
# ---------------------------------------------------------------------------


def _jnp(tree):
    return tree_map(lambda t: jnp.asarray(t.numpy() if torch.is_tensor(t)
                                          else t), tree)


def _layer(tree, part):
    """Period 0, layer 0's ``part`` (``mixer`` or ``ffn``) of a tree."""
    return tree_map(lambda a: a[0], tree["period"]["block0"][part])


def _recurrent(name, part, seed):
    """(JAX config, port config, the layer's whole weights, each model
    shard's) of ``name``'s smoke period 0 layer 0."""
    jcfg, cfg = configs_of(name)
    tp = init_params(cfg, seed, device="cpu")
    return jcfg, cfg, _layer(tp, part), [_layer(s, part)
                                         for s in _shards(tp, cfg)]


def _x(seed, shape):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)


def test_rwkv6_shards_match_jax():
    """The RWKV-6 time mix over each shard's 4 of the 8 smoke heads
    (``wr``/``wk``/``wv``/``wg``/``wB`` columns, ``w0``, ``bonus``,
    ``ln_x`` narrowed, ``wo`` rows): the partials all-reduce to the JAX
    block's output in prefill (T = 20) and then one decode step; each
    shard's state is its heads of the JAX state, at the shape its pool
    declares, and its ``x_prev`` the whole token."""
    jcfg, cfg, full, ps = _recurrent(RWKV, "mixer", 5)
    spec, scfg = cfg.period[0].mixer, sharding.shard_config(cfg, M)
    assert ps[0]["bonus"].shape == (4, spec.head_dim)
    assert ps[0]["w0"].shape == ps[0]["ln_x"].shape == (128,)
    x = _x(6, (2, 20, cfg.d_model))
    want, want_c = jax_blocks.rwkv6(_jnp(full), jcfg, spec, jnp.asarray(
        x.numpy()), None, None, "prefill")
    outs = [blocks.rwkv6(p, scfg, spec, x, None, None, "prefill")
            for p in ps]
    _close(mesh_lib.all_reduce([y for y, _ in outs])[0], want)
    decl = cache_lib.declare_cache(scfg, 2, 1)["period"]["block0"]["mixer"]
    for j, (_, c) in enumerate(outs):
        assert tuple(c["state"].shape) == decl["state"].shape[1:]
        _close(c["state"], np.asarray(want_c["state"])[:, 4 * j:4 * j + 4])
        _close(c["x_prev"], want_c["x_prev"])
    x1 = x[:, :1] * 0.5
    want1, want_c1 = jax_blocks.rwkv6(_jnp(full), jcfg, spec, jnp.asarray(
        x1.numpy()), want_c, None, "decode")
    outs1 = [blocks.rwkv6(p, scfg, spec, x1, c, None, "decode")
             for p, (_, c) in zip(ps, outs)]
    _close(mesh_lib.all_reduce([y for y, _ in outs1])[0], want1)
    _close(torch.cat([c["state"] for _, c in outs1], 1), want_c1["state"])


def test_rwkv_cmix_shards_match_jax():
    """The RWKV-6 channel mix on two model shards (key columns and value
    rows on ``ffn``, receptance columns on ``d_inner``): the value
    products all-reduced and each shard's gate columns times its columns
    of the sum, gathered, equal the JAX channel mix in prefill and
    decode; each shard writes its own ``x_prev``."""
    jcfg, cfg, full, ps = _recurrent(RWKV, "ffn", 7)
    spec = cfg.period[0].ffn
    assert ps[0]["wv"].shape[0] == spec.d_ff // M
    assert ps[0]["wr"].shape[1] == cfg.d_model // M
    group = sharding.ModelShards([CPU] * M)
    x = _x(8, (2, 9, cfg.d_model))
    want, want_c, _ = jax_blocks.dense_ffn(_jnp(full), jcfg, spec,
                                           jnp.asarray(x.numpy()), None,
                                           "prefill")
    got, caches = transformer._cmix_shards(group, [{"ffn": p} for p in ps],
                                           cfg, spec, [x] * M, None,
                                           "prefill")
    for g, c in zip(got, caches):
        _close(g, want)
        _close(c["x_prev"], want_c["x_prev"])
    gate, kv, _ = blocks.rwkv_cmix_parts(ps[1], cfg, spec, x, None,
                                         "prefill")
    assert gate.shape[-1] == cfg.d_model // M
    assert kv.shape[-1] == cfg.d_model
    x1 = x[:, :1] * 0.5
    want1, want_c1, _ = jax_blocks.dense_ffn(_jnp(full), jcfg, spec,
                                             jnp.asarray(x1.numpy()), want_c,
                                             "decode")
    got1, caches1 = transformer._cmix_shards(
        group, [{"ffn": p} for p in ps], cfg, spec, [x1] * M,
        [{"ffn": c} for c in caches], "decode")
    for g, c in zip(got1, caches1):
        _close(g, want1)
        _close(c["x_prev"], want_c1["x_prev"])


def test_mamba_shards_match_jax():
    """The Mamba mixer over each shard's 256 of the 512 smoke channels:
    ``in_proj`` a ``[d, 2, 256]`` view of the shard's columns of both the
    ``x`` and ``z`` halves, ``mamba_in``'s ``x_proj`` partials
    all-reduced before ``mamba_out`` slices ``dt``, ``B`` and ``C``, the
    ``out_proj`` partials all-reduced: the JAX mixer's output in prefill
    (T = 12) and one decode step, the conv and ssm caches each shard's
    channels of the JAX caches.  Without the ``x_proj`` all-reduce the
    output is wrong."""
    jcfg, cfg, full, ps = _recurrent(JAMBA, "mixer", 9)
    spec, scfg = cfg.period[0].mixer, sharding.shard_config(cfg, M)
    d_in = spec.expand * cfg.d_model
    n = d_in // M
    assert ps[1]["in_proj"].shape == (cfg.d_model, 2, n)
    np.testing.assert_array_equal(
        ps[1]["in_proj"][:, 1].numpy(),
        full["in_proj"][:, d_in + n:].numpy())
    x = _x(10, (2, 12, cfg.d_model))

    def shards(x, caches, mode, reduce=True):
        firsts = [blocks.mamba_in(p, scfg, spec, x, c, mode)
                  for p, c in zip(ps, caches)]
        projs = (mesh_lib.all_reduce([f[2] for f in firsts]) if reduce
                 else [f[2] for f in firsts])
        outs = [blocks.mamba_out(p, scfg, spec, f, pr, c, mode)
                for p, f, pr, c in zip(ps, firsts, projs, caches)]
        return mesh_lib.all_reduce([y for y, _ in outs])[0], \
            [c for _, c in outs]
    want, want_c = jax_blocks.mamba(_jnp(full), jcfg, spec,
                                    jnp.asarray(x.numpy()), None, None,
                                    "prefill")
    got, caches = shards(x, [None] * M, "prefill")
    _close(got, want)
    decl = cache_lib.declare_cache(scfg, 2, 1)["period"]["block0"]["mixer"]
    for j, c in enumerate(caches):
        assert tuple(c["conv"].shape) == decl["conv"].shape[1:]
        assert tuple(c["ssm"].shape) == decl["ssm"].shape[1:]
        _close(c["conv"], np.asarray(want_c["conv"])[..., j * n:(j + 1) * n])
        _close(c["ssm"], np.asarray(want_c["ssm"])[:, j * n:(j + 1) * n])
    wrong, _ = shards(x, [None] * M, "prefill", reduce=False)
    assert np.abs(wrong.numpy() - np.asarray(want)).max() > 1e-3
    x1 = x[:, :1] * 0.5
    want1, want_c1 = jax_blocks.mamba(_jnp(full), jcfg, spec,
                                      jnp.asarray(x1.numpy()), want_c, None,
                                      "decode")
    got1, caches1 = shards(x1, caches, "decode")
    _close(got1, want1)
    _close(torch.cat([c["conv"] for c in caches1], -1), want_c1["conv"])
    _close(torch.cat([c["ssm"] for c in caches1], 1), want_c1["ssm"])


@pytest.mark.parametrize("name", [QWEN, MUSIC])
def test_frontend_embed_shards_match_jax(name):
    """A frontend model's prefill embedding on two model shards: each
    shard projects its 32 of the 64 ``frontend_embeds`` columns through
    its ``frontend_proj`` rows, the partials all-reduced, over the first
    ``frontend_len`` positions, and the vocabulary-parallel token
    embedding past them; decode embeds tokens only."""
    jcfg, cfg = configs_of(name)
    tp = init_params(cfg, 2, device="cpu")
    ps = _shards(tp, cfg)
    assert ps[0]["frontend_proj"].shape == (cfg.frontend_dim // M,
                                            cfg.d_model)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (2, 13)).astype(np.int32)
    fe = rng.standard_normal((2, cfg.frontend_len, cfg.frontend_dim)).astype(
        np.float32)
    group = sharding.ModelShards([CPU] * M)
    for mode in ("prefill", "decode"):
        want = jax_transformer._embed(
            _jnp(tp), jcfg, {"tokens": jnp.asarray(toks),
                             "frontend_embeds": jnp.asarray(fe)}, mode)
        got = transformer._embed_shards(group, ps, cfg,
                                        torch.from_numpy(toks), mode,
                                        torch.from_numpy(fe))
        for g in got:
            _close(g, want)


# ---------------------------------------------------------------------------
# layouts the axis cannot split, and the draft tier it still refuses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,m,change,words", [
    (RWKV, 3, {}, "cuts the RWKV-6 heads: 8 heads of 32 (d_model 256)"),
    (JAMBA, 3, {}, "does not divide the Mamba d_inner of 512 channels"),
    (QWEN, 2, {"frontend_dim": 65},
     "does not divide the vision frontend's 65 frontend_proj rows")])
def test_indivisible_layouts_raise(name, m, change, words):
    """A model axis that cuts an RWKV-6 head (8 smoke heads over 3
    shards), does not divide Mamba's ``d_inner`` (512 channels over 3) or
    a frontend's rows (65 over 2) raises ValueError naming the shapes,
    when the tier is declared, even where the spec would leave the leaf
    whole."""
    cfg = dataclasses.replace(configs_of(name)[1], **change)
    mesh = mesh_lib.make_tier_mesh(1, m, [CPU] * m)
    with pytest.raises(ValueError) as err:
        TierSpec("exp", cfg, None, mesh=mesh)
    assert str(err.value).startswith(f"{cfg.name}: a model axis of {m} ")
    assert words in str(err.value)


# ---------------------------------------------------------------------------
# the engine against the JAX engine on 8 host devices
# ---------------------------------------------------------------------------

SPEC = {"speculation_k": 2, "spec_delta": 0.0, "flat_buckets": [64]}
# case -> (expensive tier, mesh of both tiers, shard_params, workload, δ:
# "mid" or fixed, engine switches)
CASES = {
    "uniform-1x2": (EXP, (1, M), True, "uniform", "mid",
                    {"use_chunked_prefill": False}),
    "uniform-2x2": (EXP, (2, M), False, "uniform", "mid",
                    {"use_chunked_prefill": False}),
    "dense-1x2": (EXP, (1, M), True, "uniform", "mid",
                  {"use_paged_kv": False}),
    "speculation-1x2": (EXP, (1, M), False, "lognormal", "mid", SPEC),
    "rwkv6-1x2": (RWKV, (1, M), True, "uniform", "mid", {}),
    "jamba-2x2": (JAMBA, (2, M), True, "uniform", 1.0, {}),
    "qwen2-vl-1x2": (QWEN, (1, M), False, "uniform", "mid", {}),
}


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Each model's smoke weights from the port's ``init_params`` (the
    fast tier seed 0, the others seed 1; jamba's MoE layers at capacity
    factor 0.5), and the same trees as numpy in a pickle for the JAX
    subprocess."""
    names = (FAST, EXP, RWKV, JAMBA, QWEN, MOE)
    cfgs = {n: smoke(n) for n in names}
    tp = {n: init_params(cfgs[n], int(n != FAST), device="cpu")
          for n in names}
    path = tmp_path_factory.mktemp("model_axis_executors") / "weights.pkl"
    with open(path, "wb") as f:
        pickle.dump({n: tree_map(lambda t: t.numpy(), p)
                     for n, p in tp.items() if n != MOE}, f)
    return cfgs, tp, str(path)


def _engine(weights, fast, exp, shape, delta, shard_params=False, **kw):
    cfgs, tp, _ = weights
    meshes = ([None, None] if shape is None else mesh_lib.make_tier_meshes(
        [shape] * 2, [CPU] * (2 * shape[0] * shape[1])))
    eng = CascadeEngine(
        [TierSpec("fast", cfgs[fast], tp[fast], mesh=meshes[0],
                  shard_params=shard_params),
         TierSpec("exp", cfgs[exp], tp[exp], mesh=meshes[1],
                  shard_params=shard_params)],
        deltas=[delta], clock=VirtualClock(), device="cpu", **{**KW, **kw})
    eng.warmup()
    return eng


def _drain(eng, work):
    for p in WORK[work]:
        eng.submit(np.asarray(p, np.int32), arrival_time=0.0)
    eng.run(max_steps=3000)
    return [(r.rid, list(map(int, r.tokens)), r.tier,
             list(r.seq_conf_by_tier)) for r in eng.requests]


def test_moe_draft_tier_refused_on_model_shards(weights):
    """granite-moe-3b-a800m drafting on ``1x2``: a MoE draft tier stays
    refused on every mesh (the draft loop's masked rows would route and
    take expert capacity)."""
    with pytest.raises(ValueError, match="have MoE layers"):
        _engine(weights, MOE, EXP, (1, M), 1.0, **SPEC)


@pytest.fixture(scope="module")
def deltas(weights):
    """Each case's δ: a fixed one, or mid-way in the widest gap of the
    unsharded port's tier-0 sequence confidences (one run a workload,
    at δ 0)."""
    out, seen = {}, {}
    for case, (exp, _, _, work, delta, kw) in CASES.items():
        if delta != "mid":
            out[case] = delta
            continue
        if work not in seen:
            confs = sorted(r[3][0] for r in _drain(
                _engine(weights, FAST, EXP, None, 0.0,
                        use_chunked_prefill=work == "lognormal"), work))
            _, i = max((confs[i + 1] - confs[i], i)
                       for i in range(len(confs) - 1))
            seen[work] = 0.5 * (confs[i] + confs[i + 1])
        out[case] = seen[work]
    return out


_JAX_ENGINES = """
    import dataclasses, json, pickle, sys
    import numpy as np, jax
    from repro.configs import get_config
    from repro.serving import CascadeEngine, TierSpec
    from repro.serving.engine import VirtualClock
    from repro.launch.mesh import make_tier_meshes

    assert jax.device_count() == 8, jax.device_count()
    weights = pickle.load(open(sys.argv[1], "rb"))
    scen, cf, moe = json.loads(sys.argv[2])

    def smoke(name):
        cfg = get_config(name, "smoke")
        if name not in moe:
            return cfg
        return dataclasses.replace(cfg, **{sec: tuple(
            dataclasses.replace(l, ffn=dataclasses.replace(
                l.ffn, capacity_factor=cf)) if l.ffn.kind == "moe" else l
            for l in getattr(cfg, sec)) for sec in ("head", "period", "tail")})

    def path(p):
        return "/".join(str(k.key) for k in p)

    def recorded(run, drafts):
        def spec(*a):
            out = run(*a)
            dl, tok = np.asarray(a[4]), np.asarray(out[5])
            drafts.append([[int(r), tok[r, :dl[r]].tolist()]
                           for r in np.flatnonzero(dl)])
            return out
        return spec

    cfgs = {n: smoke(n) for n in weights}
    out = {}
    for name, (fast, exp, shape, shard_params, prompts, delta, kw) in \\
            scen.items():
        meshes = make_tier_meshes([tuple(shape)] * 2)
        eng = CascadeEngine(
            [TierSpec("fast", cfgs[fast], weights[fast], mesh=meshes[0],
                      shard_params=shard_params),
             TierSpec("exp", cfgs[exp], weights[exp], mesh=meshes[1],
                      shard_params=shard_params)],
            deltas=[delta], clock=VirtualClock(), **kw)
        eng.warmup()
        drafts = []
        for rt in eng.runtimes:
            if rt.spec_draft:
                rt.run_spec = recorded(rt.run_spec, drafts)
        for p in prompts:
            eng.submit(np.asarray(p, np.int32), arrival_time=0.0)
        eng.run(max_steps=3000)
        out[name] = {
            "streams": [[r.rid, list(map(int, r.tokens)), r.tier,
                         list(map(float, r.seq_conf_by_tier))]
                        for r in eng.requests],
            "drafts": drafts,
            "memory": eng.memory_stats(),
            "shard_shapes": [{path(p): list(a.sharding.shard_shape(a.shape))
                              for p, a in jax.tree_util.
                              tree_leaves_with_path(rt.pool.cache)}
                             for rt in eng.runtimes]}
    print("RESULT " + json.dumps(out, default=float))
"""


@pytest.fixture(autouse=True, scope="module")
def _jax_process(weights, deltas):
    """The JAX engines' subprocess, started with the module's first test
    so that it runs beside the block tests; :func:`jax_engines` waits
    for it."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    scen = {case: [FAST, exp, list(shape), sp,
                   [list(map(int, p)) for p in WORK[work]], deltas[case],
                   {**KW, **kw}]
            for case, (exp, shape, sp, work, _, kw) in CASES.items()}
    proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_JAX_ENGINES), weights[2],
         json.dumps([scen, 0.5, [JAMBA]])], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)
    yield proc
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def jax_engines(_jax_process):
    out, err = _jax_process.communicate(timeout=600)
    assert _jax_process.returncode == 0, f"STDOUT:\n{out}\nSTDERR:\n{err}"
    line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):])


@pytest.fixture(scope="module")
def port_runs(weights, deltas):
    """Each case's run of the port on its mesh and on the same data axis
    without the model axis, once for the module, through the plain
    versions with the wrappers counting after warmup: ``run(case)``
    gives one (engine, streams, launch counts, the number of data shards
    holding an admitted row in each uniform prefill launch by tier, the
    draft tier's drafts) for each, the model axis's first."""
    done = {}

    def one(case, shape, shard_params):
        exp, _, _, work, _, kw = CASES[case]
        prefills, drafts = [[], []], []
        prefill = engine_mod._TierRuntime.run_prefill

        def recorded(rt, slot_ids, prompts):
            prefills[rt.spec.name == "exp"].append(
                len({s // rt.rows[0].stop for s in slot_ids}))
            return prefill(rt, slot_ids, prompts)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(ops, "_on_cpu", lambda t, name: False)
            for mod, fn in PLAIN:
                mp.setattr(mod, fn, getattr(mod, f"{fn}_ref"))
            mp.setattr(engine_mod._TierRuntime, "run_prefill", recorded)
            eng = _engine(weights, FAST, exp, shape, deltas[case],
                          shard_params, **kw)
            for rt in eng.runtimes:
                if rt.spec_draft:
                    rt.run_spec = _recorded(rt.run_spec, drafts)
            for name in COUNTED:
                getattr(ops, name).launches = 0
            prefills[0].clear()
            prefills[1].clear()
            streams = _drain(eng, work)
            counts = {n: getattr(ops, n).launches for n in COUNTED}
        return eng, streams, counts, prefills, drafts

    def run(case):
        if case not in done:
            _, shape, sp, _, _, _ = CASES[case]
            done[case] = (one(case, shape, sp),
                          one(case, None if shape[0] == 1 else (shape[0], 1),
                              False))
        return done[case]
    return run


def _formula(cfgs, eng, kinds, prefills, steps) -> dict:
    """The launches of a run over ``D x M`` tiers by the engine's
    docstring: each attention kernel D·M times a tier launch (a uniform
    prefill's ``flash_attention`` and scans M times a shard holding an
    admitted row, a draft step M times a layer), ``moe_route`` M times a
    MoE layer a tier launch, the gate D times a tier launch (once a
    shard holding an admitted row, once a draft step)."""
    want = dict.fromkeys(COUNTED, 0)
    for t, (cfg, k) in enumerate(zip(cfgs, kinds)):
        rt = eng.runtimes[t]
        D, m = rt.data_shards, rt.model_shards
        attn = _layers(cfg, "attn")
        routed = 0
        for kind, n in k.items():
            if kind in ("ragged", "spec"):
                want["ragged_attention"] += D * m * attn * n
            elif kind in ("mixed", "chunk"):
                want["mixed_attention"] += D * m * attn * n
            elif kind == "step" and rt.paged:
                want["paged_attention"] += D * m * attn * n
            if kind != "prefill":
                want["confidence_gate"] += D * n
                routed += n
        shards = sum(prefills[t])
        assert len(prefills[t]) == k.get("prefill", 0)
        want["flash_attention"] += m * attn * shards
        want["rwkv6_scan"] += m * _layers(cfg, "rwkv6") * shards
        want["mamba_scan"] += m * _layers(cfg, "mamba") * shards
        want["confidence_gate"] += shards + steps[t]
        want["paged_attention"] += m * attn * steps[t]
        routed += k.get("prefill", 0)
        want["router_gate"] += m * _layers(cfg, "moe") * routed
    return want


@pytest.mark.parametrize("case", sorted(CASES))
def test_model_axis_executor_launches(weights, port_runs, case):
    """The model axis multiplies each attention kernel, scan and
    ``moe_route`` by M and leaves the gate and the host syncs as the
    same data axis without it (unsharded for ``1x2``) has them, with the
    same streams; both runs' counts follow the engine's formula."""
    cfgs = weights[0]
    (eng, got, counts, prefills, _), (beng, bgot, base, bpre, _) = \
        port_runs(case)
    assert [r[:3] for r in got] == [r[:3] for r in bgot]
    assert eng.host_syncs == beng.host_syncs
    for n in COUNTED:
        assert counts[n] == base[n] * (1 if n == "confidence_gate" else M), \
            (n, counts, base)
    tiers = [cfgs[FAST], cfgs[CASES[case][0]]]
    for e, c, pre in ((eng, counts, prefills), (beng, base, bpre)):
        s = e.metrics.summary()
        assert c == _formula(tiers, e, s["launches_by_kind"], pre,
                             s["speculation"]["draft_steps_by_tier"])
    assert any(counts[n] for n in ("flash_attention", "rwkv6_scan",
                                   "mamba_scan", "ragged_attention"))
    assert [rt.model_shards for rt in eng.runtimes] == [M, M]


@pytest.mark.parametrize("case", sorted(CASES))
def test_model_axis_executor_matches_jax(weights, deltas, port_runs,
                                         jax_engines, case):
    """The port on its mesh serves the JAX engine's streams on the same
    mesh: the same tokens and final tiers, sequence confidences within
    1e-5, the same drafts launch by launch, the same ``memory_stats``
    keys with the KV bytes of one device (a model shard's KV heads of the
    JAX package's logical bytes), and the per-device cache leaves the
    shapes of the JAX arrays' shards: the dense arena's KV rows, the
    RWKV-6 state over each shard's heads, Mamba's conv and ssm state over
    its channels, all over the data shards' rows (gemma3's one KV head
    whole in each shard, where the JAX dense arena splits its width)."""
    cfgs = weights[0]
    (eng, got, _, _, drafts), _ = port_runs(case)
    want = jax_engines[case]
    assert [list(r[:3]) for r in got] == [r[:3] for r in want["streams"]]
    for g, w in zip(got, want["streams"]):
        np.testing.assert_allclose(g[3], w[3], rtol=0, atol=CONF_ATOL)
    assert drafts == want["drafts"]
    assert {r[2] for r in got} == ({1} if deltas[case] == 1.0 else {0, 1})
    s = eng.metrics.summary()
    assert s["completed"] == N_REQ and s["conservation"]["ok"]
    for rt, g, w, shapes in zip(eng.runtimes, eng.memory_stats(),
                                want["memory"], want["shard_shapes"]):
        cfg = cfgs[CASES[case][0] if rt.spec.name == "exp" else FAST]
        split = cfg.num_kv_heads // sharding.shard_config(cfg, M).num_kv_heads
        key = "kv_bytes_per_block" if rt.paged else "kv_arena_bytes"
        assert set(g) == set(w)
        assert g[key] * split == w[key]
        paged = ({k for k, meta in _flat(rt.pool._meta).items()
                  if meta.kind == "paged"} if rt.paged else set())
        for trees in rt.pool.caches:
            assert len(trees) == M
            for tree in trees:
                for k, v in _flat(tree).items():
                    want_shape = list(shapes.get(k, ()))
                    if k in paged or k.endswith("x_prev"):
                        # the block pool's own layout; the token shift,
                        # whole on every shard here, which GSPMD may
                        # leave split over the model devices
                        continue
                    if cfg.num_kv_heads % M and k.split("/")[-1] in "kv":
                        # gemma3's one KV head: whole in each shard's tree
                        # (kv_head_range), where the JAX dense arena
                        # splits its width
                        want_shape[-1] *= M
                    assert list(v.shape) == want_shape, k
        if rt.paged:
            assert not rt.pool.bound_rows()
