"""Tensor parallelism over a tier mesh's ``model`` axis in the torch port,
on the CPU, against the JAX package.

* ``param_specs`` (``logical_to_spec``) and ``paged_cache_specs`` equal
  the JAX package's for all ten configs at their published widths, on
  ``1x2``, ``2x2``, ``1x4`` and ``1x8`` meshes, fsdp on and off (stub
  meshes carrying ``axis_names`` and ``devices.shape``: no devices);
  ``param_shapes`` gives each leaf's per-device shape on the meta device,
  and the KV-head rule agrees with the cache specs.
* At m = 2, smoke widths, the JAX function on the same ``from_jax``
  weights against the port's model shards summed by ``all_reduce`` (or
  gathered by ``all_gather``): ``blocks.attention`` in ``ragged_step``
  mode (gemma3-1b's one KV head, replicated in both shards, and
  phi4-mini-3.8b's split ones; each shard's pool holds its KV heads of
  the JAX pool), ``dense_ffn``, ``moe_ffn`` (expert-parallel, and ``ffn``
  split inside the experts when the axis does not divide them),
  ``_embed`` and ``_logits`` (granite-moe-3b-a800m's indivisible 49155-id
  vocabulary runs once), and whole ragged and decode steps of the MoE
  granite-moe-3b-a800m.  Tolerance atol = rtol = 1e-5 on the blocks and
  1e-4 on whole steps: only the order of f32 sums differs.
* The port's engine on ``1x2`` and ``2x2`` meshes over the CPU device
  repeated, ``shard_params`` on and off, under the ragged, padded and
  split executors, against the JAX engine on 8 host devices with the
  same meshes (ragged; one subprocess for the module): the same tokens
  and final tiers at a δ mid-way in the widest gap of the tier-0
  confidences, sequence confidences within atol 1e-5, equal
  ``mesh_topology`` and ``memory_stats`` keys.
* Launches: the attention kernels and ``moe_route`` exactly M times the
  unsharded engine's, the confidence gate as many, and ``host_syncs``
  equal (the wrappers counting through their plain versions).

Torch runs on one intra-op thread, as in ``tests/test_torch_multidevice.py``.
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

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import blocks as jax_blocks  # noqa: E402
from repro.models import cache as jax_cache  # noqa: E402
from repro.models import params as jax_params  # noqa: E402
from repro.models import transformer as jax_transformer  # noqa: E402
from repro_torch.configs import ASSIGNED, get_config  # noqa: E402
from repro_torch.kernels import confidence_gate as gate_mod  # noqa: E402
from repro_torch.kernels import mixed_attention as mixed_mod  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as paged_mod  # noqa: E402
from repro_torch.kernels import prefill_attention as prefill_mod  # noqa: E402
from repro_torch.kernels import ragged_attention as ragged_mod  # noqa: E402
from repro_torch.kernels import router_gate as router_mod  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.models import blocks, cache as cache_lib  # noqa: E402
from repro_torch.models import init_params, params, sharding  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.params import tree_map  # noqa: E402
from repro_torch.serving import CascadeEngine, TierSpec  # noqa: E402
from repro_torch.serving.engine import VirtualClock  # noqa: E402
from repro_torch.serving.slots import TierSlotPool  # noqa: E402
from tests.test_torch_model import _plan, configs_of  # noqa: E402
from tests.torch_one_thread import one_torch_thread  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAST, EXP, MOE = "gemma3-1b", "phi4-mini-3.8b", "granite-moe-3b-a800m"
CPU = torch.device("cpu")
M = 2
MESHES = ((1, 2), (2, 2), (1, 4), (1, 8))
BLOCK_TOL = dict(atol=1e-5, rtol=1e-5)
STEP_TOL = dict(atol=1e-4, rtol=1e-4)
CONF_ATOL = 1e-5


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------


class StubMesh:
    """What the spec rules read of a mesh: axis names and the device
    grid's shape."""

    def __init__(self, shape):
        self.axis_names = ("data", "model")
        self.devices = np.empty(shape, dtype=object)


def _flat(tree, prefix=""):
    """A tree of dicts as {path: leaf} (a spec tuple is a leaf)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _jax_specs(tree, ndims):
    """JAX PartitionSpecs as tuples padded with None to each leaf's
    rank."""
    return {k: tuple(s) + (None,) * (ndims[k] - len(tuple(s)))
            for k, s in _flat(tree).items()}


@pytest.mark.parametrize("name", ASSIGNED)
def test_param_and_cache_specs_match_jax(name):
    """``param_specs`` and ``paged_cache_specs`` leaf for leaf as the JAX
    package's, on every mesh, fsdp on and off; ``param_shapes``' meta
    tensors are the per-device slices; the KV-head rule holds exactly the
    heads the cache spec leaves to each model shard."""
    for fsdp in (False, True):
        jcfg = dataclasses.replace(jax_get_config(name, ""), fsdp=fsdp)
        cfg = dataclasses.replace(get_config(name, ""), fsdp=fsdp)
        decl = _flat(params.declare_model(cfg))
        for shape in MESHES:
            mesh = StubMesh(shape)
            got = _flat(params.param_specs(cfg, mesh))
            want = _jax_specs(jax_params.param_specs(jcfg, mesh),
                              {k: len(p.shape) for k, p in decl.items()})
            assert got == want, (name, fsdp, shape)
            sizes = dict(zip(mesh.axis_names, shape))
            for k, t in _flat(params.param_shapes(cfg, mesh=mesh)).items():
                assert t.device.type == "meta"
                assert tuple(s * (sizes[a] if a else 1) for s, a in zip(
                    t.shape, got[k])) == decl[k].shape, k
            nb = 8 * shape[0] + 1 - (shape[0] == 1)
            cdecl = _flat(cache_lib.declare_paged_cache(cfg, 8, nb, 16))
            got_c = _flat(cache_lib.paged_cache_specs(cfg, 8, nb, 16, mesh))
            want_c = _jax_specs(
                jax_cache.paged_cache_specs(jcfg, 8, nb, 16, mesh),
                {k: len(c.shape) for k, c in cdecl.items()})
            assert got_c == want_c, (name, shape)
            m = shape[1]
            try:
                kvl = sharding.kv_heads_per_shard(cfg, m)
            except ValueError as err:
                assert f"{cfg.num_heads} query heads" in str(err)
                continue
            # the pool's KV heads a shard: the spec's share where it
            # splits them, else the one head the shard's queries read
            for k, spec in got_c.items():
                if k.endswith("/k"):
                    if "model" in spec:
                        assert kvl * m == cfg.num_kv_heads
                    else:
                        assert kvl == 1 and m % cfg.num_kv_heads == 0


# ---------------------------------------------------------------------------
# the blocks at m = 2 against the JAX functions
# ---------------------------------------------------------------------------


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _shards(tree, cfg, mesh_shape=(1, M)):
    """Each model shard's slices of a port parameter tree."""
    specs = params.param_specs(cfg, StubMesh(mesh_shape))
    m = mesh_shape[1]
    return [sharding.model_shard_params(tree, cfg, specs, j, m)
            for j in range(m)]


@pytest.fixture(scope="module")
def smoke_weights():
    """Smoke weights from the port's ``init_params`` and the same trees as
    numpy for the JAX package (whose keys are the port's), by model."""
    out = {}
    for i, name in enumerate((FAST, EXP, MOE)):
        jcfg, cfg = configs_of(name)
        tp = init_params(cfg, i, device="cpu")
        out[name] = (jcfg, cfg, tree_map(lambda t: t.numpy(), tp), tp)
    return out


@pytest.mark.parametrize("name", [FAST, EXP])
def test_attention_shards_match_jax(smoke_weights, name):
    """Each shard's ragged attention over its heads, its KV written into
    its own pool: the partials all-reduce to the JAX attention's output,
    and each pool holds its KV heads of the JAX pool (gemma3-1b's one KV
    head in both shards)."""
    jcfg, cfg, jp, tp = smoke_weights[name]
    rng = np.random.default_rng(5)
    R, P, bs = 4, 6, 4
    N, pt, q_len, q_start, _, pos = _plan(rng, cfg.vocab_size,
                                          [5, 0, 1, 7], R, P, bs)
    x = rng.standard_normal((1, pos.shape[1], cfg.d_model)).astype(
        np.float32)
    pool = jax.tree.map(np.asarray, jax_cache.init_paged_cache(
        jcfg, R, N, bs, jnp.float32))["period"]["block0"]["mixer"]
    pool = {k: rng.standard_normal(v[0].shape).astype(np.float32)
            for k, v in pool.items()}
    pages = {"page_table": pt, "q_len": q_len, "q_start": q_start}
    lp = jax.tree.map(lambda a: a[0], jp["period"]["block0"]["mixer"])
    want_y, want_c = jax_blocks.attention(
        _jnp(lp), jcfg, jcfg.period[0].mixer, jnp.asarray(x), _jnp(pool),
        jnp.asarray(pos), "ragged_step", pages=_jnp(pages))
    scfg = sharding.shard_config(cfg, M)
    heads = [slice(first, first + kvl) for first, kvl in (
        sharding.kv_head_range(cfg, j, M) for j in range(M))]
    parts, pools = [], []
    for j, shard in enumerate(_shards(tp, cfg)):
        lj = tree_map(lambda a: a[0], shard["period"])["block0"]["mixer"]
        pj = {k: torch.from_numpy(v[:, :, heads[j]].copy())
              for k, v in pool.items()}
        y, _ = blocks.attention(lj, scfg, cfg.period[0].mixer,
                                torch.from_numpy(x), pj,
                                torch.from_numpy(pos), "ragged_step",
                                pages={k: torch.from_numpy(v)
                                       for k, v in pages.items()})
        parts.append(y)
        pools.append(pj)
    got = mesh_lib.all_reduce(parts)
    total = int(q_len.sum())
    for g in got:
        np.testing.assert_allclose(g.numpy()[0, :total],
                                   np.asarray(want_y)[0, :total],
                                   **BLOCK_TOL)
    live = np.zeros(N, bool)
    live[pt[q_len > 0].ravel()] = True
    for j, pj in enumerate(pools):
        for k in pj:
            np.testing.assert_allclose(
                pj[k].numpy()[live],
                np.asarray(want_c[k])[live][:, :, heads[j]],
                **BLOCK_TOL)


@pytest.mark.parametrize("name", [EXP, "starcoder2-7b"])
def test_dense_ffn_shards_match_jax(name):
    """``wi``/``wi0``/``wi1`` column- and ``wo`` row-parallel on ``ffn``
    (swiglu, gelu): the partials all-reduce to the JAX FFN."""
    jcfg, cfg = configs_of(name)
    rng = np.random.default_rng(3)
    spec = cfg.period[0].ffn
    decl = params._dense_decl(cfg, spec)
    p = {k: (rng.standard_normal(d.shape) * 0.1).astype(np.float32)
         for k, d in decl.items()}
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    want = jax_blocks.dense_ffn(_jnp(p), jcfg, jcfg.period[0].ffn,
                                jnp.asarray(x), None, "ragged_step")[0]
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    specs = {k: params.logical_to_spec(d, StubMesh((1, M)), False)
             for k, d in decl.items()}
    parts = [blocks.dense_ffn(
        {k: mesh_lib.shard_leaf(v, specs[k], j, M) for k, v in tp.items()},
        cfg, spec, torch.from_numpy(x)) for j in range(M)]
    np.testing.assert_allclose(mesh_lib.all_reduce(parts)[0].numpy(),
                               np.asarray(want), **BLOCK_TOL)


@pytest.mark.parametrize("experts,cf", [(8, 1.0), (8, 2.0), (3, 1.0)])
def test_moe_ffn_shards_match_jax(experts, cf):
    """Expert-parallel (8 experts: each shard keeps the picks of its 4,
    one ``moe_route`` launch on its copy of the input, drops included at
    capacity factor 1) and, for 3 experts the axis does not divide,
    ``ffn`` split inside every expert: the partials all-reduce to the JAX
    MoE FFN."""
    jcfg, cfg = configs_of(MOE)
    jspec = dataclasses.replace(jcfg.period[0].ffn, num_experts=experts,
                                capacity_factor=cf)
    spec = dataclasses.replace(cfg.period[0].ffn, num_experts=experts,
                               capacity_factor=cf)
    rng = np.random.default_rng(experts)
    decl = params._moe_decl(cfg, spec)
    p = {k: (rng.standard_normal(d.shape) * 0.05).astype(np.float32)
         for k, d in decl.items()}
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    want, _, _ = jax_blocks.moe_ffn(_jnp(p), jcfg, jspec, jnp.asarray(x),
                                    None, "ragged_step")
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    specs = {k: params.logical_to_spec(d, StubMesh((1, M)), False)
             for k, d in decl.items()}
    split = "experts" if experts % M == 0 else "ffn"
    assert specs["wo"][{"experts": 0, "ffn": 1}[split]] == "model"
    assert specs["router"] == (None, None)
    parts = [blocks.moe_ffn(
        {k: mesh_lib.shard_leaf(v, specs[k], j, M) for k, v in tp.items()},
        cfg, spec, torch.from_numpy(x), shard=j) for j in range(M)]
    np.testing.assert_allclose(mesh_lib.all_reduce(parts)[0].numpy(),
                               np.asarray(want), **BLOCK_TOL)


@pytest.mark.parametrize("name,vocab", [(FAST, None), (MOE, 49155)])
def test_embed_and_logits_shards_match_jax(smoke_weights, name, vocab):
    """The vocabulary-parallel embedding (each shard's id range, zeros
    elsewhere, all-reduced) and LM head (each shard's columns gathered in
    vocabulary order on shard 0); granite's 49155 ids, which two shards
    do not divide, stay whole and run once."""
    jcfg, cfg, jp, _ = smoke_weights[name]
    if vocab is not None:
        jcfg = dataclasses.replace(jcfg, vocab_size=vocab)
        cfg = dataclasses.replace(cfg, vocab_size=vocab)
        rng = np.random.default_rng(9)
        jp = dict(jp, embed=(rng.standard_normal(
            (vocab, cfg.d_model)) * 0.02).astype(np.float32))
    tp = params.from_jax(jp)
    ps = _shards(tp, cfg)
    held = ps[0]["embed"].shape[0]
    assert held == (cfg.vocab_size if vocab else cfg.vocab_size // M)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, 7)).astype(np.int32)
    group = sharding.ModelShards([CPU] * M)
    want = jax_transformer._embed(_jnp(jp), jcfg,
                                  {"tokens": jnp.asarray(toks)},
                                  "ragged_step")
    got = transformer._embed_shards(group, ps, cfg, torch.from_numpy(toks))
    for g in got:
        np.testing.assert_allclose(g.numpy(), np.asarray(want), **BLOCK_TOL)
    x = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    want = jax_transformer._logits(_jnp(jp), jcfg, jnp.asarray(x))
    got = transformer._logits_shards(group, ps, cfg,
                                     group.replicate(torch.from_numpy(x)))
    assert got.shape == (2, 7, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)


def test_sharded_moe_steps_match_jax(smoke_weights):
    """A whole ragged step, then a paged decode step, of the MoE
    granite-moe-3b-a800m on two model shards (heads, experts and
    vocabulary split) against the JAX package's steps: logits of the
    live rows within 1e-4, and each shard's pools its KV heads of the
    JAX pools."""
    jcfg, cfg, jp, tp = smoke_weights[MOE]
    rng = np.random.default_rng(4)
    R, P, bs = 4, 6, 4
    N, pt, q_len, q_start, toks, pos = _plan(rng, cfg.vocab_size,
                                             [5, 0, 1, 7], R, P, bs)
    pool = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32), jax.tree.map(np.asarray, jax_cache.init_paged_cache(
            jcfg, R, N, bs, jnp.float32)))
    pages = {"page_table": pt, "q_len": q_len, "q_start": q_start}
    want, want_c = jax_transformer.ragged_step(
        _jnp(jp), jcfg, jnp.asarray(toks), _jnp(pool), jnp.asarray(pos),
        _jnp(pages))
    heads = [slice(first, first + kvl) for first, kvl in (
        sharding.kv_head_range(cfg, j, M) for j in range(M))]
    caches = [tree_map(lambda a: torch.from_numpy(
        np.ascontiguousarray(a[..., heads[j], :])),
        params.from_jax(pool)) for j in range(M)]
    group = sharding.ModelShards([CPU] * M)
    got, caches = transformer.ragged_step(
        _shards(tp, cfg), cfg, torch.from_numpy(toks), caches,
        torch.from_numpy(pos),
        {k: torch.from_numpy(v) for k, v in pages.items()}, group=group)
    live = q_len > 0
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                               **STEP_TOL)
    blk = np.zeros(N, bool)
    blk[pt[live].ravel()] = True
    for j, c in enumerate(caches):
        for k, w in _flat(jax.tree.map(np.asarray, want_c)).items():
            np.testing.assert_allclose(
                _flat(c)[k].numpy()[:, blk],
                w[:, blk][..., heads[j], :], **STEP_TOL)
    tok1 = rng.integers(0, cfg.vocab_size, (R, 1)).astype(np.int32)
    pos1 = (q_start + q_len)[:, None].astype(np.int32)
    want, _ = jax_transformer.decode_step(
        _jnp(jp), jcfg, jnp.asarray(tok1), want_c, jnp.asarray(pos1),
        pages={"page_table": jnp.asarray(pt)})
    got, _ = transformer.decode_step(
        _shards(tp, cfg), cfg, torch.from_numpy(tok1), caches,
        torch.from_numpy(pos1), {"page_table": torch.from_numpy(pt)},
        group=group)
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                               **STEP_TOL)


# ---------------------------------------------------------------------------
# the engine against the JAX engine on 8 host devices
# ---------------------------------------------------------------------------

PLEN, GLEN, N_REQ = 16, 4, 10
KW = dict(slots=8, prompt_len=PLEN, gen_len=GLEN, prefill_chunk=8,
          flat_buckets=[64])


def _prompts():
    rng = np.random.default_rng(7)
    lens = np.clip(np.rint(rng.lognormal(np.log(PLEN / 4), 0.8, N_REQ)),
                   1, PLEN).astype(int)
    return [rng.integers(0, 512, L) for L in lens]


PROMPTS = _prompts()


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Both tiers' smoke weights from the port's ``init_params`` (seeds 0
    and 1), and the same trees as numpy in a pickle for the JAX
    subprocess."""
    cfgs = {n: configs_of(n)[1] for n in (FAST, EXP)}
    tp = {n: init_params(cfgs[n], i, device="cpu")
          for i, n in enumerate((FAST, EXP))}
    path = tmp_path_factory.mktemp("model_axis") / "weights.pkl"
    with open(path, "wb") as f:
        pickle.dump({n: tree_map(lambda t: t.numpy(), p)
                     for n, p in tp.items()}, f)
    return cfgs, tp, str(path)


def _engine(weights, shape, delta, shard_params=False, **kw):
    cfgs, tp, _ = weights
    meshes = ([None, None] if shape is None else mesh_lib.make_tier_meshes(
        [shape] * 2, [CPU] * (2 * shape[0] * shape[1])))
    eng = CascadeEngine(
        [TierSpec("fast", cfgs[FAST], tp[FAST], mesh=meshes[0],
                  shard_params=shard_params),
         TierSpec("exp", cfgs[EXP], tp[EXP], mesh=meshes[1],
                  shard_params=shard_params)],
        deltas=[delta], clock=VirtualClock(), device="cpu", **{**KW, **kw})
    eng.warmup()
    return eng


def _drain(eng):
    for p in PROMPTS:
        eng.submit(np.asarray(p, np.int32), arrival_time=0.0)
    eng.run(max_steps=3000)
    return [(r.rid, list(map(int, r.tokens)), r.tier,
             list(r.seq_conf_by_tier)) for r in eng.requests]


@pytest.fixture(scope="module")
def mid_delta(weights):
    """A fixed δ mid-way in the widest gap of the unsharded engine's
    tier-0 sequence confidences, so the gate splits traffic."""
    confs = sorted(r[3][0] for r in _drain(_engine(weights, None, 0.5)))
    _, i = max((confs[i + 1] - confs[i], i) for i in range(len(confs) - 1))
    return 0.5 * (confs[i] + confs[i + 1])


_JAX_ENGINES = """
    import json, pickle, sys
    import numpy as np, jax
    from repro.configs import get_config
    from repro.serving import CascadeEngine, TierSpec
    from repro.serving.engine import VirtualClock
    from repro.launch.mesh import make_tier_meshes

    assert jax.device_count() == 8, jax.device_count()
    weights = pickle.load(open(sys.argv[1], "rb"))
    prompts, delta, kw, scen = json.loads(sys.argv[2])
    fast = get_config("gemma3-1b", "smoke")
    exp = get_config("phi4-mini-3.8b", "smoke")
    out = {}
    for name, (shape, shard_params) in scen.items():
        meshes = make_tier_meshes([tuple(shape)] * 2)
        eng = CascadeEngine(
            [TierSpec("fast", fast, weights["gemma3-1b"], mesh=meshes[0],
                      shard_params=shard_params),
             TierSpec("exp", exp, weights["phi4-mini-3.8b"],
                      mesh=meshes[1], shard_params=shard_params)],
            deltas=[delta], clock=VirtualClock(), **kw)
        eng.warmup()
        for p in prompts:
            eng.submit(np.asarray(p, np.int32), arrival_time=0.0)
        eng.run(max_steps=3000)
        out[name] = {
            "streams": [[r.rid, list(map(int, r.tokens)), r.tier,
                         list(map(float, r.seq_conf_by_tier))]
                        for r in eng.requests],
            "topology": eng.mesh_topology(), "memory": eng.memory_stats()}
    print("RESULT " + json.dumps(out, default=float))
"""

# the JAX engine's meshes: 1x2 with the params tensor-sharded, 2x2
# replicated (each compiles its steps once, at one flat width)
JAX_MESHES = {"1x2": ((1, 2), True), "2x2": ((2, 2), False)}


@pytest.fixture(autouse=True, scope="module")
def _jax_process(weights, mid_delta):
    """The JAX engines' subprocess, started with the module's first test
    so that it runs beside the block tests; :func:`jax_engines` waits for
    it."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    arg = json.dumps([[list(map(int, p)) for p in PROMPTS], mid_delta, KW,
                      JAX_MESHES])
    proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_JAX_ENGINES), weights[2],
         arg], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env)
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


EXECUTORS = {"ragged": {},
             "padded": {"use_ragged_step": False, "flat_buckets": None},
             "split": {"use_unified_step": False, "flat_buckets": None}}


@pytest.mark.parametrize("shard_params", [True, False],
                         ids=["shard-params", "replicas"])
@pytest.mark.parametrize("mesh", sorted(JAX_MESHES))
@pytest.mark.parametrize("executor", sorted(EXECUTORS))
def test_model_axis_engine_matches_jax(weights, mid_delta, jax_engines,
                                       executor, mesh, shard_params):
    """The port on a model-axis mesh over the CPU serves the JAX engine's
    streams on the same mesh over 8 host devices: same tokens and final
    tiers (δ splits traffic), sequence confidences within 1e-5; the same
    mesh layout and ``memory_stats`` keys, the per-device KV bytes a
    block the JAX package's logical ones over the model shards (phi4's 4
    KV heads split; gemma3's one replicated)."""
    shape = JAX_MESHES[mesh][0]
    eng = _engine(weights, shape, mid_delta, shard_params,
                  **EXECUTORS[executor])
    got = _drain(eng)
    want = jax_engines[mesh]
    assert [list(r[:3]) for r in got] == [r[:3] for r in want["streams"]]
    assert {r[2] for r in got} == {0, 1}
    for g, w in zip(got, want["streams"]):
        np.testing.assert_allclose(g[3], w[3], rtol=0, atol=CONF_ATOL)
    topo = eng.mesh_topology()
    assert [{k: v for k, v in t.items() if k != "device_ids"}
            for t in topo] == [
        {k: (shard_params if k == "shard_params" else v)
         for k, v in t.items() if k != "device_ids"}
        for t in want["topology"]]
    for g, w, kv_split in zip(eng.memory_stats(), want["memory"],
                              (1, M)):
        assert set(g) == set(w)
        assert g["kv_bytes_per_block"] * kv_split == w["kv_bytes_per_block"]
        assert len(g["kv_high_water_blocks_by_shard"]) == shape[0]
    s = eng.metrics.summary()
    assert s["completed"] == N_REQ and s["conservation"]["ok"]
    for rt in eng.runtimes:
        assert not rt.pool.bound_rows()
        trees = rt.pool.shard_trees(0)
        assert len(trees) == M
        if shard_params:
            assert len(rt.replicas) == M      # one slice a model shard
        else:
            assert len(rt.replicas) == 1      # one replica on the CPU


COUNTED = ("ragged_attention", "mixed_attention", "paged_attention",
           "confidence_gate", "router_gate")
PLAIN = ((ragged_mod, "ragged_attention"), (mixed_mod, "mixed_attention"),
         (paged_mod, "paged_attention"), (prefill_mod,
                                          "paged_prefill_attention"),
         (gate_mod, "confidence_gate"), (router_mod, "moe_route"))


@pytest.mark.parametrize("executor", sorted(EXECUTORS))
def test_launches_are_m_times_and_gate_once(monkeypatch, executor):
    """gemma3-1b -> the MoE granite-moe-3b-a800m, unsharded and on
    ``1x2`` meshes (the wrappers counting through their plain versions):
    the attention kernels and ``moe_route`` launch exactly twice as
    often, the gate as often, and the engine pays the same host syncs;
    the streams are the same."""
    monkeypatch.setattr(ops, "_on_cpu", lambda t, name: False)
    for mod, fn in PLAIN:
        monkeypatch.setattr(mod, fn, getattr(mod, f"{fn}_ref"))
    cfgs = [configs_of(FAST)[1], configs_of(MOE)[1]]
    tp = [init_params(c, i, device="cpu") for i, c in enumerate(cfgs)]
    runs = []
    for shape in (None, (1, M)):
        meshes = ([None, None] if shape is None else
                  mesh_lib.make_tier_meshes([shape] * 2, [CPU] * 4))
        for name in COUNTED:
            getattr(ops, name).launches = 0
        eng = CascadeEngine(
            [TierSpec("fast", cfgs[0], tp[0], mesh=meshes[0]),
             TierSpec("moe", cfgs[1], tp[1], mesh=meshes[1],
                      shard_params=True)],
            deltas=[0.5], clock=VirtualClock(), device="cpu",
            **{**KW, **EXECUTORS[executor]})
        eng.warmup()
        out = _drain(eng)
        runs.append(({n: getattr(ops, n).launches for n in COUNTED},
                     eng.host_syncs, eng.metrics.summary()["launches"],
                     out))
    (base, syncs0, tl0, s0), (shard, syncs1, tl1, s1) = runs
    attn = {"ragged": "ragged_attention", "padded": "mixed_attention",
            "split": "paged_attention"}[executor]
    assert base[attn] > 0 and base["router_gate"] > 0
    for n in COUNTED:
        want = base[n] * (1 if n == "confidence_gate" else M)
        assert shard[n] == want, (n, base, shard)
    assert syncs1 == syncs0 and tl1 == tl0
    assert [r[:3] for r in s1] == [r[:3] for r in s0]


def test_unsplit_layers_run_once_and_pools_copy_every_shard(smoke_weights):
    """Where the model axis divides neither the FFN's hidden units nor
    the vocabulary (511 and 513 at m = 2), ``param_specs`` leaves them
    whole and the sharded step runs them once, on shard 0: its logits
    equal the unsharded step's.  A pool on a ``1x2`` mesh holds one cache
    tree a model shard, and a block copy lands in each."""
    _, cfg, _, _ = smoke_weights[EXP]
    spec = dataclasses.replace(cfg.period[0].ffn, d_ff=511)
    cfg = dataclasses.replace(
        cfg, vocab_size=513,
        period=(dataclasses.replace(cfg.period[0], ffn=spec),))
    tp = init_params(cfg, 3, device="cpu")
    ps = _shards(tp, cfg)
    assert ps[0]["embed"].shape[0] == 513
    assert ps[0]["period"]["block0"]["ffn"]["wo"].shape[1] == 511
    rng = np.random.default_rng(6)
    R, P, bs = 4, 6, 4
    N, pt, q_len, q_start, toks, pos = _plan(rng, cfg.vocab_size,
                                             [5, 0, 1, 7], R, P, bs)
    pages = {k: torch.from_numpy(v) for k, v in
             {"page_table": pt, "q_len": q_len, "q_start": q_start}.items()}
    want, _ = transformer.ragged_step(
        tp, cfg, torch.from_numpy(toks),
        cache_lib.init_paged_cache(cfg, R, N, bs, device="cpu"),
        torch.from_numpy(pos), pages)
    scfg = sharding.shard_config(cfg, M)
    got, _ = transformer.ragged_step(
        ps, cfg, torch.from_numpy(toks),
        [cache_lib.init_paged_cache(scfg, R, N, bs, device="cpu")
         for _ in range(M)], torch.from_numpy(pos), pages,
        group=sharding.ModelShards([CPU] * M))
    live = q_len > 0
    np.testing.assert_allclose(got.numpy()[live], want.numpy()[live],
                               **BLOCK_TOL)
    pool = TierSlotPool(cfg, 4, 16, block_size=4, device="cpu",
                        mesh=mesh_lib.make_tier_mesh(1, M, [CPU] * M))
    trees = pool.shard_trees(0)
    k = [t["period"]["block0"]["mixer"]["k"] for t in trees]
    assert len(trees) == M and k[0].shape[-2] == cfg.num_kv_heads // M
    for j, t in enumerate(k):
        t[:, 3] = j + 1.0
    pool._copy_blocks([3], [5])
    assert [float(t[:, 5].min()) for t in k] == [1.0, 2.0]
    with pytest.raises(ValueError):
        pool.cache                      # noqa: B018 (per-shard only)
