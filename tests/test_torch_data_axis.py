"""The data axis of a tier mesh under every executor and tier family in
the torch port, on the CPU, against the JAX package.

* A MoE layer of a data-sharded tier routes over the tier's whole batch,
  as the JAX engine's GSPMD placement does: ``gs``, ``G`` and ``cap`` from
  the JAX batch of the launch, ranks in its slot order
  (``transformer.forward_data_shards``, ``route_data_shards``).  A
  teacher-forced ragged step of granite-moe-3b-a800m (capacity factor
  0.5, so the capacity binds) on two data shards equals the unsharded
  step over the JAX layout within 1e-5, where routing each shard's own
  tokens does not; over three routing groups, each shard's experts run
  over the buffer of the groups its tokens fall in.  A MoE draft tier
  is refused on ``2x1``.
* ``cache_specs`` equals the JAX package's (``shard_seq=False``) for all
  ten configs at their published widths; the sharded dense arena's
  per-shard shapes and ``memory_stats`` equal the JAX pool's.
* The port's engine on ``2x1`` meshes over the CPU device repeated
  against the JAX engine on the same meshes over 8 host devices (one
  subprocess for the module): gemma3-1b -> phi4-mini-3.8b under uniform
  prefill, the dense arena and speculation (k = 2); gemma3-1b ->
  granite-moe-3b-a800m at capacity factor 0.5 under the ragged, padded,
  split and uniform executors; gemma3-1b -> rwkv6-3b, -> musicgen-large
  and -> jamba-v0.1-52b at capacity factor 0.5 (uniform by themselves).
  The same tokens and final tiers (δ mid-way in the widest gap of the
  unsharded port's tier-0 confidences, or 1.0 for the MoE cascades, so
  every request reaches the MoE tier), sequence confidences within
  1e-5, the same drafts launch by launch under speculation.
* Launches, the wrappers counting through their plain versions in the
  same runs, as the engine's docstring states them.

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

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import cache as jax_cache  # noqa: E402
from repro_torch.configs import ASSIGNED, get_config  # noqa: E402
from repro_torch.kernels import confidence_gate as gate_mod  # noqa: E402
from repro_torch.kernels import flash_attention as flash_mod  # noqa: E402
from repro_torch.kernels import mamba_scan as mamba_mod  # noqa: E402
from repro_torch.kernels import mixed_attention as mixed_mod  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as paged_mod  # noqa: E402
from repro_torch.kernels import prefill_attention as prefill_mod  # noqa: E402
from repro_torch.kernels import ragged_attention as ragged_mod  # noqa: E402
from repro_torch.kernels import router_gate as router_mod  # noqa: E402
from repro_torch.kernels import rwkv6_scan as rwkv_mod  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.models import cache as cache_lib  # noqa: E402
from repro_torch.models import blocks, init_params, transformer  # noqa: E402
from repro_torch.models.params import tree_map  # noqa: E402
from repro_torch.serving import CascadeEngine, TierSpec  # noqa: E402
from repro_torch.serving import engine as engine_mod  # noqa: E402
from repro_torch.serving.engine import VirtualClock  # noqa: E402
from tests.test_torch_model_axis import StubMesh, _flat, _jax_specs  # noqa: E402
from tests.torch_one_thread import one_torch_thread  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAST, EXP, MOE = "gemma3-1b", "phi4-mini-3.8b", "granite-moe-3b-a800m"
RWKV, MUSIC, JAMBA = "rwkv6-3b", "musicgen-large", "jamba-v0.1-52b"
CPU = torch.device("cpu")
D = 2
MOE_CF = 0.5
PLEN, GLEN, N_REQ = 16, 4, 10
KW = dict(slots=8, prompt_len=PLEN, gen_len=GLEN, prefill_chunk=8)
CONF_ATOL = 1e-5


def smoke(name, get=get_config):
    """A smoke config; granite's and jamba's MoE layers at capacity
    factor 0.5, so that the expert capacity binds."""
    cfg = get(name, "smoke")
    if name not in (MOE, JAMBA):
        return cfg
    return dataclasses.replace(cfg, **{sec: tuple(
        dataclasses.replace(l, ffn=dataclasses.replace(
            l.ffn, capacity_factor=MOE_CF)) if l.ffn.kind == "moe" else l
        for l in getattr(cfg, sec)) for sec in ("head", "period", "tail")})


def _workloads():
    """10 prompts of lognormal lengths (median 4, σ 0.8, in [1, 16]), as
    ``tests/test_torch_model_axis.py`` draws them, and 10 of 16 tokens."""
    rng = np.random.default_rng(7)
    lens = np.clip(np.rint(rng.lognormal(np.log(PLEN / 4), 0.8, N_REQ)),
                   1, PLEN).astype(int)
    lognormal = [rng.integers(0, 512, L) for L in lens]
    rng = np.random.default_rng(8)
    return {"lognormal": lognormal,
            "uniform": [rng.integers(0, 512, PLEN) for _ in range(N_REQ)]}


WORK = _workloads()

SPEC = {"speculation_k": 2, "spec_delta": 0.0, "flat_buckets": [64]}
# case -> (fast tier, expensive tier, workload, δ: "mid" or fixed, engine
# switches)
CASES = {
    "uniform": (FAST, EXP, "uniform", "mid", {"use_chunked_prefill": False}),
    "dense": (FAST, EXP, "uniform", "mid", {"use_paged_kv": False}),
    "speculation": (FAST, EXP, "lognormal", "mid", SPEC),
    "moe-ragged": (FAST, MOE, "lognormal", 1.0, {}),
    "moe-padded": (FAST, MOE, "lognormal", 1.0, {"use_ragged_step": False}),
    "moe-split": (FAST, MOE, "lognormal", 1.0, {"use_unified_step": False}),
    "moe-uniform": (FAST, MOE, "uniform", 1.0,
                    {"use_chunked_prefill": False}),
    "rwkv6": (FAST, RWKV, "uniform", "mid", {}),
    "musicgen": (FAST, MUSIC, "uniform", "mid", {}),
    "jamba": (FAST, JAMBA, "uniform", 1.0, {}),
}


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Each model's smoke weights from the port's ``init_params`` (the
    fast tier seed 0, the others seed 1), and the same trees as numpy in
    a pickle for the JAX subprocess."""
    names = (FAST, EXP, MOE, RWKV, MUSIC, JAMBA)
    cfgs = {n: smoke(n) for n in names}
    tp = {n: init_params(cfgs[n], int(n != FAST), device="cpu")
          for n in names}
    path = tmp_path_factory.mktemp("data_axis") / "weights.pkl"
    with open(path, "wb") as f:
        pickle.dump({n: tree_map(lambda t: t.numpy(), p)
                     for n, p in tp.items()}, f)
    return cfgs, tp, str(path)


def _engine(weights, fast, exp, data, delta, **kw):
    cfgs, tp, _ = weights
    meshes = ([None, None] if data is None else mesh_lib.make_tier_meshes(
        [(data, 1)] * 2, [CPU] * (2 * data)))
    eng = CascadeEngine(
        [TierSpec("fast", cfgs[fast], tp[fast], mesh=meshes[0]),
         TierSpec("exp", cfgs[exp], tp[exp], mesh=meshes[1])],
        deltas=[delta], clock=VirtualClock(), device="cpu", **{**KW, **kw})
    eng.warmup()
    return eng


def _drain(eng, work):
    for p in WORK[work]:
        eng.submit(np.asarray(p, np.int32), arrival_time=0.0)
    eng.run(max_steps=3000)
    return [(r.rid, list(map(int, r.tokens)), r.tier,
             list(r.seq_conf_by_tier)) for r in eng.requests]


@pytest.fixture(scope="module")
def deltas(weights):
    """Each case's δ: a fixed one, or mid-way in the widest gap of the
    unsharded port's tier-0 sequence confidences, so the gate splits
    traffic (one run a fast tier and workload, at δ 0: nothing
    escalates)."""
    out, seen = {}, {}
    for case, (fast, exp, work, delta, kw) in CASES.items():
        if delta != "mid":
            out[case] = delta
            continue
        key = (fast, work)
        if key not in seen:
            base = {k: v for k, v in kw.items()
                    if k in ("use_chunked_prefill",)}
            confs = sorted(r[3][0] for r in _drain(
                _engine(weights, fast, exp, None, 0.0, **base), work))
            _, i = max((confs[i + 1] - confs[i], i)
                       for i in range(len(confs) - 1))
            seen[key] = 0.5 * (confs[i] + confs[i + 1])
        out[case] = seen[key]
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
        # every drafting row's draft tokens, launch by launch
        def spec(*a):
            out = run(*a)
            dl, tok = np.asarray(a[4]), np.asarray(out[5])
            drafts.append([[int(r), tok[r, :dl[r]].tolist()]
                           for r in np.flatnonzero(dl)])
            return out
        return spec

    meshes = make_tier_meshes([(2, 1), (2, 1)])
    cfgs = {n: smoke(n) for n in weights}
    jits, out = {}, {}
    for name, (fast, exp, prompts, delta, kw) in scen.items():
        eng = CascadeEngine(
            [TierSpec("fast", cfgs[fast], weights[fast], mesh=meshes[0]),
             TierSpec("exp", cfgs[exp], weights[exp], mesh=meshes[1])],
            deltas=[delta], clock=VirtualClock(), **kw)
        # the engines of one model, arena and draft role share their
        # jitted steps, so that each shape compiles once for the module
        for rt in eng.runtimes:
            fns = jits.setdefault((rt.spec.cfg.name, rt.paged, rt.spec_k,
                                   rt.spec_draft), {})
            for f in ("prefill_fn", "step_fn", "chunk_fn", "mixed_fn",
                      "ragged_fn", "spec_fn"):
                if getattr(rt, f) is not None:
                    setattr(rt, f, fns.setdefault(f, getattr(rt, f)))
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
    so that it runs beside the tests that need no JAX engine;
    :func:`jax_engines` waits for it."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    scen = {case: [fast, exp, [list(map(int, p)) for p in WORK[work]],
                   deltas[case], {**KW, **kw}]
            for case, (fast, exp, work, _, kw) in CASES.items()}
    proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_JAX_ENGINES), weights[2],
         json.dumps([scen, MOE_CF, [MOE, JAMBA]])], stdout=subprocess.PIPE,
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


# ---------------------------------------------------------------------------
# specs and the sharded dense arena
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ASSIGNED)
def test_cache_specs_match_jax(name):
    """``cache_specs`` leaf for leaf as the JAX package's at
    ``shard_seq=False`` (the dense pool's layout), on data, model and
    mixed meshes: the request rows over ``data``, KV heads, ``d_inner``
    and RWKV heads over ``model`` where they divide."""
    jcfg, cfg = jax_get_config(name, ""), get_config(name, "")
    decl = _flat(cache_lib.declare_cache(cfg, 8, 64))
    for shape in ((2, 1), (4, 1), (2, 2), (1, 2), (1, 8)):
        mesh = StubMesh(shape)
        got = _flat(cache_lib.cache_specs(cfg, 8, 64, mesh))
        want = _jax_specs(jax_cache.cache_specs(jcfg, 8, 64, mesh),
                          {k: len(c.shape) for k, c in decl.items()})
        assert got == want, (name, shape)
        assert any("data" in s for s in got.values()) == (shape[0] > 1)


# ---------------------------------------------------------------------------
# MoE routing over the tier's whole batch
# ---------------------------------------------------------------------------


def test_sharded_moe_step_routes_over_the_jax_layout(weights):
    """A teacher-forced ragged step of the MoE granite-moe-3b-a800m
    (capacity factor 0.5) on two data shards, each packing its own rows
    at its own width: every live row's logits equal the unsharded step
    over the tier's one flat batch (the JAX layout) within 1e-5, with one
    ``moe_route`` launch a MoE layer; routing each shard's tokens alone
    (the port before this repair) drops other pairs."""
    cfgs, tp, _ = weights
    cfg, p = cfgs[MOE], tp[MOE]
    rng = np.random.default_rng(3)
    R, P, bs = 4, 5, 4
    qlen = np.asarray([5, 3, 0, 6], np.int32)
    qstart = np.asarray([0, 4, 0, 2], np.int32)
    pt = np.arange(1, R * P + 1, dtype=np.int32).reshape(R, P)
    toks = [rng.integers(0, cfg.vocab_size, n) for n in qlen]

    def pack(rows, w):
        t, ps, o = np.zeros((1, w), np.int32), np.zeros((1, w), np.int32), 0
        for b in rows:
            n = int(qlen[b])
            t[0, o:o + n] = toks[b]
            ps[0, o:o + n] = qstart[b] + np.arange(n)
            o += n
        return torch.from_numpy(t), torch.from_numpy(ps)

    def pages(rows):
        return {"page_table": torch.from_numpy(pt[rows]),
                "q_len": torch.from_numpy(qlen[rows]),
                "q_start": torch.from_numpy(qstart[rows])}

    def cache(rows):
        return cache_lib.init_paged_cache(cfg, rows, R * P + 1, bs,
                                          device="cpu")
    W = 16                                      # the bucket of 16 tokens
    want, _ = transformer.ragged_step(p, cfg, *pack(range(R), W)[:1],
                                      cache(R), pack(range(R), W)[1],
                                      pages(slice(0, R)))
    halves = [slice(0, 2), slice(2, 4)]
    ins = [pack(range(h.start, h.stop), 8) for h in halves]
    slots, o = [], 0
    for h in halves:
        n = int(qlen[h].sum())
        slots.append(np.concatenate([o + np.arange(n), [W] * (8 - n)]))
        o += n
    ops.router_gate.launches = 0
    out = transformer.forward_data_shards(
        [p, p], cfg, [{"tokens": t} for t, _ in ins], mode="ragged_step",
        caches=[cache(2), cache(2)], pos=[ps for _, ps in ins],
        pages=[pages(h) for h in halves], groups=[None, None],
        layout=transformer.MoeLayout(slots, W))
    got = torch.cat([transformer.last_slot_gather(lg, pages(h)["q_len"],
                                                  flat=True)
                     for (lg, _), h in zip(out, halves)])
    live = qlen > 0
    np.testing.assert_allclose(got.numpy()[live], want.numpy()[live],
                               atol=1e-5, rtol=1e-5)
    alone = torch.cat([transformer.ragged_step(
        p, cfg, t, cache(2), ps, pages(h))[0]
        for (t, ps), h in zip(ins, halves)])
    assert np.abs(alone.numpy()[live] - want.numpy()[live]).max() > 1e-3


def test_moe_draft_tier_refused_on_data_shards(weights):
    """granite-moe-3b-a800m drafting on ``2x1``: the port refuses a MoE
    draft tier on any mesh (the draft loop's masked rows would route
    and take expert capacity), so no draft step routes per shard."""
    with pytest.raises(ValueError, match="have MoE layers"):
        _engine(weights, MOE, EXP, D, 1.0, **SPEC)


def test_route_data_shards_compact_buffers(weights):
    """Three data shards over a JAX batch of 3072 token slots (three
    routing groups of 1024): shard 0 holds groups 0-1, shard 1 groups
    1-2 (both with padding slots of their own), shard 2 only padding.
    Each shard's ``moe_ffn`` over its own buffer of ``n·cap`` rows an
    expert (``n`` the groups it touches; 0 for shard 2) equals the
    unsharded ``moe_ffn`` over the JAX batch within 1e-5, with one
    ``moe_route`` launch."""
    cfg = weights[0][MOE]
    spec = cfg.period[0].ffn
    p = weights[1][MOE]["period"]["block0"]["ffn"]
    p = tree_map(lambda a: a[0], p)
    total, d = 3072, cfg.d_model
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (total, d)).astype(np.float32))
    want = blocks.moe_ffn(p, cfg, spec, x[None])[0]
    held = [np.arange(0, 1536), np.arange(1536, total), np.zeros(0, int)]
    slots = [np.concatenate([h, [total] * 5]) for h in held]
    xs = [torch.cat([x[torch.from_numpy(h)], torch.zeros(5, d)])
          for h in held]
    layout = transformer.MoeLayout(slots, total)
    assert layout.groups(1024) == [(0, 2), (1, 2), (0, 0)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ops, "_on_cpu", lambda t, name: False)
        mp.setattr(router_mod, "moe_route", router_mod.moe_route_ref)
        ops.router_gate.launches = 0
        routes = transformer.route_data_shards(
            spec, [blocks.moe_logits(p, xi) for xi in xs], layout)
        assert ops.router_gate.launches == 1
    cap = blocks.moe_capacity(spec, 1024)
    assert [r[2] for r in routes] == [2 * cap, 2 * cap, 0]
    for xi, h, r in zip(xs, held, routes):
        got = blocks.moe_ffn(p, cfg, spec, xi[None], route=r)[0]
        np.testing.assert_allclose(got[:len(h)].numpy(),
                                   want[torch.from_numpy(h)].numpy(),
                                   atol=1e-5, rtol=1e-5)
        assert not got[len(h):].any()


# ---------------------------------------------------------------------------
# the tier families the JAX subprocess does not run
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["jamba-v0.1-52b", "qwen2-vl-72b"])
def test_data_axis_serves_every_tier_family(weights, name):
    """gemma3-1b -> jamba-v0.1-52b (Mamba and MoE layers: ``mamba_scan``
    a shard, the MoE layer routed over both) and -> qwen2-vl-72b (zero
    frontend embeddings a shard, M-RoPE) on ``2x1``, uniform by
    themselves: the unsharded port's streams (their MoE capacity does
    not bind at the smoke capacity factor of 2)."""
    cfgs, tp, path = weights
    cfg = get_config(name, "smoke")
    w = (dict(cfgs, **{name: cfg}),
         dict(tp, **{name: init_params(cfg, 1, device="cpu")}), path)
    base = _drain(_engine(w, FAST, name, None, 0.5), "uniform")
    eng = _engine(w, FAST, name, D, 0.5)
    got = _drain(eng, "uniform")
    assert [r[:3] for r in got] == [r[:3] for r in base]
    for g, b in zip(got, base):
        np.testing.assert_allclose(g[3], b[3], rtol=0, atol=1e-6)
    assert not eng.chunked_prefill
    assert [rt.data_shards for rt in eng.runtimes] == [D, D]


# ---------------------------------------------------------------------------
# launches
# ---------------------------------------------------------------------------

COUNTED = ("ragged_attention", "mixed_attention", "paged_attention",
           "flash_attention", "confidence_gate", "router_gate",
           "rwkv6_scan", "mamba_scan")
PLAIN = ((ragged_mod, "ragged_attention"), (mixed_mod, "mixed_attention"),
         (paged_mod, "paged_attention"), (prefill_mod,
                                          "paged_prefill_attention"),
         (flash_mod, "flash_attention"), (gate_mod, "confidence_gate"),
         (router_mod, "moe_route"), (rwkv_mod, "rwkv6_scan"),
         (mamba_mod, "mamba_scan"))


def _recorded(run, drafts):
    """``run_spec`` recording every drafting row's draft tokens, launch
    by launch, as the JAX subprocess records them."""
    def spec(*a, **kw):
        out, steps = run(*a, **kw)
        dl, tok = np.asarray(a[4]), out.get("draft_tok")
        if tok is not None:
            tok = torch.cat(list(tok)) if isinstance(tok, tuple) else tok
            drafts.append([[int(r), tok[r, :dl[r]].tolist()]
                           for r in np.flatnonzero(dl)])
        return out, steps
    return spec


@pytest.fixture(scope="module")
def port_runs(weights, deltas):
    """Each case's ``2x1`` run of the port, once for the module, through
    the plain versions with the wrappers counting after warmup:
    ``run(case)`` gives (the engine, its streams, the launch counts, the
    number of shards holding an admitted row in each uniform prefill
    launch by tier, the draft tier's drafts)."""
    done = {}

    def run(case):
        if case in done:
            return done[case]
        fast, exp, work, _, kw = CASES[case]
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
            eng = _engine(weights, fast, exp, D, deltas[case], **kw)
            for rt in eng.runtimes:
                if rt.spec_draft:
                    rt.run_spec = _recorded(rt.run_spec, drafts)
            for name in COUNTED:
                getattr(ops, name).launches = 0
            prefills[0].clear()
            prefills[1].clear()
            streams = _drain(eng, work)
            counts = {n: getattr(ops, n).launches for n in COUNTED}
        done[case] = eng, streams, counts, prefills, drafts
        return done[case]
    return run


def _layers(cfg, kind):
    return sum(l.mixer.kind == kind if kind in ("attn", "rwkv6", "mamba")
               else l.ffn.kind == kind for l in cfg.layers)


@pytest.mark.parametrize("case", sorted(CASES))
def test_data_axis_launch_formulas(weights, port_runs, case):
    """Each attention kernel, scan and the gate launch once per data
    shard per tier launch (a uniform prefill: once per shard holding an
    admitted row; a draft loop: the shards' own draft steps; the dense
    arena's decode attends in plain torch), and ``moe_route`` once per
    MoE layer per tier launch, not once per shard."""
    cfgs = weights[0]
    fast, exp = CASES[case][:2]
    eng, _, got, prefills, _ = port_runs(case)
    s = eng.metrics.summary()
    tiers = [cfgs[fast], cfgs[exp]]
    kinds = s["launches_by_kind"]
    want = dict.fromkeys(COUNTED, 0)
    steps = s["speculation"]["draft_steps_by_tier"]
    for t, k in enumerate(kinds):
        attn = _layers(tiers[t], "attn")
        routed = 0
        for kind, n in k.items():
            if kind in ("ragged", "spec"):
                want["ragged_attention"] += D * attn * n
            elif kind in ("mixed", "chunk"):
                want["mixed_attention"] += D * attn * n
            elif kind == "step" and eng.runtimes[t].paged:
                want["paged_attention"] += D * attn * n
            if kind != "prefill":
                want["confidence_gate"] += D * n
                routed += n
        shards = sum(prefills[t])
        assert len(prefills[t]) == k.get("prefill", 0)
        want["flash_attention"] += attn * shards
        want["rwkv6_scan"] += _layers(tiers[t], "rwkv6") * shards
        want["mamba_scan"] += _layers(tiers[t], "mamba") * shards
        want["confidence_gate"] += shards + steps[t]
        want["paged_attention"] += attn * steps[t]
        routed += k.get("prefill", 0)
        want["router_gate"] += _layers(tiers[t], "moe") * routed
    assert got == want
    assert got["router_gate"] > 0 or MOE not in (fast, exp)
    assert sum(steps) > 0 or "speculation_k" not in CASES[case][4]


# ---------------------------------------------------------------------------
# the engine against the JAX engine on 8 host devices
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(CASES))
def test_data_axis_engine_matches_jax(deltas, port_runs, jax_engines, case):
    """The port on ``2x1`` meshes serves the JAX engine's streams on the
    same meshes: the same tokens and final tiers, sequence confidences
    within 1e-5, the same drafts launch by launch, the same
    ``memory_stats``; the arenas' per-shard shapes are the JAX arrays'
    shard shapes."""
    eng, got, _, _, drafts = port_runs(case)
    want = jax_engines[case]
    assert [list(r[:3]) for r in got] == [r[:3] for r in want["streams"]]
    for g, w in zip(got, want["streams"]):
        np.testing.assert_allclose(g[3], w[3], rtol=0, atol=CONF_ATOL)
    assert drafts == want["drafts"]
    assert {r[2] for r in got} == ({1} if deltas[case] == 1.0 else {0, 1})
    s = eng.metrics.summary()
    assert s["completed"] == N_REQ and s["conservation"]["ok"]
    for g, w in zip(eng.memory_stats(), want["memory"]):
        if "kv_bytes_per_block" in w:
            # the port's arena holds each shard past 0's own null block
            w = dict(w, kv_arena_bytes=w["kv_arena_bytes"]
                     + (D - 1) * w["kv_bytes_per_block"])
        assert g == w
    for rt, shapes in zip(eng.runtimes, want["shard_shapes"]):
        assert rt.pool.data_shards == D
        if not rt.paged:
            for tree in rt.pool.caches:
                assert {k: list(v.shape) for k, v in _flat(tree).items()} \
                    == shapes
