"""Multi-device serving of the torch port on the CPU: per-tier meshes
(``TierSpec.mesh``), data-sharded tiers and ``--tier-mesh``.

* The port's shard-aware ``SlotAllocator``, ``BlockAllocator`` and
  ``TierSlotPool(data_shards=2)`` are driven side by side with the JAX
  package's through the same operations (the cases of
  ``tests/test_sharded_serving.py``, and a seeded random sequence with
  the prefix index on): same results, same errors.
* The port's engine on ``4x1`` meshes over the CPU device repeated (the
  port's counterpart of eight host devices) serves the same workloads as
  its one-shard engine, which ``tests/test_torch_serving.py`` holds to
  the JAX engine: the same tokens and final tiers (inside the port the
  reference's bit-identity holds), confidences within 1e-6, under the
  ragged, padded and split executors, with the prefix cache on 2 shards,
  and on an over-subscribed 24-block arena with stalls and with
  ``youngest`` preemption.  A ``1x1`` mesh per tier (per-tier placement)
  gives the one-shard streams under every executor.
* Shard assignments (the shard of every PREFILL transition in the
  tracer), per-shard KV high water, preemptions and prefix hits by shard
  equal the JAX engine's on 8 host devices (one subprocess, shared by the
  module).
* The refusals, the JAX errors, ``parse_mesh_shape``, ``tier_meshes``
  and ``mesh_topology``.

Torch runs on one intra-op thread, as in
``tests/test_torch_observability.py``.
"""
import json
import os
import pickle
import subprocess
import sys
import textwrap
from argparse import Namespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

from repro.launch import serve_async as jax_serve_async  # noqa: E402
from repro.serving import slots as jax_slots  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import serve_async  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models.params import tree_map  # noqa: E402
from repro_torch.models.sharding import data_axis_size  # noqa: E402
from repro_torch.serving import CascadeEngine, TierSpec, Tracer  # noqa: E402
from repro_torch.serving import engine as engine_mod  # noqa: E402
from repro_torch.serving import slots as port_slots  # noqa: E402
from repro_torch.serving.engine import VirtualClock  # noqa: E402
from repro_torch.serving.observability import REQUEST_PID_BASE  # noqa: E402
from tests.test_slots_properties import check_invariants  # noqa: E402
from tests.test_torch_model import configs_of  # noqa: E402
from tests.torch_one_thread import one_torch_thread  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAST, EXP = "gemma3-1b", "phi4-mini-3.8b"
CPU = torch.device("cpu")
PLEN, GLEN, N = 16, 4, 10
KW = dict(slots=8, prompt_len=PLEN, gen_len=GLEN, prefill_chunk=8)
# max_seq 20, block 4: 5 pages a row, 41 blocks fully provisioned; 24
# over-subscribes (6 a shard over 4 shards: one full request + null)
OVER = dict(kv_block_size=4, kv_blocks=24)
PACKAGES = {"jax": jax_slots, "torch": port_slots}


# ---------------------------------------------------------------------------
# the shard-aware allocators and pool, side by side with the JAX package's
# ---------------------------------------------------------------------------


def _slot_ranges(m):
    a = m.SlotAllocator(8, shards=2)
    out = [a.shard_of(3), a.shard_of(4), a.free_in(0), a.free_in(1)]
    out += [a.alloc(1) for _ in range(4)]
    out += [a.alloc(1), a.free_in(0), a.alloc(0)]
    a.free(5)
    out += [a.free_in(1), a.alloc(1), a.shard_of(a.alloc(None))]
    return out


def _slot_unsharded(m):
    a = m.SlotAllocator(4)
    out = [a.alloc() for _ in range(4)]
    a.free(1)
    a.free(2)
    return out + [a.alloc(), a.num_free, a.free_in(None)]


def _block_null(m):
    b = m.BlockAllocator(8, shards=2)
    out = [b.free_in(0), b.free_in(1)] + [b.alloc(0) for _ in range(3)]
    out += [b.alloc(0), b.shard_of(b.alloc(1)), list(b.high_water_by_shard)]
    b.free(2)
    b.reserve(2, 1)
    out += [b.free_in(0), b.free_in(1), b.reserved_in(1), b.restore(1),
            list(b.high_water_by_shard), b.used_in(0), b.used_in(1)]
    return out


def _block_unsharded(m):
    b = m.BlockAllocator(4)
    out = [b.alloc() for _ in range(3)]
    return out + [b.alloc(), b.high_water, list(b.high_water_by_shard)]


def _pool(m, *args, **kw):
    cfg = configs_of(FAST)[m is port_slots]
    if m is port_slots:
        kw["device"] = "cpu"
    return m.TierSlotPool(cfg, *args, **kw)


def _pool_accounting(m):
    pool = _pool(m, 4, 16, block_size=4, num_blocks=10, data_shards=2)
    out = [pool.data_shards, pool.num_blocks, pool.shard_of(1),
           pool.shard_of(2), pool.can_admit(8, shard=1)]
    pool.bind(2, 8, row_tokens=16)
    out.append([pool.shard_of_block(b) for b in pool._row_blocks[2]])
    out.append(pool.can_admit(8, shard=0))
    pool.bind(0, 8, row_tokens=16)
    out.append([pool.shard_of_block(b) for b in pool._row_blocks[0]])
    out += [pool.can_admit(8, shard=1), pool.can_admit(4, shard=1)]
    pool.bind(3, 4, row_tokens=8)
    out += [pool.ensure_blocks(2, 11), pool.ensure_blocks(3, 7)]
    pool.release(2)
    out += [pool.ensure_blocks(3, 7), pool.page_table.tolist(),
            pool.shrink(5), pool.unshrink()]
    check_invariants(pool)
    return out


def _pool_rounding(m):
    pool = _pool(m, 4, 16, block_size=4, data_shards=2)
    stats = pool.memory_stats()
    return [pool.num_blocks, stats["data_shards"],
            stats["kv_high_water_blocks_by_shard"]]


def _pool_random_ops(m):
    """A seeded random sequence of binds (with prefix matches), growth,
    publication and releases over 2 shards, the prefix index on: the
    page tables, free lists and per-shard peaks after every step."""
    rng = np.random.default_rng(3)
    pool = _pool(m, 4, 16, block_size=4, num_blocks=14, data_shards=2,
                 prefix_chunk=4)
    base = [rng.integers(0, 9, 16) for _ in range(2)]
    rows = {}
    out = []
    for _ in range(60):
        op = rng.integers(0, 3)
        slot = int(rng.integers(0, 4))
        shard = pool.shard_of(slot)
        if op == 0 and slot not in rows:
            prompt = base[int(rng.integers(0, 2))][:int(rng.integers(5, 17))]
            cached, blocks = pool.match_prefix(prompt, shard)
            n = cached + min(4, len(prompt) - cached)
            if pool.can_admit(n, shard, cached=cached,
                              prefix_blocks=blocks):
                pool.bind(slot, n, row_tokens=len(prompt) + 4,
                          prefix=(cached, blocks) if cached else None)
                rows[slot] = (prompt, n)
        elif op == 1 and slot in rows:
            prompt, n = rows[slot]
            if n < len(prompt) and pool.ensure_blocks(slot, n):
                n = min(n + 4, len(prompt))
                rows[slot] = (prompt, n)
                pool.publish_prefix(slot, prompt, n)
        elif op == 2 and slot in rows:
            pool.release(slot)
            del rows[slot]
        check_invariants(pool)
        out.append((pool.page_table.tolist(),
                    [list(f) for f in pool.blocks._free],
                    list(pool.blocks.high_water_by_shard),
                    pool.prefix_index_entries(0),
                    pool.prefix_index_entries(1)))
    return out


def _pool_errors(m):
    out = []
    for kw in (dict(capacity=3, num_blocks=None),      # 3 rows, 2 shards
               dict(capacity=4, num_blocks=6)):        # 3 blocks a shard
        with pytest.raises(ValueError) as err:
            _pool(m, kw["capacity"], 16, block_size=4,
                  num_blocks=kw["num_blocks"], data_shards=2)
        out.append(str(err.value))
    for make in (lambda: m.SlotAllocator(6, shards=4),
                 lambda: m.BlockAllocator(9, shards=2)):
        with pytest.raises(ValueError) as err:
            make()
        out.append(str(err.value))
    return out


ALLOCATOR_CASES = {f.__name__[1:]: f for f in (
    _slot_ranges, _slot_unsharded, _block_null, _block_unsharded,
    _pool_accounting, _pool_rounding, _pool_random_ops, _pool_errors)}
ALLOCATOR_WANT = {
    "slot_ranges": [0, 1, 4, 4, 4, 5, 6, 7, None, 4, 0, 1, 5, 0],
    "slot_unsharded": [0, 1, 2, 3, 2, 1, 1],
    "block_unsharded": [1, 2, 3, None, 3, [3]],
    "pool_rounding": [18, 2, [0, 0]],
}


@pytest.mark.parametrize("case", sorted(ALLOCATOR_CASES))
def test_sharded_allocators_match_jax(case):
    """The port's allocators and pool give the JAX package's results, op
    for op (and where the JAX suite pins the values, those)."""
    got, want = (ALLOCATOR_CASES[case](PACKAGES[p]) for p in ("torch",
                                                              "jax"))
    assert got == want
    if case in ALLOCATOR_WANT:
        assert got == ALLOCATOR_WANT[case]


def test_shard_arenas_on_their_devices_with_their_own_null_block():
    """Shard s holds its rows and its block range, shard 0 by global id
    with the null block, shards past 0 one block more (their own null
    block, local 0): a page table translates to local ids with null
    entries kept null, and a copy-on-write stays inside its shard."""
    pool = _pool(port_slots, 4, 16, block_size=4, num_blocks=12,
                 data_shards=2)
    k = [c["period"]["block0"]["mixer"]["k"] for c in pool.caches]
    assert [t.shape[1] for t in k] == [6, 7]
    assert pool.devices == [CPU, CPU]
    pool.bind(2, 8, row_tokens=16)              # shard 1: blocks 6, 7
    assert pool._row_blocks[2] == [6, 7]
    assert pool.local_page_table(1)[0].tolist() == [1, 2, 0, 0]
    assert pool.local_page_table(0).tolist() == [[0] * 4] * 2
    k[1][:, 1] = 1.0
    pool._copy_blocks([6], [7])
    assert bool((k[1][:, 2] == 1.0).all()) and float(k[1][:, 0].sum()) == 0
    with pytest.raises(ValueError):
        pool.cache                      # noqa: B018 (per-shard only)


# ---------------------------------------------------------------------------
# the sharded engine against the port's one-shard engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Both tiers' smoke weights from the port's ``init_params`` (seeds 0
    and 1), and the same trees as numpy in a pickle for the JAX
    subprocess (the JAX package's keys are the port's)."""
    cfgs = {n: configs_of(n)[1] for n in (FAST, EXP)}
    params = {n: init_params(cfgs[n], i, device="cpu")
              for i, n in enumerate((FAST, EXP))}
    path = tmp_path_factory.mktemp("multidevice") / "weights.pkl"
    with open(path, "wb") as f:
        pickle.dump({n: tree_map(lambda t: t.numpy(), p)
                     for n, p in params.items()}, f)
    return cfgs, params, str(path)


def _workloads():
    """The JAX suite's workloads: 10 prompts of 16 tokens, 10 of
    lognormal lengths, and 10 sharing their leading tokens."""
    rng = np.random.default_rng(7)
    uniform = [rng.integers(0, 512, PLEN) for _ in range(N)]
    lens = np.clip(np.rint(rng.lognormal(np.log(PLEN / 4), 0.8, N)),
                   1, PLEN).astype(int)
    mixed = [rng.integers(0, 512, L) for L in lens]
    base = rng.integers(0, 512, PLEN)
    shared = [np.concatenate([base[:12], rng.integers(0, 512, 4)])[:L]
              for L in np.maximum(lens, 10)]
    return {"uniform": uniform, "lognormal": mixed, "shared": shared}


WORK = _workloads()


def _engine(weights, meshes, delta, tracer=None, **kw):
    cfgs, params, _ = weights
    m = [None, None] if meshes is None else meshes
    eng = CascadeEngine(
        [TierSpec("fast", cfgs[FAST], params[FAST], mesh=m[0]),
         TierSpec("exp", cfgs[EXP], params[EXP], mesh=m[1])],
        deltas=[delta], clock=VirtualClock(), device="cpu", tracer=tracer,
        **{**KW, **kw})
    eng.warmup()
    return eng


def _drain(eng, prompts):
    for p in prompts:
        eng.submit(np.asarray(p, np.int32), arrival_time=0.0)
    eng.run(max_steps=3000)
    return [(r.rid, tuple(r.tokens), r.tier, tuple(r.seq_conf_by_tier))
            for r in eng.requests]


def _meshes(data, model=1):
    return mesh_lib.make_tier_meshes([(data, model)] * 2,
                                     [CPU] * (2 * data * model))


_DELTA = {}


def _mid_delta(weights, work):
    """A fixed δ mid-way in the widest gap of the one-shard engine's
    tier-0 sequence confidences on workload `work` (as the JAX suite
    picks it), so the gate splits traffic."""
    if work not in _DELTA:
        confs = sorted(r[3][0] for r in _drain(_engine(weights, None, 0.5),
                                               WORK[work]))
        _, i = max((confs[i + 1] - confs[i], i)
                   for i in range(len(confs) - 1))
        _DELTA[work] = 0.5 * (confs[i] + confs[i + 1])
    return _DELTA[work]


# case -> (workload, data shards, mid δ or 0.5, engine switches)
ENGINE_CASES = {
    "ragged-uniform": ("uniform", 4, True, {}),
    "ragged-lognormal": ("lognormal", 4, True, {}),
    "padded": ("lognormal", 4, True, {"use_ragged_step": False}),
    "split": ("lognormal", 4, True, {"use_unified_step": False}),
    "prefix-2-shards": ("shared", 2, True, {"prefix_cache": True,
                                            "kv_block_size": 4}),
    "stalls": ("lognormal", 4, False, OVER),
    "youngest": ("lognormal", 4, False, {**OVER,
                                         "preemption_policy": "youngest"}),
}


def _assert_same_streams(base, shard):
    assert [r[:3] for r in base] == [r[:3] for r in shard]
    for a, b in zip(base, shard):
        np.testing.assert_allclose(a[3], b[3], rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_sharded_engine_streams_equal_one_shard(weights, case):
    """Rows and KV blocks on D data shards, every launch once per shard:
    the same tokens and final tiers as the one-shard engine, confidences
    within 1e-6; the pools stay consistent and drain empty."""
    work, d, mid, kw = ENGINE_CASES[case]
    delta = _mid_delta(weights, work) if mid else 0.5
    base_kw = {k: v for k, v in kw.items() if k != "preemption_policy"}
    base = _drain(_engine(weights, None, delta, **base_kw), WORK[work])
    eng = _engine(weights, _meshes(d), delta, **kw)
    shard = _drain(eng, WORK[work])
    _assert_same_streams(base, shard)
    if mid:
        assert {r[2] for r in base} == {0, 1}       # δ splits traffic
    s = eng.metrics.summary()
    assert s["completed"] == N and s["conservation"]["ok"]
    if "preemption_policy" in kw:
        assert s["preemptions"] > 0 and s["replayed_tokens"] > 0
    if kw.get("prefix_cache"):
        assert s["prefix_cache"]["hits"] > 0
    for rt in eng.runtimes:
        assert rt.pool.data_shards == d and not rt.pool.bound_rows()
        check_invariants(rt.pool)
        by_shard = rt.pool.memory_stats()["kv_high_water_blocks_by_shard"]
        assert len(by_shard) == d and sum(by_shard) >= \
            rt.pool.blocks.high_water


def test_sharded_launches_are_d_times_and_one_fetch_a_tick(weights,
                                                           monkeypatch):
    """Each shard runs each launch of its tier's tick on its own rows:
    D per tier launch (D per warmup width), each at the bucket of its
    own live tokens, and still one fetch per active tier per tick."""
    delta = _mid_delta(weights, "lognormal")
    widths = []
    fn = engine_mod._TierRuntime.ragged_fn

    def counted(rt, tokens, *rest, shard=0):
        widths.append((rt.spec.name, shard, tokens.shape[1],
                       rest[1].shape[0]))
        return fn(rt, tokens, *rest, shard=shard)
    monkeypatch.setattr(engine_mod._TierRuntime, "ragged_fn", counted)
    eng = _engine(weights, _meshes(4), delta)
    warm = len(widths)
    assert warm == 4 * sum(len(rt.flat_buckets) for rt in eng.runtimes)
    assert [rt.flat_buckets for rt in eng.runtimes] == [[8, 16]] * 2
    _drain(eng, WORK["lognormal"])
    s = eng.metrics.summary()
    ticks = widths[warm:]
    assert len(ticks) == 4 * sum(s["launches"])
    assert all(rows == 2 for *_, rows in ticks)     # a shard's rows
    assert eng.host_syncs == sum(s["host_syncs"]) <= sum(s["active_ticks"])


@pytest.mark.parametrize("flags", [
    {}, {"use_ragged_step": False}, {"use_unified_step": False},
    {"use_chunked_prefill": False}, {"use_paged_kv": False},
    {"speculation_k": 2, "spec_delta": 0.0}, {"prefix_cache": True},
    {**OVER, "preemption_policy": "youngest"}],
    ids=["ragged", "padded", "split", "uniform", "dense", "speculation",
         "prefix", "preemption"])
def test_per_tier_placement_under_every_executor(weights, flags):
    """Each tier on a ``1x1`` mesh of its own (the CPU here, a card of
    its own under ``--tier-mesh 1 1``): the unmeshed engine's streams."""
    work = WORK["uniform"] if flags.get("use_chunked_prefill") is False \
        or flags.get("use_paged_kv") is False else WORK["lognormal"]
    base_kw = {k: v for k, v in flags.items() if k != "preemption_policy"}
    base = _drain(_engine(weights, None, 0.5, **base_kw), work)
    eng = _engine(weights, _meshes(1), 0.5, **flags)
    _assert_same_streams(base, _drain(eng, work))
    assert [t["mesh"] for t in eng.mesh_topology()] == \
        [{"data": 1, "model": 1}] * 2


# ---------------------------------------------------------------------------
# shard assignments against the JAX engine on 8 host devices
# ---------------------------------------------------------------------------

_JAX_SCENARIOS = """
    import json, pickle, sys
    import numpy as np, jax
    from repro.configs import get_config
    from repro.serving import CascadeEngine, TierSpec, Tracer
    from repro.serving.engine import VirtualClock
    from repro.launch.mesh import make_tier_meshes

    assert jax.device_count() == 8, jax.device_count()
    weights = pickle.load(open(sys.argv[1], "rb"))
    scen = json.loads(sys.argv[2])
    fast = get_config("gemma3-1b", "smoke")
    exp = get_config("phi4-mini-3.8b", "smoke")
    meshes = make_tier_meshes([(4, 1), (4, 1)])
    jits = {}
    out = {}
    for name, (prompts, delta, kw) in scen.items():
        tr = Tracer()
        eng = CascadeEngine(
            [TierSpec("fast", fast, weights["gemma3-1b"], mesh=meshes[0]),
             TierSpec("exp", exp, weights["phi4-mini-3.8b"],
                      mesh=meshes[1])],
            deltas=[delta], clock=VirtualClock(), tracer=tr, **kw)
        for t, rt in enumerate(eng.runtimes):   # one compile per shape
            fns = jits.setdefault(t, {})
            for f in ("ragged_fn", "mixed_fn", "chunk_fn", "step_fn"):
                setattr(rt, f, fns.setdefault(f, getattr(rt, f)))
        eng.warmup()
        for p in prompts:
            eng.submit(np.asarray(p, np.int32), arrival_time=0.0)
        eng.run(max_steps=3000)
        out[name] = {"events": [e for e in tr.events() if e["name"] in (
            "PREFILL", "prefix_cache_hit")],
            "memory": eng.memory_stats(),
            "summary": {k: eng.metrics.summary()[k] for k in (
                "preemptions_by_tier", "completed")},
            "streams": [[r.rid, list(map(int, r.tokens)), r.tier]
                        for r in eng.requests]}
    print("RESULT " + json.dumps(out, default=float))
"""

# name -> (workload, mid δ or 0.5, engine switches): all on 4x1 meshes,
# over one arena geometry and two flat widths, so the JAX engines compile
# each step shape once
JAX_SCENARIOS = {
    "stalls": ("lognormal", True, {}),
    "youngest": ("lognormal", False, {"preemption_policy": "youngest"}),
    "prefix": ("shared", True, {"prefix_cache": True}),
}
JAX_KW = dict(KW, flat_buckets=[64], **OVER)


def shard_record(events, memory, summary, streams) -> dict:
    """What the two engines must agree on: the shard of every PREFILL
    transition (tier, rid, shard, in order), every prefix hit (tier, rid,
    cached tokens, shard), each tier's KV high water by shard, the
    preemptions by tier and the streams."""
    return {
        "prefill": [(e["pid"] - REQUEST_PID_BASE, e["id"], e["tid"])
                    for e in events if e["name"] == "PREFILL"
                    and e["ph"] == "b"],
        "hits": [(e["tid"], e["args"]["rid"], e["args"]["cached_tokens"],
                  e["args"]["shard"]) for e in events
                 if e["name"] == "prefix_cache_hit"],
        "high_water": [m["kv_high_water_blocks_by_shard"] for m in memory],
        "preemptions": list(summary["preemptions_by_tier"]),
        "streams": [(r[0], tuple(r[1]), r[2]) for r in streams]}


@pytest.fixture(scope="module")
def jax_shards(weights):
    """The JAX engine's records of :data:`JAX_SCENARIOS` on 8 host
    devices, from ONE subprocess (its engines share their jitted
    steps)."""
    scen = {name: ([list(map(int, p)) for p in WORK[work]],
                   _mid_delta(weights, work) if mid else 0.5,
                   {**JAX_KW, **kw})
            for name, (work, mid, kw) in JAX_SCENARIOS.items()}
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_JAX_SCENARIOS),
         weights[2], json.dumps(scen)],
        capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT ")]
    res = json.loads(line[-1][len("RESULT "):])
    return {name: shard_record(**rec) for name, rec in res.items()}


@pytest.mark.parametrize("name", sorted(JAX_SCENARIOS))
def test_shard_assignments_match_jax_on_8_host_devices(weights, jax_shards,
                                                       name):
    """The port on 4x1 meshes over the CPU admits each request to the
    shard the JAX engine picks on its 4x1 meshes over 8 host devices, and
    agrees on the per-shard high water, the preemptions, the prefix hits
    by shard and the streams."""
    work, mid, kw = JAX_SCENARIOS[name]
    tr = Tracer()
    eng = CascadeEngine(
        [TierSpec("fast", weights[0][FAST], weights[1][FAST],
                  mesh=_meshes(4)[0]),
         TierSpec("exp", weights[0][EXP], weights[1][EXP],
                  mesh=_meshes(4)[1])],
        deltas=[_mid_delta(weights, work) if mid else 0.5],
        clock=VirtualClock(), device="cpu", tracer=tr, **{**JAX_KW, **kw})
    eng.warmup()
    streams = [(r[0], r[1], r[2]) for r in _drain(eng, WORK[work])]
    got = shard_record(tr.events(), eng.memory_stats(),
                       eng.metrics.summary(), streams)
    got = json.loads(json.dumps(got))           # tuples as JSON lists
    assert got == json.loads(json.dumps(jax_shards[name]))
    shards = {s for _, _, s in got["prefill"]}
    assert len(shards) > 1                      # admission spreads
    assert {r[2] for r in streams} == ({0, 1} if mid else {1})
    if name == "youngest":
        assert sum(got["preemptions"]) > 0
    if name == "prefix":
        assert got["hits"]


# ---------------------------------------------------------------------------
# refusals, the JAX errors, the CLI's mesh flags
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flags,work", [
    ({"speculation_k": 2, "spec_delta": 0.0, "flat_buckets": [64]},
     "lognormal"),
    ({"use_paged_kv": False}, "uniform"),
    ({"expensive": "musicgen-large", "refused_tier_only": True}, "uniform"),
    ({"use_chunked_prefill": False}, "uniform"),
    ({"expensive": "rwkv6-3b"}, "uniform")],
    ids=["model-axis-speculation", "model-axis-dense",
         "model-axis-frontend", "model-axis-uniform", "model-axis-rwkv6"])
def test_model_axis_serves_the_lifted_cases(weights, flags, work):
    """A model axis of 2 under speculation, the dense arena or uniform
    prefill, and on a frontend or RWKV-6 tier, which the port refused
    before (``tests/test_torch_model_axis_executors.py`` holds them to
    the JAX engine): the engine builds on ``1x2`` (the frontend tier's
    only, as the refusal was) and serves the unsharded engine's
    streams."""
    flags = dict(flags)
    alone = flags.pop("refused_tier_only", False)
    if "expensive" in flags:
        name = flags.pop("expensive")
        cfg = configs_of(name)[1]
        weights = (dict(weights[0], **{EXP: cfg}),
                   dict(weights[1], **{EXP: init_params(cfg, 1,
                                                        device="cpu")}),
                   weights[2])
    meshes = _meshes(1, 2)
    if alone:
        meshes[0] = None
    eng = _engine(weights, meshes, 0.5, **flags)
    assert eng.runtimes[1].model_shards == 2
    got = _drain(eng, WORK[work])
    want = _drain(_engine(weights, None, 0.5, **flags), WORK[work])
    assert [r[:3] for r in got] == [r[:3] for r in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[3], w[3], rtol=0, atol=1e-6)
    assert eng.metrics.summary()["conservation"]["ok"]


@pytest.mark.parametrize("flags,mesh,err", [
    ({}, (1, 3), ValueError),
    ({"slots": 6}, (4, 1), ValueError),
    ({"kv_block_size": 4, "kv_blocks": 8}, (2, 1), ValueError)],
    ids=["model-axis-heads", "uneven-rows", "blocks-per-shard"])
def test_unsupported_meshes_raise(weights, flags, mesh, err):
    """A model axis that does not divide the query heads (3 of the smoke
    models' 4) raises ValueError naming the shapes; uneven rows and too
    few blocks per shard raise the JAX engine's errors (the pool's, held
    to JAX above).  A model axis under speculation, the dense arena or
    uniform prefill, or on a frontend or RWKV-6 tier, serves:
    :func:`test_model_axis_serves_the_lifted_cases`."""
    with pytest.raises(err) as e:
        _engine(weights, _meshes(*mesh), 0.5, **flags)
    msg = str(e.value)
    if mesh[1] > 1:
        assert msg == ("gemma3-1b-smoke: a model axis of 3 has no "
                       "head-parallel layout for 4 query heads and 1 KV "
                       "heads (it must divide the query heads, and divide "
                       "or be a multiple of the KV heads)")
    elif "slots" in flags:
        # the scheduler's row allocator refuses first, in both engines
        assert msg == "capacity 6 must divide into 4 shards"
    else:
        assert "cannot hold one full request per shard" in msg


def test_parse_mesh_shape_and_tier_meshes_match_jax():
    for s in ("4x2", "4", "1", "2X1"):
        assert serve_async.parse_mesh_shape(s) == \
            jax_serve_async.parse_mesh_shape(s)
    args = Namespace(tier_mesh=None, device="cpu")
    assert serve_async.tier_meshes(args, 2) == [None, None]
    args.tier_mesh = ["2x1"]
    meshes = serve_async.tier_meshes(args, 2)
    assert [m.shape for m in meshes] == [{"data": 2, "model": 1}] * 2
    assert [data_axis_size(m) for m in meshes] == [2, 2]
    assert meshes[0].data_devices() == [CPU, CPU]
    args.tier_mesh = ["1", "2x1", "1"]
    for pkg in (serve_async, jax_serve_async):
        with pytest.raises(ValueError) as err:
            pkg.tier_meshes(args, 2)
        assert str(err.value) == "--tier-mesh takes 1 or 2 shapes, got 3"
    with pytest.raises(ValueError) as err:
        mesh_lib.make_tier_meshes([(2, 1)], [CPU])
    assert str(err.value) == "tier mesh 2x1 needs 2 devices, only 1 available"
    # contiguous assignment, wrapping to device 0 when tiers overrun
    devs = [torch.device("cuda", i) for i in range(3)]
    got = mesh_lib.make_tier_meshes([(2, 1), (2, 1)], devs)
    assert [[d.index for d in m.devices.flat] for m in got] == [[0, 1],
                                                                 [0, 1]]
    got = mesh_lib.make_tier_meshes([(1, 1), (2, 1)], devs)
    assert [[d.index for d in m.devices.flat] for m in got] == [[0], [1, 2]]


def test_cli_tier_mesh_on_cpu(capsys):
    """``--device cpu --tier-mesh 2x1 2x1``: the report's mesh line, the
    summary's ``tier_meshes``, and the unmeshed run's streams."""
    flags = ["--device", "cpu", "--requests", "6", "--slots", "4",
             "--prompt-len", "16", "--gen-len", "3", "--virtual-clock",
             "--length-dist", "lognormal", "--delta", "0.5"]
    runs = {}
    for mesh in ([], ["--tier-mesh", "2x1", "2x1"]):
        args = serve_async.make_parser().parse_args(flags + mesh)
        runs[bool(mesh)] = s = serve_async.run(args, VirtualClock())
        serve_async.report(s)
    out = capsys.readouterr().out
    assert "meshes gemma3-1b={'data': 2, 'model': 1}" in out
    assert runs[True]["tier_meshes"][1] == {
        "tier": EXP, "mesh": {"data": 2, "model": 1}, "devices": 2,
        "device_ids": [None, None], "data_shards": 2, "shard_params": False}
    assert runs[False]["tier_meshes"][0]["mesh"] is None
    assert runs[True]["stream_checksum"] == runs[False]["stream_checksum"]
    assert [m["data_shards"] for m in runs[True]["kv_arena"]] == [2, 2]
