"""The overload and failure layer of the torch port against the JAX
package, on the CPU: preemption with replay, deadline shedding, bounded
launch retry and the deterministic ``FaultPlan`` harness.

Case for case with ``tests/test_faults.py``, on the same weights (gemma3
smoke, PRNGKey 0 for tier 0 and 1 for tier 1), prompts and fault plans:
the port's and the JAX engine's streams, terminal states, victims (the
preempted, failed and shed rids) and every overload counter are equal,
the two plans' logs record the same faults at the same ticks, and
conservation holds in every run.  Inside the port the chaos oracles of
the JAX suite hold as well: every surviving stream equals the fault-free
run's.  The fault-free references are checked against JAX under the
margin rule (at every emitted step the port's logits within 1e-4 of
JAX's and the top-1/top-2 margin over twice that).

Then the parts: ``FaultPlan`` parsing and draws against
``repro.serving.faults``, the pool's shrink caps and the allocator's
withheld blocks (the JAX suite's random-operation driver with shrink,
replayed through the JAX pool answer for answer), the scheduler's
requeue, shedding and forced decisions, the retry wrapper's choice of
transient errors, and the CLI's flags.  Each JAX run is made once and
shared by the module.
"""
import os
import random

import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.launch import serve_async as jax_serve_async  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.serving import CascadeEngine as JaxEngine  # noqa: E402
from repro.serving import TierSpec as JaxTierSpec  # noqa: E402
from repro.serving import faults as jax_faults  # noqa: E402
from repro.serving import scheduler as jax_scheduler  # noqa: E402
from repro.serving.engine import VirtualClock as JaxVirtualClock  # noqa: E402
from repro.serving.request import Request as JaxRequest  # noqa: E402
from repro.serving.slots import TierSlotPool as JaxPool  # noqa: E402
from repro_torch.launch import serve_async  # noqa: E402
from repro_torch.models.params import from_jax  # noqa: E402
from repro_torch.serving import (CascadeEngine, FaultPlan,  # noqa: E402
                                 Request, RequestState, TierSlotPool,
                                 TierSpec, TransientError)
from repro_torch.serving import engine as engine_mod  # noqa: E402
from repro_torch.serving import faults  # noqa: E402
from repro_torch.serving import scheduler  # noqa: E402
from repro_torch.serving.engine import VirtualClock  # noqa: E402
from repro_torch.serving.request import TERMINAL_STATES  # noqa: E402
from tests.test_slots_properties import (BS, CAPACITY, CHUNK,  # noqa: E402
                                         MAX_SEQ, Driver, check_invariants)
from tests.test_torch_model import configs_of  # noqa: E402
from tests.test_torch_prefix_cache import _assert_margins  # noqa: E402
from tests.test_torch_serving import (_tap_jax_logits,  # noqa: E402
                                      _tap_torch_rows)
from tests.torch_one_thread import one_torch_thread  # noqa: E402,F401

FAST = "gemma3-1b"
PACKAGES = {"jax": jax_faults, "torch": faults}


# ---------------------------------------------------------------------------
# FaultPlan: parsing and determinism, against the JAX package
# ---------------------------------------------------------------------------

SPECS = ["seed=7,shrink=5:0:8:40,storm=10-14:1,launch=0.05:2,launchat=3:1:4,"
         "slow=0.1:0.01", "shrink=1:0:4,storm=2-3,launchat=5:0",
         "seed=3,launch=0.2", ""]


@pytest.mark.parametrize("spec", SPECS)
def test_fault_plan_parse_matches_jax(spec):
    got, want = FaultPlan.parse(spec), jax_faults.FaultPlan.parse(spec)
    assert got.describe() == want.describe()
    assert [tuple(vars(s).values()) for s in got.shrinks + got.storms] \
        == [tuple(vars(s).values()) for s in want.shrinks + want.storms]
    if spec.startswith("seed=7"):
        assert got.shrinks == (faults.Shrink(5, 0, 8, 40),)
        assert got.storms == (faults.Storm(10, 14, 1),)
        assert got.fail_launches == {(3, 1): 4}


@pytest.mark.parametrize("bad", [
    "frobnicate=1", "shrink=1:2", "storm=5", "slow=0.5", "launch",
])
def test_fault_plan_parse_rejects_as_jax(bad):
    with pytest.raises(ValueError) as got:
        FaultPlan.parse(bad)
    with pytest.raises(ValueError) as want:
        jax_faults.FaultPlan.parse(bad)
    assert str(got.value) == str(want.value)


def test_fault_plan_draws_and_kind_codes_match_jax():
    """The kind codes are JAX's (run_ragged and run_spec draw as code 0),
    and a seeded plan's draws and probabilistic launch faults are JAX's,
    key for key, whatever the call order."""
    assert faults._KIND_CODES == jax_faults._KIND_CODES
    keys = [(1, 0, 1), (9, 1, 5), (1, 0, 1), (2, 0, 3), (7, 1, 0)]
    for seed in (0, 3, 11):
        a, b = FaultPlan(seed=seed), jax_faults.FaultPlan(seed=seed)
        assert [a._draw(*k) for k in keys] \
            == [b._draw(*k) for k in reversed(keys)][::-1]
    kinds = ("run_ragged", "run_spec", "run_mixed", "run_chunk", "run_step",
             "run_prefill", "device_get")
    logs = []
    for mod in (faults, jax_faults):
        plan = mod.FaultPlan(seed=5, launch_fail_prob=0.3,
                             launch_fail_attempts=2)
        for tick in range(1, 40):
            for tier in (0, 1):
                for kind in kinds:
                    for attempt in range(3):
                        try:
                            plan.pre_launch(tick, tier, kind, attempt)
                        except mod.TransientError:
                            pass
        logs.append(plan.log)
    assert logs[0] == logs[1] and len(logs[0]) > 0
    assert {e[2]["kind"] for e in logs[0]} >= {"run_ragged", "run_spec"}


def test_fault_plan_targets_storms_and_slow_ticks():
    p = FaultPlan(fail_launches={(2, 0): 2},
                  storms=(faults.Storm(5, 8, gate=1),),
                  slow_tick_prob=1.0, slow_tick_seconds=0.0)
    for attempt in (0, 1):
        with pytest.raises(TransientError):
            p.pre_launch(2, 0, "run_ragged", attempt)
    p.pre_launch(2, 0, "run_ragged", 2)     # attempts exhausted: passes
    p.pre_launch(3, 0, "run_ragged", 0)     # other ticks untouched
    assert [p.force_escalation(t, 1) for t in (4, 5, 7, 8)] \
        == [None, True, True, None]         # end-exclusive
    assert p.force_escalation(6, 0) is None
    p.begin_tick(1, None)                   # no shrink: no engine read
    assert [e[1] for e in p.log] == ["launch_fault", "launch_fault", "slow"]
    assert issubclass(TransientError, RuntimeError)


# ---------------------------------------------------------------------------
# the pool: withheld blocks and the shrink caps
# ---------------------------------------------------------------------------


def _pools(num_blocks=13, capacity=4, max_seq=16):
    jcfg, cfg = configs_of(FAST)
    return (TierSlotPool(cfg, capacity, max_seq, block_size=4,
                         num_blocks=num_blocks, device="cpu"),
            JaxPool(jcfg, capacity, max_seq, block_size=4,
                    num_blocks=num_blocks))


def test_shrink_caps_match_jax():
    """The JAX suite's cases on both pools: the floor cap (one full
    request's blocks stay usable), the reserve cap (the oldest row's
    worst-case demand stays free), partial shrinks and restores."""
    for pool in _pools():
        pool.bind(0, 4, row_tokens=16)      # oldest: holds 1, demands 3 more
        assert pool.shrink(100) == 8
        assert pool.blocks.reserved_in(0) == 8
        assert pool.ensure_blocks(0, 15)    # the oldest still grows fully
        assert pool.unshrink() == 8
        assert pool.shrink(2) == 2
        assert pool.unshrink() == 2
        assert pool.blocks.reserved_in(0) == 0
    for pool in _pools():
        pool.shrink(100)                    # empty pool: the floor binds
        assert pool.blocks.num_free >= pool.pages_per_row
        assert pool.can_admit(16)
        pool.unshrink()


def test_withheld_blocks_are_neither_free_nor_live():
    pool, ref = _pools()
    for p in (pool, ref):
        assert p.blocks.reserve(3) == 3
    assert pool.blocks._reserved == ref.blocks._reserved
    assert pool.blocks._free == ref.blocks._free
    b = pool.blocks._reserved[0][0]
    with pytest.raises(ValueError, match="double free"):
        pool.blocks.free(b)
    with pytest.raises(ValueError, match="cannot share"):
        pool.blocks.ref(b)
    assert pool.blocks.refcount(b) == 0
    assert pool.blocks.restore() == ref.blocks.restore() == 3
    assert pool.blocks._free == ref.blocks._free
    check_invariants(pool)


def _full_pool(package, oversub):
    jcfg, cfg = configs_of(FAST)
    full = CAPACITY * (MAX_SEQ // BS) + 1
    nb = full // 2 + 1 if oversub else full
    if package == "jax":
        return JaxPool(jcfg, CAPACITY, MAX_SEQ, block_size=BS,
                       num_blocks=nb, prefix_chunk=CHUNK)
    return TierSlotPool(cfg, CAPACITY, MAX_SEQ, block_size=BS, num_blocks=nb,
                        prefix_chunk=CHUNK, device="cpu")


def _pool_state(pool) -> dict:
    return dict(refcount=dict(pool.blocks._refcount),
                free=list(pool.blocks._free[0]),
                withheld=list(pool.blocks._reserved[0]),
                index={k: (e.ntokens, list(e.blocks), e.last_use)
                       for k, e in pool._index[0].items()},
                page_table=pool.page_table.tolist(),
                rows=[list(r) for r in pool._row_blocks],
                order=list(pool._order))


RECORDED = ("match_prefix", "publish_prefix", "can_admit", "bind",
            "ensure_blocks", "release", "_reclaim", "shrink", "unshrink")


@pytest.mark.parametrize("oversub", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_pool_driver_with_shrink_matches_jax(seed, oversub):
    """The JAX suite's random-operation driver, shrink and unshrink
    included, on the port's pool under the invariant checker; every call
    replayed on the JAX pool gives the same answer (or error) and leaves
    the same free, withheld and live blocks, index and page tables."""
    pool = _full_pool("torch", oversub)
    log, depth = [], [0]
    for name in RECORDED:
        def call(*a, _fn=getattr(pool, name), _name=name, **kw):
            top = depth[0] == 0
            depth[0] += 1
            try:
                out = _fn(*a, **kw)
            except (ValueError, RuntimeError) as e:
                out = (type(e), str(e))
                raise
            finally:
                depth[0] -= 1
                if top:
                    log.append((_name, a, kw, out, _pool_state(pool)))
            return out
        setattr(pool, name, call)
    Driver(pool, random.Random(200 + seed)).run(steps=80)
    assert {"shrink", "unshrink", "bind", "release"} <= {e[0] for e in log}
    ref = _full_pool("jax", oversub)
    for name, a, kw, out, state in log:
        try:
            want = getattr(ref, name)(*a, **kw)
        except (ValueError, RuntimeError) as e:
            want = (type(e), str(e))
        assert want == out, (name, a, kw)
        assert _pool_state(ref) == state, (name, a, kw)


# ---------------------------------------------------------------------------
# the scheduler: requeue, shedding and forced decisions
# ---------------------------------------------------------------------------


def _sched_reqs(cls):
    return [cls(rid=i, prompt=np.zeros(4, np.int32), gen_len=2,
                arrival_time=a, deadline=d)
            for i, (a, d) in enumerate([(0.0, None), (0.0, 5.0),
                                        (0.0, 12.0), (11.0, 14.0)])]


def test_scheduler_requeue_and_shed_match_jax():
    out = []
    for mod, cls in ((scheduler, Request), (jax_scheduler, JaxRequest)):
        sched = mod.CascadeScheduler([2, 2], [mod.GateSpec(delta=0.5)])
        reqs = _sched_reqs(cls)
        for r in reqs[:3]:
            sched.submit(r)
        sched.requeue(reqs[3], 0)                   # a preempted request
        got = [[r.rid for r in sched.queues[0]]]
        got.append([r.rid for r in sched.shed(0, now=10.0, floor=None)])
        got.append([r.rid for r in sched.queues[0]])
        got.append([r.rid for r in sched.shed(0, now=10.0,
                                              floor=lambda r: 5.0)])
        got.append([r.rid for r in sched.queues[0]])
        out.append(got)
    assert out[0] == out[1] == [[3, 0, 1, 2], [1], [3, 0, 2], [3, 2], [0]]


def test_forced_gate_decisions_stream_like_real_ones():
    """A storm's forced decision counts in the gate stats, the confidence
    window and the calibration sink, as in the JAX scheduler."""
    got = []
    for mod in (scheduler, jax_scheduler):
        sink = []

        class Sink:
            def record_gate(self, gate, conf, esc, sink=sink):
                sink.append((gate, conf, esc))
        sched = mod.CascadeScheduler([2, 2], [mod.GateSpec(delta=0.5)],
                                     calibration=Sink())
        dec = [sched.gate_decision(0, c, force=f)
               for c, f in ((0.9, None), (0.9, True), (0.1, None),
                            (0.1, False))]
        st = sched.gate_stats[0]
        got.append((dec, st.seen, st.escalated, list(sched._conf_windows[0]),
                    sink))
    assert got[0] == got[1]
    assert got[0][:3] == ([False, True, True, False], 4, 2)


# ---------------------------------------------------------------------------
# the engines: chaos cases against the JAX engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    """(JAX config, port config, [JAX weights, port weights] of tier 0
    and of tier 1): gemma3-1b smoke from PRNGKey(0) and PRNGKey(1)."""
    jcfg, cfg = configs_of(FAST)
    out = []
    for i in (0, 1):
        jp = jax.tree.map(np.asarray, jax_init_params(
            jcfg, jax.random.PRNGKey(i), jnp.float32))
        out.append((jp, from_jax(jp)))
    return jcfg, cfg, out


def _prompts(vocab, n=6, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, 12).astype(np.int32) for _ in range(n)]


def _shared_prompts(vocab, n=8, seed=0):
    """Prompts agreeing on their first 9 tokens (warm prefix-cache
    traffic) with unique 3-token tails."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, vocab, 12).astype(np.int32)
    out = []
    for _ in range(n):
        p = base.copy()
        p[9:] = rng.integers(0, vocab, 3)
        out.append(p)
    return out


def _no_faults(mod):
    return None


# case -> (tiers, prompts, engine kwargs, the fault plan from a faults
# module, the deadline): the JAX suite's cases; "ref*" are fault-free
CASES = {
    "ref": (1, _prompts, {}, _no_faults, None),
    "ref-tier1": (1, _prompts, {"tier1_weights": True}, _no_faults, None),
    "ref-shared": (1, _shared_prompts, {"slots": 4}, _no_faults, None),
    "shed": (1, _prompts, {}, _no_faults, 6.0),
    "recover": (1, _prompts, {}, lambda m: m.FaultPlan(
        fail_launches={(2, 0): 2}), None),
    "exhaust-ragged": (1, _prompts, {}, lambda m: m.FaultPlan(
        fail_launches={(2, 0): 99}), None),
    "exhaust-split-step": (1, _prompts, {"use_unified_step": False},
                           lambda m: m.FaultPlan(fail_launches={(4, 0): 3}),
                           None),
    "exhaust-uniform-prefill": (1, _prompts, {
        "use_chunked_prefill": False, "prompt_len": 12},
        lambda m: m.FaultPlan(fail_launches={(1, 0): 3}), None),
    "storm": (2, _prompts, {"deltas": [0.0]}, lambda m: m.FaultPlan(
        storms=(m.Storm(1, 1000, 0),)), None),
    "combo": (2, _prompts, dict(slots=4, kv_blocks=[14, None],
                                preemption_policy="youngest"),
              lambda m: m.FaultPlan(seed=11, shrinks=(m.Shrink(
                  tick=3, tier=0, blocks=6, restore_tick=9),),
                  storms=(m.Storm(4, 7, 0),), launch_fail_prob=0.2), None),
    "prefix-preemption": (1, _shared_prompts, dict(
        slots=4, kv_blocks=16, prefix_cache=True,
        preemption_policy="youngest"), _no_faults, None),
    "prefix-combo": (2, _shared_prompts, dict(
        slots=4, kv_blocks=[14, None], prefix_cache=True,
        preemption_policy="youngest"), lambda m: m.FaultPlan(
            seed=11, shrinks=(m.Shrink(tick=3, tier=0, blocks=6,
                                       restore_tick=9),),
            storms=(m.Storm(4, 7, 0),), launch_fail_prob=0.2), None),
    "spec-chaos": (2, _prompts, dict(
        slots=4, kv_blocks=[14, 14], deltas=[1.0],
        preemption_policy="youngest", speculation_k=4, spec_delta=0.0),
        lambda m: m.FaultPlan(seed=7, shrinks=(
            m.Shrink(tick=3, tier=0, blocks=5, restore_tick=9),
            m.Shrink(tick=5, tier=1, blocks=5, restore_tick=11))), None),
}
EXECUTORS = {"ragged": {}, "padded": {"use_ragged_step": False},
             "split": {"use_unified_step": False}}
for _ex, _flags in EXECUTORS.items():
    for _policy in ("youngest", "fewest-tokens"):
        CASES[f"preempt-{_policy}-{_ex}"] = (
            1, _prompts, dict(slots=4, kv_blocks=14,
                              preemption_policy=_policy, **_flags),
            _no_faults, None)


_JITS: dict = {}


def _share_jits(eng) -> None:
    """Hand a JAX engine the jitted step functions of the module's
    earlier engines of the same model and arena kind: the same closures
    over the same config, so each shape compiles once per module instead
    of once per engine (the reference computes exactly what it would
    with its own)."""
    for rt in eng.runtimes:
        fns = _JITS.setdefault((rt.spec.cfg.name, rt.paged, rt.spec_k,
                                rt.spec_draft), {})
        for name in ("prefill_fn", "step_fn", "chunk_fn", "mixed_fn",
                     "ragged_fn", "spec_fn"):
            if getattr(rt, name) is not None:
                setattr(rt, name, fns.setdefault(name, getattr(rt, name)))


def _engine(weights, package, tiers, faults_plan=None, **kw):
    jcfg, cfg, w = weights
    kw = dict(kw)
    first = w[1] if kw.pop("tier1_weights", False) else w[0]
    tw = [first, w[1]][:tiers]
    kw.setdefault("retry_backoff", 0.0)
    kw.setdefault("slots", 2)
    kw.setdefault("prompt_len", 16)
    kw.setdefault("gen_len", 4)
    kw.setdefault("prefill_chunk", 8)
    kw.setdefault("kv_block_size", 4)
    if tiers == 2:
        kw.setdefault("deltas", [0.5])
    names = ["fast", "exp"][:tiers]
    if package == "jax":
        return JaxEngine([JaxTierSpec(n, jcfg, p[0]) for n, p in
                          zip(names, tw)], clock=JaxVirtualClock(),
                         faults=faults_plan, **kw)
    return CascadeEngine([TierSpec(n, cfg, p[1]) for n, p in zip(names, tw)],
                         clock=VirtualClock(), faults=faults_plan,
                         device="cpu", **kw)


def _drain(eng, prompts, deadline=None, max_steps=500):
    for p in prompts:
        eng.submit(p, arrival_time=0.0, deadline=deadline)
    s = eng.run(max_steps=max_steps)
    terminal = {t.name for t in TERMINAL_STATES}
    assert all(r.state.name in terminal for r in eng.requests)
    assert s["conservation"]["ok"], s["conservation"]
    return s


@pytest.fixture(scope="module")
def served(weights):
    """(package, case) -> run, each made once on first use: the engine,
    its summary, its fault plan and, for the fault-free references, the
    per-launch logits (and the port's emitted rows) of the margin
    check."""
    runs = {}

    def get(package, case):
        if (package, case) in runs:
            return runs[(package, case)]
        tiers, make, kw, plan_of, deadline = CASES[case]
        plan = plan_of(PACKAGES[package])
        eng = _engine(weights, package, tiers, plan, **kw)
        out = {"engine": eng, "plan": plan}
        # a tapped run traces its own functions (the taps enter at trace
        # time); the others share theirs
        tap = case.startswith("ref")
        if package == "jax" and not tap:
            _share_jits(eng)
        prompts = make(weights[1].vocab_size)
        if package == "jax":
            with pytest.MonkeyPatch.context() as mp:
                logits = _tap_jax_logits(mp, [tap]) if tap else None
                out["summary"] = _drain(eng, prompts, deadline)
                jax.effects_barrier()
            out["logits"] = logits
        else:
            if tap:
                out["logits"], out["emitted"] = _tap_torch_rows(eng)
            out["summary"] = _drain(eng, prompts, deadline)
        runs[(package, case)] = out
        return out
    return get


def _streams(eng):
    return {r.rid: (tuple(r.tokens), r.tier, r.state.name,
                    tuple(tuple(t) for t in r.tokens_by_tier))
            for r in eng.requests}


OVERLOAD_KEYS = ("submitted", "completed", "steps", "shed_by_tier",
                 "failed_by_tier", "preemptions_by_tier",
                 "replayed_tokens_by_tier", "launch_retries_by_tier",
                 "conservation", "tier_requests", "escalation_rates")


def _assert_matches_jax(mine, ref):
    """Streams, states and routing, the victims (preemptions per request)
    and every overload counter equal the JAX run's; confidences within
    1e-8; the fault plans logged the same faults at the same ticks."""
    eng, jeng = mine["engine"], ref["engine"]
    assert _streams(eng) == _streams(jeng)
    assert {r.rid: r.preemptions for r in eng.requests} \
        == {r.rid: r.preemptions for r in jeng.requests}
    for a, b in zip(eng.requests, jeng.requests):
        np.testing.assert_allclose(a.token_conf, b.token_conf, atol=1e-8,
                                   rtol=0)
    for key in OVERLOAD_KEYS:
        assert mine["summary"][key] == ref["summary"][key], key
    if mine["plan"] is not None:
        assert mine["plan"].log == ref["plan"].log
    assert serve_async.stream_checksum(eng) == \
        jax_serve_async.stream_checksum(jeng)


@pytest.mark.parametrize("case", ["ref", "ref-tier1", "ref-shared"])
def test_fault_free_references_match_jax_under_the_margin_rule(served,
                                                               case):
    mine, ref = served("torch", case), served("jax", case)
    assert _streams(mine["engine"]) == _streams(ref["engine"])
    _assert_margins(mine, ref)


@pytest.mark.parametrize("policy", ["youngest", "fewest-tokens"])
@pytest.mark.parametrize("executor", sorted(EXECUTORS))
def test_preemption_replays_match_jax(served, executor, policy):
    """4 rows on a 14-block arena (5 pages a row): rows stall, and the
    policy evicts and replays instead; the same victims as JAX, the same
    preemptions and replayed tokens, and every stream the fault-free
    run's."""
    case = f"preempt-{policy}-{executor}"
    mine, ref = served("torch", case), served("jax", case)
    _assert_matches_jax(mine, ref)
    s, eng = mine["summary"], mine["engine"]
    assert s["preemptions"] > 0 and s["replayed_tokens"] > 0
    assert s["completed"] == 6 and s["failed"] == 0
    base = _streams(served("torch", "ref")["engine"])
    assert {k: v[0] for k, v in _streams(eng).items()} \
        == {k: v[0] for k, v in base.items()}
    check_invariants(eng.runtimes[0].pool)


def test_preemption_requires_chunked_paged_path(weights):
    for flags, match in (({"use_paged_kv": False,
                           "preemption_policy": "youngest"}, "preemption"),
                         ({"preemption_policy": "oldest"},
                          "preemption_policy"),
                         ({"launch_retries": -1}, "launch_retries")):
        with pytest.raises(ValueError, match=match) as got:
            _engine(weights, "torch", 1, **flags)
        with pytest.raises(ValueError) as want:
            _engine(weights, "jax", 1, **flags)
        assert str(got.value) == str(want.value)


def test_deadline_shedding_sheds_the_same_rids(served):
    mine, ref = served("torch", "shed"), served("jax", "shed")
    _assert_matches_jax(mine, ref)
    s = mine["summary"]
    shed = [r.rid for r in mine["engine"].requests
            if r.state is RequestState.SHED]
    assert shed and s["shed"] == len(shed) and s["completed"] > 0
    assert s["shed"] + s["completed"] == s["submitted"] == 6
    assert 0.0 < s["shed_rate"] < 1.0


@pytest.mark.parametrize("case", ["recover", "exhaust-ragged",
                                  "exhaust-split-step",
                                  "exhaust-uniform-prefill"])
def test_launch_retries_match_jax(served, case):
    """Two failing attempts under the budget of two retries recover
    invisibly; persistent failures at a unified launch, a split
    ``run_step`` and a uniform ``run_prefill`` fail the same rids as
    the JAX engine, and every survivor's stream is the fault-free
    one."""
    mine, ref = served("torch", case), served("jax", case)
    _assert_matches_jax(mine, ref)
    s, eng = mine["summary"], mine["engine"]
    assert s["launch_retries"] > 0
    kinds = {e[2]["kind"] for e in mine["plan"].log}
    failed = [r.rid for r in eng.requests if r.state is RequestState.FAILED]
    if case == "recover":
        assert not failed and s["completed"] == 6
        base = _streams(served("torch", "ref")["engine"])
        assert _streams(eng) == base
        return
    assert failed and s["failed"] == len(failed)
    assert s["failed"] + s["completed"] == 6
    want_kind = {"exhaust-ragged": "run_ragged",
                 "exhaust-split-step": "run_step",
                 "exhaust-uniform-prefill": "run_prefill"}[case]
    assert kinds == {want_kind}
    if case != "exhaust-uniform-prefill":
        base = _streams(served("torch", "ref")["engine"])
        assert all(base[r.rid][0] == tuple(r.tokens) for r in eng.requests
                   if r.state is RequestState.DONE)


def _fetch_faults(mod, tick=3):
    """A plan whose fetches (kind ``device_get``) fail at `tick` on every
    attempt, and nothing else."""
    class FetchFaults(mod.FaultPlan):
        def pre_launch(self, t, tier, kind, attempt):
            if kind == "device_get" and t == tick:
                self.log.append((t, "launch_fault", {"kind": kind,
                                                     "attempt": attempt}))
                raise mod.TransientError(f"injected fetch failure at {t}")
    return FetchFaults()


def test_fetch_retry_exhaustion_stops_the_engine_as_jax(weights):
    """A fetch whose retries run out stops the engine in both packages
    (the tick's results are lost without it), after the same attempts."""
    got = []
    for package in ("torch", "jax"):
        plan = _fetch_faults(PACKAGES[package])
        eng = _engine(weights, package, 1, plan)
        for p in _prompts(512):
            eng.submit(p)
        with pytest.raises(RuntimeError, match="retries exhausted in "
                                               "device_get") as exc:
            eng.run(max_steps=50)
        assert type(exc.value).__name__ == "_RetryExhausted"
        got.append((plan.log, eng.metrics.retries_by_tier, eng.tick_id,
                    {r.rid: r.state.name for r in eng.requests}))
    assert got[0] == got[1]
    assert len(got[0][0]) == 3              # the attempt and two retries


def test_storm_forces_routing_not_tokens(served):
    mine, ref = served("torch", "storm"), served("jax", "storm")
    _assert_matches_jax(mine, ref)
    eng, s = mine["engine"], mine["summary"]
    base = _streams(served("torch", "ref")["engine"])
    assert all(r.tier == 1 for r in eng.requests)
    assert all(tuple(r.tokens_by_tier[0]) == base[r.rid][0]
               for r in eng.requests)
    assert s["completed"] == 6 and s["escalation_rates"][0] == 1.0


@pytest.mark.parametrize("case", ["combo", "prefix-combo"])
def test_combined_chaos_matches_jax(served, case):
    """Shrink, storm and probabilistic launch faults at once on two
    tiers with an over-subscribed tier-0 arena and preemption (and the
    prefix cache in both tiers): the JAX run's faults, victims and
    streams, every tier-0 stream the fault-free one, the pools
    consistent at drain."""
    mine, ref = served("torch", case), served("jax", case)
    _assert_matches_jax(mine, ref)
    s, eng = mine["summary"], mine["engine"]
    n = len(eng.requests)
    assert s["completed"] + s["failed"] == n
    assert s["launch_retries"] > 0 and len(mine["plan"].log) > 0
    assert any(e[1] == "shrink" for e in mine["plan"].log)
    base = _streams(served("torch", "ref" if case == "combo"
                           else "ref-shared")["engine"])
    assert all(tuple(r.tokens_by_tier[0]) == base[r.rid][0]
               for r in eng.requests)
    for rt in eng.runtimes:
        check_invariants(rt.pool)


def test_preemption_storm_against_warm_prefix_cache(served):
    """Preemption churn on an over-subscribed arena with the cache on:
    the victim's published entries stay indexed (the refcounted release
    keeps them), the replays re-hit them, and every stream is the
    cache-off fault-free one — as in the JAX engine."""
    mine = served("torch", "prefix-preemption")
    _assert_matches_jax(mine, served("jax", "prefix-preemption"))
    s, eng = mine["summary"], mine["engine"]
    assert s["completed"] == 8 and s["failed"] == 0
    assert s["prefix_cache"]["hits"] > 0 and s["preemptions"] > 0
    base = _streams(served("torch", "ref-shared")["engine"])
    assert _streams(eng) == base
    check_invariants(eng.runtimes[0].pool)


def test_speculation_chaos_matches_k0_oracle(served, weights):
    """k = 4 under shrinkage on both over-subscribed arenas and
    preemption churn: streams and terminal states equal the k = 0 run
    under the same plan, the pools stay consistent, and no draft row
    outlives the drain.  (Port only: the JAX engine's k = 4 run in
    interpret mode would take a fifth of this file's time; its
    speculation parity is ``tests/test_torch_spec_decode.py``'s.)"""
    mine = served("torch", "spec-chaos")
    tiers, make, kw, plan_of, _ = CASES["spec-chaos"]
    kw = {k: v for k, v in kw.items()
          if k not in ("speculation_k", "spec_delta")}
    plan0 = plan_of(faults)
    oracle = _engine(weights, "torch", tiers, plan0, **kw)
    s0 = _drain(oracle, make(weights[1].vocab_size))
    assert s0["completed"] == 6
    eng, s = mine["engine"], mine["summary"]
    assert {k: v[:3] for k, v in _streams(eng).items()} \
        == {k: v[:3] for k, v in _streams(oracle).items()}
    assert s["completed"] == 6 and s["failed"] == 0
    assert s["preemptions"] > 0
    sp = s["speculation"]
    assert sp["drafted"] > 0 and sp["drafted"] == sp["accepted"] \
        + sp["rolled_back"]
    for plan in (mine["plan"], plan0):
        assert any(e[1] == "shrink" for e in plan.log)
    for rt in eng.runtimes:
        check_invariants(rt.pool)
        assert all(r is None for r in rt.draft_req)


def test_fault_determinism_same_seed_same_run(weights):
    def chaos():
        plan = FaultPlan(seed=5, launch_fail_prob=0.3,
                         shrinks=(faults.Shrink(tick=2, tier=0, blocks=4,
                                                restore_tick=6),))
        eng = _engine(weights, "torch", 1, plan, slots=4, kv_blocks=14,
                      preemption_policy="fewest-tokens")
        s = _drain(eng, _prompts(512))
        return _streams(eng), plan.log, s["preemptions"], \
            s["launch_retries"]
    assert chaos() == chaos()


# ---------------------------------------------------------------------------
# the retry wrapper catches injected transient errors only
# ---------------------------------------------------------------------------


def test_transient_errors_are_the_injected_kind_only():
    assert engine_mod._transient_error_types() == (TransientError,)


@pytest.mark.parametrize("error", [RuntimeError, torch.cuda.OutOfMemoryError])
def test_launcher_errors_propagate_unretried(weights, error):
    """A refused launch (``kernels.check_launch`` raises a plain
    ``RuntimeError``) or a CUDA error is not transient: it leaves the
    engine on its first attempt, with no retry counted and no request
    failed."""
    eng = _engine(weights, "torch", 1)
    calls = []

    def refuse(*a, **kw):
        calls.append(1)
        raise error("launch refused")
    eng.runtimes[0].run_ragged = refuse
    for p in _prompts(512):
        eng.submit(p)
    with pytest.raises(error, match="launch refused") as exc:
        eng.run(max_steps=10)
    assert type(exc.value) is error
    assert len(calls) == 1
    assert eng.metrics.retries_by_tier == [0]
    assert eng.metrics.failed_by_tier == [0]


def test_drain_failure_reports_diagnostics(weights):
    eng = _engine(weights, "torch", 1, kv_blocks=9, prefix_cache=True)
    eng.runtimes[0].pool.shrink(1)
    for p in _prompts(512, n=3):
        eng.submit(p)
    with pytest.raises(RuntimeError) as exc:
        eng.run(max_steps=1)
    msg = str(exc.value)
    assert "did not drain" in msg
    for key in ("queued=", "live_rows=", "stalled_rows=",
                "free_blocks_by_shard=", "withheld_by_shard=[1]",
                "prefix_entries_by_shard=", "evictable_by_shard="):
        assert key in msg, key


# ---------------------------------------------------------------------------
# the serve_async CLI: overload flags and KeyboardInterrupt
# ---------------------------------------------------------------------------


class _InterruptingClock(VirtualClock):
    """Raises KeyboardInterrupt after `ticks` engine steps."""

    def __init__(self, ticks):
        super().__init__()
        self._left = ticks

    def step_done(self):
        super().step_done()
        self._left -= 1
        if self._left <= 0:
            raise KeyboardInterrupt


CLI = ["--requests", "8", "--rate", "4", "--slots", "2", "--prompt-len",
       "16", "--gen-len", "4", "--prefill-chunk", "8", "--kv-block-size",
       "4", "--expensive", "gemma3-1b", "--virtual-clock", "--retry-backoff",
       "0"]
OVERLOAD = ["--kv-blocks", "14", "--preemption", "youngest", "--deadline",
            "64", "--inject-faults", "launchat=3:0:1"]


def test_serve_async_overload_flags(capsys):
    """The overload flags set the engine, the summary records the policy,
    the deadline and the plan, and the report prints the overload
    line."""
    s = serve_async.run(serve_async.make_parser().parse_args(
        ["--device", "cpu"] + CLI + OVERLOAD), VirtualClock())
    want = jax_serve_async.make_parser().parse_args(CLI + OVERLOAD)
    got = serve_async.make_parser().parse_args(CLI + OVERLOAD)
    for key in ("preemption", "deadline", "launch_retries",
                "retry_backoff", "inject_faults"):
        assert getattr(got, key) == getattr(want, key), key
    assert s["conservation"]["ok"] and not s["interrupted"]
    assert s["preemption_policy"] == "youngest" and s["deadline"] == 64.0
    assert s["faults"] == FaultPlan.parse("launchat=3:0:1").describe()
    assert s["faults"]["fail_launches"] == {"3:0": 1}
    assert s["fault_events"] >= 1 and s["launch_retries"] >= 1
    capsys.readouterr()
    serve_async.report(s)
    out = capsys.readouterr().out
    assert "overload [youngest]" in out and "conservation ok" in out


def test_serve_async_keyboard_interrupt_partial_summary(capsys):
    s = serve_async.run(serve_async.make_parser().parse_args(
        ["--device", "cpu"] + CLI), _InterruptingClock(4))
    assert s["interrupted"]
    assert s["completed"] < 8                  # stopped mid-run
    assert not s["conservation"]["ok"]
    serve_async.report(s)
    out = capsys.readouterr().out
    assert "interrupted at t=" in out
    assert "conservation interrupted" in out
