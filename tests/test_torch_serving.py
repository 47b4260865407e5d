"""The torch port's serving layer against the JAX package, on the CPU.

Unit cases for the allocators, the slot pool (audited by the JAX suite's
own invariant checker) and the scheduler, then **stream parity**: the JAX
``CascadeEngine`` and the port's engine serve the same workloads on the
same weights (``from_jax``) under a ``VirtualClock`` at a fixed δ, and
must agree on ``stream_checksum`` — every request's final tier, state
and token stream.  The smoke weights are used as initialised (nothing is
rescaled); because their logits are nearly flat, the test also asserts
that at every emitted step the port's top-1/top-2 logit margin is more
than twice the measured difference between the two packages' logits, so
the equal argmaxes are not luck.  The expensive tier is phi4-mini-3.8b,
the MoE granite-moe-3b-a800m, whose routing also sees the padding
slots, so the port's padding token ids must be the JAX engine's, or the
recurrent rwkv6-3b or the Mamba + attention + MoE hybrid jamba-v0.1-52b
(its smoke variant, and a narrow 8-layer period with its attention
layer), which both engines serve on the uniform one-shot prefill path
(as they serve phi4 under ``use_chunked_prefill=False`` and over the
dense arena, ``use_paged_kv=False``).
"""
import functools
import os

import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.launch import serve_async as jax_serve_async  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import transformer as jax_transformer  # noqa: E402
from repro.serving import CascadeEngine as JaxEngine  # noqa: E402
from repro.serving import TierSpec as JaxTierSpec  # noqa: E402
from repro.serving import CascadeScheduler as JaxScheduler  # noqa: E402
from repro.serving.slots import DenseTierSlotPool as JaxDensePool  # noqa: E402
from repro.serving.slots import TierSlotPool as JaxPool  # noqa: E402
from repro.serving import GateSpec as JaxGateSpec  # noqa: E402
from repro.serving.engine import VirtualClock as JaxVirtualClock  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.server import delta_for_escalation_rate  # noqa: E402
from repro_torch.data import bigram_lm  # noqa: E402
from repro_torch.launch import serve_async  # noqa: E402
from repro_torch.models.params import from_jax  # noqa: E402
from repro_torch.serving import (BlockAllocator, CascadeEngine,  # noqa: E402
                                 CascadeScheduler, GateSpec, Request,
                                 SlotAllocator, TierSlotPool, TierSpec)
from repro_torch.serving.engine import VirtualClock  # noqa: E402
from repro_torch.serving.slots import DenseTierSlotPool  # noqa: E402
from repro_torch.serving.request import RequestState  # noqa: E402
from tests.test_slots_properties import check_invariants  # noqa: E402
from tests.test_torch_model import (HYBRID, JAMBA,  # noqa: E402
                                    configs_of, with_capacity)
from tests.torch_one_thread import one_torch_thread  # noqa: E402,F401

FAST, EXP, MOE = "gemma3-1b", "phi4-mini-3.8b", "granite-moe-3b-a800m"
RWKV = "rwkv6-3b"


# ---------------------------------------------------------------------------
# allocators and the slot pool
# ---------------------------------------------------------------------------


def test_slot_allocator_exhaustion_and_reuse():
    a = SlotAllocator(3)
    got = [a.alloc() for _ in range(3)]
    assert got == [0, 1, 2] and a.alloc() is None
    a.free(got[1])
    assert a.num_free == 1 and a.alloc() == got[1]     # free-list reuse
    with pytest.raises(ValueError):
        a.free(99)                      # stray free
    a.free(got[0])
    with pytest.raises(ValueError):
        a.free(got[0])                  # double free
    assert a.utilization == 2 / 3


def test_block_allocator_null_block_and_refcounts():
    a = BlockAllocator(4)               # blocks 1..3 usable, 0 = null
    assert sorted(a.alloc() for _ in range(3)) == [1, 2, 3]
    assert a.alloc() is None
    a.ref(2)
    a.free(2)
    assert a.refcount(2) == 1 and a.num_shared == 0
    a.free(2)
    assert a.alloc() == 2 and a.high_water == 3
    with pytest.raises(ValueError):
        a.free(0)


@pytest.mark.parametrize("num_blocks", [None, 12, 9])
def test_tier_slot_pool_invariants_under_random_ops(num_blocks):
    """bind / ensure_blocks / release in a random order, over a fully
    provisioned and two over-subscribed arenas: the JAX suite's
    ``check_invariants`` audits the port's pool after every step, and the
    oldest bound row is never denied a block."""
    cfg = get_config(FAST, "smoke")
    pool = TierSlotPool(cfg, 4, 24, block_size=4, num_blocks=num_blocks,
                        device="cpu")
    rng = np.random.default_rng(0 if num_blocks is None else num_blocks)
    want = {}                           # slot -> tokens its row will need
    for _ in range(300):
        free = [s for s in range(4) if s not in want]
        op = rng.integers(3)
        if op == 0 and free:
            n = int(rng.integers(1, 9))
            if pool.can_admit(n):
                s = free[0]
                pool.bind(s, n, row_tokens=n + int(rng.integers(0, 16)))
                want[s] = n
        elif op == 1 and want:
            s = list(want)[int(rng.integers(len(want)))]
            limit = pool._row_demand[s] * pool.block_size - 1
            pos = min(want[s] + int(rng.integers(0, 6)), limit)
            if pool.ensure_blocks(s, pos):
                want[s] = max(want[s], pos + 1)
            else:
                assert pool.bound_rows()[0] != s   # oldest never stalls
        elif op == 2 and want:
            s = list(want)[int(rng.integers(len(want)))]
            pool.release(s)
            del want[s]
        check_invariants(pool)
    for s in list(want):
        pool.release(s)
    check_invariants(pool)
    assert pool.blocks.num_used == 0
    with pytest.raises(ValueError):
        pool.release(0)                 # double release


def test_tier_slot_pool_cache_is_on_the_device_and_sized():
    cfg = get_config(EXP, "smoke")
    pool = TierSlotPool(cfg, 3, 10, block_size=4, device="cpu")
    assert pool.num_blocks == 3 * 3 + 1
    k = pool.cache["period"]["block0"]["mixer"]["k"]
    assert tuple(k.shape) == (cfg.num_periods, pool.num_blocks, 4,
                              cfg.num_kv_heads, cfg.head_dim)
    st = pool.memory_stats()
    assert st["kv_bytes_per_block"] == (2 * cfg.num_layers * 4
                                        * cfg.num_kv_heads * cfg.head_dim * 4)


def _rand_part(jcfg, n, prompt, seed):
    """A random packed prefill cache ``[n, prompt, ...]`` (the JAX
    package's tree), as numpy."""
    from repro.models import cache as jax_cache
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda c: rng.standard_normal(c.shape).astype(np.float32),
        jax_cache.declare_cache(jcfg, n, prompt, jnp.float32),
        is_leaf=lambda x: isinstance(x, jax_cache.CP))


@pytest.mark.parametrize("name", [FAST, RWKV, JAMBA, HYBRID])
@pytest.mark.parametrize("paged", [True, False])
def test_write_prefill_partial_admission_matches_jax(name, paged):
    """One request admitted into row 1 of 3: the packed prefill cache's
    row 0 lands in the arena exactly as the JAX pools place it —
    attention KV through row 1's page table (paged) or at row 1's first
    positions (dense), RWKV-6 state and token-shift leaves and Mamba
    ``conv`` and ``ssm`` leaves in request row 1, sliced to the one
    admitted row."""
    jcfg, cfg = configs_of(name)
    part = _rand_part(jcfg, 3, 8, seed=4)
    if paged:
        want = JaxPool(jcfg, 3, 12, block_size=4)
        mine = TierSlotPool(cfg, 3, 12, block_size=4, device="cpu")
        for pool in (want, mine):
            pool.bind(0, 8)
            pool.bind(1, 8)
        assert (want.page_table == mine.page_table).all()
    else:
        want = JaxDensePool(jcfg, 3, 12)
        mine = DenseTierSlotPool(cfg, 3, 12, device="cpu")
    want.write_prefill([1], jax.tree.map(jnp.asarray, part))
    mine.write_prefill([1], from_jax(part), *([8] if paged else []))
    got = jax.tree_util.tree_leaves(
        jax.tree.map(np.asarray, mine.cache,
                     is_leaf=lambda x: isinstance(x, torch.Tensor)))
    ref = jax.tree_util.tree_leaves(jax.tree.map(np.asarray, want.cache))
    assert len(got) == len(ref) > 0
    for g, w in zip(got, ref):
        np.testing.assert_array_equal(g, w)
    assert any(g.any() for g in got)
    recurrent = {RWKV: ("state",), JAMBA: ("conv", "ssm"),
                 HYBRID: ("conv", "ssm")}.get(name, ())
    for leaf in recurrent:              # recurrent rows: only row 1 written
        state = mine.cache["period"]["block0"]["mixer"][leaf]
        np.testing.assert_array_equal(
            state[:, 1].numpy(),
            part["period"]["block0"]["mixer"][leaf][:, 0])
        assert not state[:, [0, 2]].any()
    assert mine.memory_stats()["kv_arena_bytes"] == (
        0 if name == RWKV else want.memory_stats()["kv_arena_bytes"])


# ---------------------------------------------------------------------------
# scheduler
# ---------------------------------------------------------------------------


def _req(rid, arrival=0.0, gen_len=2):
    return Request(rid=rid, prompt=np.zeros(4, np.int32), gen_len=gen_len,
                   arrival_time=arrival)


def test_scheduler_admits_mid_decode_and_respects_arrivals():
    sched = CascadeScheduler([2, 1], [GateSpec(delta=0.5)])
    for r in [_req(i) for i in range(3)] + [_req(3, arrival=5.0)]:
        sched.submit(r)
    got, slots = sched.admit(0, now=0.0)
    assert [r.rid for r in got] == [0, 1]
    sched.check_invariant(0.0)
    got[0].start_decode()
    got[0].emit(7, 0.9, 1.0)
    got[0].emit(7, 0.9, 2.0)
    assert not sched.gate_decision(0, got[0].gate())   # 0.9 > δ
    got[0].complete(2.0)
    sched.release(0, slots[0])
    more, more_slots = sched.admit(0, now=2.0)
    assert [r.rid for r in more] == [2] and more_slots == [slots[0]]
    assert sched.peek(0, 2.0) is None                  # tier full
    assert sched.pending == 1


def test_scheduler_token_budget_and_escalation_queue():
    sched = CascadeScheduler([4, 2], [GateSpec(delta=0.5)])
    for i in range(4):
        sched.submit(_req(i, gen_len=1))
    got, _ = sched.admit(0, 0.0, token_budget=6, token_cost=lambda r: 4,
                         admitted_before=0)
    assert [r.rid for r in got] == [0]     # the window's first always fits
    more, _ = sched.admit(0, 0.0, token_budget=6, budget_used=4,
                          token_cost=lambda r: 1, admitted_before=1)
    assert [r.rid for r in more] == [1, 2]     # 4 + 1 + 1 fills the 6
    last, _ = sched.admit(0, 0.0, token_budget=6, token_cost=lambda r: 1,
                          admitted_before=0)
    assert [r.rid for r in last] == [3]
    for r in got + more + last:
        slot = r.slot
        r.start_decode()
        r.emit(1, 0.1 if r.rid % 2 == 0 else 0.9, 0.0)
        if sched.gate_decision(0, r.gate()):
            r.escalate()
            sched.push_escalated(r)
        else:
            r.complete(0.0)
        sched.release(0, slot)
    packed, slots = sched.admit(1, now=1.0)
    assert [r.rid for r in packed] == [0, 2] and slots == [0, 1]
    assert sched.gate_stats[0].escalated == 2


def test_budget_gate_matches_jax_scheduler():
    """The escalation-budget gate makes the JAX scheduler's decisions on
    the same confidence stream, δ for δ."""
    mine = CascadeScheduler([1, 1], [GateSpec(budget=0.2, window=64)])
    ref = JaxScheduler([1, 1], [JaxGateSpec(budget=0.2, window=64)])
    rng = np.random.default_rng(0)
    for c in rng.random(300):
        assert mine.gate_decision(0, float(c)) == \
            ref.gate_decision(0, float(c))
        assert mine.delta(0) == ref.delta(0)
    assert abs(mine.gate_stats[0].escalation_rate - 0.2) < 0.08
    assert delta_for_escalation_rate([], 0.3) == 0.5
    with pytest.raises(ValueError):
        GateSpec()
    with pytest.raises(ValueError):
        GateSpec(delta=0.5, budget=0.2)


# ---------------------------------------------------------------------------
# stream parity with the JAX engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    """name -> (JAX config, JAX weights, port weights), and the port's
    config under ``(name, "torch")``."""
    out = {}
    for i, name in enumerate((FAST, EXP, MOE, RWKV, JAMBA, HYBRID)):
        cfg, tcfg = configs_of(name)
        jp = jax.tree.map(np.asarray, jax_init_params(
            cfg, jax.random.PRNGKey(i), jnp.float32))
        out[name] = (cfg, jp, from_jax(jp))
        out[name, "torch"] = tcfg
    # granite at capacity factor 0.5: experts drop pairs in every launch
    out["drops"] = (with_capacity(out[MOE][0], 0.5),) + out[MOE][1:]
    out["drops", "torch"] = with_capacity(out[MOE, "torch"], 0.5)
    return out


ENGINE_KW = dict(slots=3, prompt_len=16, gen_len=4, kv_block_size=4,
                 prefill_chunk=5)


def _workload(dist, n=6, seed=0):
    prompts = bigram_lm(num_seqs=n, seq_len=16, vocab=512, seed=seed)
    lens = serve_async.sample_lengths(dist, n, 16, 1, seed)
    arrivals = serve_async.poisson_arrivals(n, 2.0, seed)
    return [(p[:int(k)], float(t)) for p, k, t in zip(prompts, lens,
                                                      arrivals)]


def _drain(eng, work):
    eng.warmup()
    for p, t in work:
        eng.submit(p, arrival_time=t)
    eng.run(max_steps=500)
    assert all(r.state.name == "DONE" for r in eng.requests)
    return eng


def _jax_engine(weights, delta, exp=EXP, **kw):
    kw = {**ENGINE_KW, **kw}
    return JaxEngine([JaxTierSpec(n, weights[n][0], weights[n][1])
                      for n in (FAST, exp)], deltas=[delta],
                     clock=JaxVirtualClock(), **kw)


def _torch_engine(weights, delta, exp=EXP, **kw):
    kw = {**ENGINE_KW, **kw}
    return CascadeEngine([TierSpec(n, weights[n, "torch"], weights[n][2])
                          for n in (FAST, exp)], deltas=[delta],
                         clock=VirtualClock(), device="cpu", **kw)


# the three executors, as engine switches (both packages take the same)
EXECUTORS = {"ragged": {},
             "padded": {"use_ragged_step": False},
             "split": {"use_unified_step": False}}
# the uniform one-shot prefill path (split decode), paged and dense, and
# the engine's own choice ("auto": uniform for a recurrent tier)
UNIFORM = {"uniform": {"use_chunked_prefill": False},
           "dense": {"use_paged_kv": False},
           "auto": {}}


# where a tapped JAX launch records: the sink and the recording switch
# of the latest _tap_jax_logits call (a jitted function traced under a
# tap keeps calling _tap, so engines may share tapped jitted functions)
_TAP = {"logits": None, "recording": [False]}


def _tap(tier, logits):
    if _TAP["recording"][0]:
        _TAP["logits"][tier].append(np.array(logits))


def _tap_jax_logits(monkeypatch, recording):
    """Record each JAX launch's per-row next-token logits, per tier: the
    unified steps' last-slot logits, the chunk launch's logits at each
    row's last live slot, the decode launch's single position, the
    uniform prefill's last position.  The records go to the dict this
    returns, while ``recording[0]`` is set, until the next call."""
    logits_by_tier = {0: [], 1: []}
    _TAP.update(logits=logits_by_tier, recording=recording)
    tap = _tap

    def tapped(fn, per_row):
        def run(params, cfg, tokens, cache, pos, pages=None):
            logits, cache = fn(params, cfg, tokens, cache, pos, pages)
            tier = int(not cfg.name.startswith(FAST))
            jax.debug.callback(functools.partial(tap, tier),
                               per_row(logits, pages))
            return logits, cache
        return run

    forward = jax_transformer.forward

    def tapped_forward(params, cfg, batch, *, mode="train", **kw):
        out = forward(params, cfg, batch, mode=mode, **kw)
        if mode == "prefill":
            tier = int(not cfg.name.startswith(FAST))
            jax.debug.callback(functools.partial(tap, tier),
                               out[0][:, -1])
        return out
    monkeypatch.setattr(jax_transformer, "forward", tapped_forward)

    rows = lambda lg, pages: lg                                # noqa: E731
    for name, per_row in (
            ("ragged_step", rows), ("mixed_step", rows),
            ("prefill_chunk", lambda lg, pages: lg[
                jnp.arange(lg.shape[0]),
                jnp.maximum(pages["q_len"] - 1, 0)]),
            ("decode_step", lambda lg, pages: lg[:, 0])):
        monkeypatch.setattr(jax_transformer, name, tapped(
            getattr(jax_transformer, name), per_row))
    return logits_by_tier


def _tap_torch_rows(eng):
    """Record the port's per-launch logits (every launch picks once, in
    the confidence gate) and, per launch, the rows it emits a token
    for (a uniform prefill's: its first ``n`` rows, the admitted
    ones)."""
    logits_by_tier = {0: [], 1: []}
    emitted = {0: [], 1: []}
    for tier, rt in enumerate(eng.runtimes):
        pick = rt.pick

        def tapped(logits2d, pick=pick, tier=tier):
            logits_by_tier[tier].append(logits2d.numpy().copy())
            return pick(logits2d)
        rt.pick = tapped
        write = rt.pool.write_prefill

        def written(slot_ids, part, *rest, write=write, tier=tier):
            emitted[tier].append(list(range(len(slot_ids))))
            return write(slot_ids, part, *rest)
        rt.pool.write_prefill = written
    exec_unified, exec_split = eng._exec_unified, eng._exec_split
    decode_launch = eng._decode_launch

    def unified(tier, rt, plan, *rest):
        if plan.prefill_rows or plan.decode_rows:
            emitted[tier].append(plan.finishing + plan.decode_rows)
        return exec_unified(tier, rt, plan, *rest)

    def split(tier, rt, plan, *rest):
        if plan.prefill_rows:           # the chunk launch emits these
            emitted[tier].append(list(plan.finishing))
        return exec_split(tier, rt, plan, *rest)

    def decode(tier, rt, pf, *rest):
        dc = decode_launch(tier, rt, pf, *rest)
        if dc is not None:
            emitted[tier].append(list(dc["active"]))
        return dc
    eng._exec_unified, eng._exec_split = unified, split
    eng._decode_launch = decode
    return logits_by_tier, emitted


_PROBED = {}
# the tapped JAX engines' jitted step functions, by model and runtime
_TAPPED_JITS: dict = {}


def _share_jits(eng, registry: dict) -> None:
    """Hand a JAX engine the jitted step functions of the earlier engines
    in ``registry`` (one a module; tapped engines apart from untapped
    ones) with the same config, arena kind and speculation: the same
    closures over the same config, so each shape compiles once per
    module instead of once per engine (the reference computes exactly
    what it would with its own; a tapped function records through
    :data:`_TAP`)."""
    for rt in eng.runtimes:
        fns = registry.setdefault((rt.spec.cfg, rt.paged, rt.spec_k,
                                   rt.spec_draft), {})
        for name in ("prefill_fn", "step_fn", "chunk_fn", "mixed_fn",
                     "ragged_fn", "spec_fn"):
            if getattr(rt, name) is not None:
                setattr(rt, name, fns.setdefault(name, getattr(rt, name)))


def _probe_delta(weights, dist):
    """δ mid-gap of a JAX probe run's tier-0 confidences, so the gate
    splits the workload.  At δ = 0 nothing escalates, so the probe runs
    gemma3 alone and one probe serves every expensive tier and executor
    of a workload."""
    key = (id(weights), dist)
    if key not in _PROBED:
        probe = _drain(_jax_engine(weights, 0.0), _workload(dist))
        confs = sorted(r.seq_conf_by_tier[0] for r in probe.requests)
        i = int(np.argmax(np.diff(confs)))
        _PROBED[key] = float((confs[i] + confs[i + 1]) / 2)
    return _PROBED[key]


def _check_stream_parity(weights, dist, monkeypatch, executor, exp=EXP):
    """The port and the JAX engine under one executor: equal
    ``stream_checksum`` and token confidences, and at every emitted step
    the port's logits within 1e-4 of JAX's with a top-1/top-2 margin of
    more than twice that difference."""
    kw = dict({**EXECUTORS, **UNIFORM}[executor], exp=exp)
    work = _workload(dist)
    delta = _probe_delta(weights, dist)

    recording = [False]
    jax_logits = _tap_jax_logits(monkeypatch, recording)
    ref = _jax_engine(weights, delta, **kw)
    _share_jits(ref, _TAPPED_JITS)
    ref.warmup()
    recording[0] = True
    for p, t in work:
        ref.submit(p, arrival_time=t)
    ref.run(max_steps=500)
    jax.effects_barrier()
    recording[0] = False

    mine = _torch_engine(weights, delta, **kw)
    torch_logits, emitted = _tap_torch_rows(mine)
    _drain(mine, [])                    # warmup, then nothing queued
    for name in torch_logits:           # drop the warmup launches
        torch_logits[name].clear()
        emitted[name].clear()
    for p, t in work:
        mine.submit(p, arrival_time=t)
    mine.run(max_steps=500)

    assert all(r.state is RequestState.DONE for r in mine.requests)
    assert {r.tier for r in mine.requests} == {0, 1}   # the gate splits
    assert serve_async.stream_checksum(mine) == \
        jax_serve_async.stream_checksum(ref)
    for a, b in zip(mine.requests, ref.requests):
        np.testing.assert_allclose(a.token_conf, b.token_conf, rtol=1e-4)
    steps = 0
    for tier in (0, 1):
        assert len(torch_logits[tier]) == len(jax_logits[tier]) \
            == len(emitted[tier])
        for got, want, rows in zip(torch_logits[tier], jax_logits[tier],
                                   emitted[tier]):
            for s in rows:
                err = np.abs(got[s] - want[s]).max()
                top2 = np.sort(got[s])[-2:]
                assert err < 1e-4
                assert top2[1] - top2[0] > 2 * err, (tier, s, err, top2)
                steps += 1
    # every emitted token of every tier was checked
    assert steps == sum(len(t) for r in mine.requests
                        for t in r.tokens_by_tier)
    return mine


@pytest.mark.parametrize("dist", ["uniform", "lognormal"])
def test_stream_parity_with_jax_engine(weights, dist, monkeypatch):
    _check_stream_parity(weights, dist, monkeypatch, "ragged")


@pytest.mark.parametrize("executor", ["padded", "split"])
def test_stream_parity_with_jax_engine_padded_and_split(weights, executor,
                                                        monkeypatch):
    """``use_ragged_step=False`` and ``use_unified_step=False`` against
    the same switches in the JAX engine."""
    eng = _check_stream_parity(weights, "lognormal", monkeypatch, executor)
    assert (eng.unified_step, eng.ragged_step) == {
        "padded": (True, False), "split": (False, False)}[executor]


@pytest.mark.parametrize("executor", ["ragged", "padded", "split"])
def test_moe_stream_parity_with_jax_engine(weights, executor, monkeypatch):
    """gemma3-1b -> granite-moe-3b-a800m (smoke: 4 experts, top-2, no
    drops at capacity factor 2) under each executor."""
    _check_stream_parity(weights, "lognormal", monkeypatch, executor,
                         exp=MOE)


@pytest.mark.parametrize("executor", ["padded", "split"])
def test_moe_stream_parity_with_drops(weights, executor, monkeypatch):
    """granite at capacity factor 0.5: the padded batch's dead slots and
    the split decode's idle rows (their stale last token) fill expert
    queues ahead of live tokens, so equal streams need the JAX engine's
    padding token ids."""
    _check_stream_parity(weights, "lognormal", monkeypatch, executor,
                         exp="drops")


@pytest.mark.parametrize("executor,exp", [("uniform", EXP), ("dense", EXP),
                                          ("auto", RWKV)])
def test_uniform_prefill_stream_parity_with_jax_engine(weights, executor,
                                                       exp, monkeypatch):
    """The uniform one-shot prefill path against the JAX engine: phi4
    under ``use_chunked_prefill=False`` (block-paged arena) and under
    ``use_paged_kv=False`` (dense arena), and the recurrent rwkv6-3b,
    which both engines put on that path by themselves.  Every prompt is
    ``prompt_len`` tokens long."""
    eng = _check_stream_parity(weights, "uniform", monkeypatch, executor,
                               exp=exp)
    assert (eng.chunked_prefill, eng.unified_step, eng.paged_kv) == (
        False, False, executor != "dense")
    kinds = eng.metrics.summary()["launches_by_kind"]
    assert all(set(k) == {"prefill", "step"} for k in kinds)


@pytest.mark.parametrize("exp", [JAMBA, HYBRID])
@pytest.mark.parametrize("executor", ["auto", "dense"])
def test_hybrid_stream_parity_with_jax_engine(weights, executor, exp,
                                              monkeypatch):
    """gemma3-1b -> jamba-smoke (two Mamba layers, a dense and an MoE FFN)
    and -> the narrow 8-layer jamba period (attention at layer 4, MoE on
    the odd layers) against the JAX engine: on the block-paged arena,
    where both engines pick the uniform prefill by themselves (Mamba
    state cannot be chunked), and on the dense arena."""
    eng = _check_stream_parity(weights, "uniform", monkeypatch, executor,
                               exp=exp)
    assert (eng.chunked_prefill, eng.unified_step, eng.ragged_step,
            eng.paged_kv) == (False, False, False, executor == "auto")
    kinds = eng.metrics.summary()["launches_by_kind"]
    assert all(set(k) == {"prefill", "step"} for k in kinds)


def test_uniform_and_chunked_executors_agree_in_the_port(weights):
    """On equal-length prompts the uniform prefill (paged and dense) and
    the chunked default give the same streams — the JAX engine's own
    oracle relation (ragged = padded = split is
    ``test_executors_agree_in_the_port``)."""
    work = _workload("uniform", n=8, seed=2)
    sums = {name: serve_async.stream_checksum(
        _drain(_torch_engine(weights, 0.5, **kw), work))
        for name, kw in (("ragged", EXECUTORS["ragged"]),
                         ("uniform", UNIFORM["uniform"]),
                         ("dense", UNIFORM["dense"]))}
    assert len(set(sums.values())) == 1, sums


def test_split_oversubscribed_arena_matches_jax(weights):
    """An over-subscribed arena (10 blocks where 16 hold every row): rows
    are denied blocks and stall, so the split executor's admission (the
    legacy prefill-only token window) and block growth (decode rows after
    the chunk launch, oldest first) must follow the JAX engine's for the
    streams and every request's virtual-clock TTFT and latency to
    agree."""
    work = _workload("bimodal", n=8, seed=3)
    kw = dict(use_unified_step=False, kv_blocks=10)
    ref = _drain(_jax_engine(weights, 0.5, **kw), work)
    mine = _torch_engine(weights, 0.5, **kw)
    denied = [0]
    for rt in mine.runtimes:
        grow = rt.pool.ensure_blocks

        def counted(slot, pos, grow=grow):
            ok = grow(slot, pos)
            denied[0] += not ok
            return ok
        rt.pool.ensure_blocks = counted
    _drain(mine, work)
    assert mine.runtimes[0].pool.oversubscribed and denied[0] > 0
    assert serve_async.stream_checksum(mine) == \
        jax_serve_async.stream_checksum(ref)
    np.testing.assert_allclose(   # virtual-clock ticks, to float noise
        [(r.ttft, r.latency) for r in mine.requests],
        [(r.ttft, r.latency) for r in ref.requests], atol=1e-9, rtol=0)


def test_executors_agree_in_the_port(weights):
    """ragged = padded = split: the same weights, δ and workload give the
    same streams under all three executors."""
    work = _workload("lognormal", n=8, seed=2)
    sums = {name: serve_async.stream_checksum(
        _drain(_torch_engine(weights, 0.5, **kw), work))
        for name, kw in EXECUTORS.items()}
    assert len(set(sums.values())) == 1, sums


def _per_tick_counts(eng):
    """Launches and fetches per tier for every tick of a run."""
    ticks = []
    step = eng.step

    def counted(now=None):
        m = eng.metrics
        l0, h0 = list(m.launches_by_tier), list(m.host_syncs_by_tier)
        step(now)
        ticks.append(([a - b for a, b in zip(m.launches_by_tier, l0)],
                      [a - b for a, b in zip(m.host_syncs_by_tier, h0)]))
    eng.step = counted
    return ticks


@pytest.mark.parametrize("executor", ["padded", "split"])
def test_launch_and_fetch_budget_per_tick(weights, executor):
    """Padded: one launch per active tier per tick.  Split: at most two
    launches (chunk + decode) and at most one fetch per tier per tick,
    with both kinds of launch seen."""
    eng = _torch_engine(weights, 0.5, **EXECUTORS[executor])
    ticks = _per_tick_counts(eng)
    _drain(eng, _workload("lognormal"))
    most = 1 if executor == "padded" else 2
    assert all(max(l) <= most and max(h) <= 1 and all(
        hh <= ll for hh, ll in zip(h, l)) for l, h in ticks)
    s = eng.metrics.summary()
    want = {"mixed"} if executor == "padded" else {"chunk", "step"}
    assert all(set(k) == want for k in s["launches_by_kind"])
    assert s["active_ticks"] == [sum(l[t] > 0 for l, _ in ticks)
                                 for t in range(2)]
    assert all(h <= a for h, a in zip(s["host_syncs"], s["active_ticks"]))
    if executor == "split":
        assert any(max(l) == 2 for l, _ in ticks)   # a mixed tick


def test_executor_switches_raise_like_jax(weights):
    tiers = [TierSpec(n, weights[n, "torch"], weights[n][2])
             for n in (FAST, EXP)]
    with pytest.raises(ValueError, match="ragged flat token-batch"):
        CascadeEngine(tiers, device="cpu", use_unified_step=False,
                      use_ragged_step=True, **ENGINE_KW)
    rwkv = [tiers[0], TierSpec(RWKV, weights[RWKV, "torch"],
                               weights[RWKV][2])]
    jax_tiers = [JaxTierSpec(n, weights[n][0], weights[n][1])
                 for n in (FAST, RWKV)]
    for kw, match in (
            (dict(use_chunked_prefill=True), "chunked prefill requires"),
            (dict(use_unified_step=True), "unified token-batch execution "
             "requires chunked"),
            (dict(kv_blocks=[None, 10]), "over-subscribes the arena")):
        for make, t in ((CascadeEngine, rwkv), (JaxEngine, jax_tiers)):
            extra = {"device": "cpu"} if make is CascadeEngine else {}
            with pytest.raises(ValueError, match=match):
                make(t, **kw, **extra, **ENGINE_KW)
    for make, extra in ((CascadeEngine, {"device": "cpu"}), (JaxEngine, {})):
        t = tiers if make is CascadeEngine else [
            JaxTierSpec(n, weights[n][0], weights[n][1]) for n in (FAST, EXP)]
        with pytest.raises(ValueError, match="chunked prefill requires"):
            make(t, use_paged_kv=False, use_chunked_prefill=True, **extra,
                 **ENGINE_KW)
        with pytest.raises(ValueError, match="unified token-batch"):
            make(t, use_chunked_prefill=False, use_unified_step=True,
                 **extra, **ENGINE_KW)
    eng = CascadeEngine(rwkv, device="cpu", **ENGINE_KW)
    assert (eng.chunked_prefill, eng.unified_step, eng.ragged_step) == (
        False, False, False)
    with pytest.raises(ValueError, match="uniform packed prefill"):
        eng.submit(np.arange(5))        # not prompt_len tokens


@pytest.mark.parametrize("exp", [JAMBA, HYBRID])
def test_hybrid_executor_switches_raise_like_jax(weights, exp):
    """A Mamba tier refuses chunked prefill, unified steps and an
    over-subscribed arena (its state cannot replay a stalled step) with
    the JAX engine's errors, and the engine picks the uniform path by
    itself."""
    tiers = [TierSpec(n, weights[n, "torch"], weights[n][2])
             for n in (FAST, exp)]
    jax_tiers = [JaxTierSpec(n, weights[n][0], weights[n][1])
                 for n in (FAST, exp)]
    for kw, match in (
            (dict(use_chunked_prefill=True), "chunked prefill requires"),
            (dict(use_unified_step=True), "unified token-batch execution "
             "requires chunked"),
            (dict(kv_blocks=[None, 10]), "recurrent")):
        msgs = []
        for make, t in ((CascadeEngine, tiers), (JaxEngine, jax_tiers)):
            extra = {"device": "cpu"} if make is CascadeEngine else {}
            with pytest.raises(ValueError, match=match) as err:
                make(t, **kw, **extra, **ENGINE_KW)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]
    eng = CascadeEngine(tiers, device="cpu", **ENGINE_KW)
    assert (eng.chunked_prefill, eng.unified_step, eng.ragged_step) == (
        False, False, False)


def test_host_syncs_one_per_active_tier_per_tick(weights):
    eng = _drain(_torch_engine(weights, 0.5), _workload("lognormal"))
    s = eng.metrics.summary()
    assert s["completed"] == 6
    assert all(h <= l for h, l in zip(s["host_syncs"], s["launches"]))
    assert max(s["launches_per_tick"]) <= 1.0
    assert eng.host_syncs == sum(s["host_syncs"])


# ---------------------------------------------------------------------------
# device selection: no silent CPU fallback
# ---------------------------------------------------------------------------


def test_default_device_raises_without_a_card(weights, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tiers = [TierSpec(n, get_config(n, "smoke"), weights[n][2])
             for n in (FAST, EXP)]
    with pytest.raises(RuntimeError, match="cuda"):
        CascadeEngine(tiers, **ENGINE_KW)
    args = serve_async.make_parser().parse_args([])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        serve_async.build_engine(args)


def test_cli_runs_on_cpu_when_asked(capsys):
    args = serve_async.make_parser().parse_args(
        ["--device", "cpu", "--requests", "4", "--slots", "2",
         "--prompt-len", "12", "--gen-len", "3", "--length-dist",
         "lognormal", "--virtual-clock"])
    s = serve_async.run(args, VirtualClock())
    serve_async.report(s)
    assert s["completed"] == 4 and s["device"] == "cpu"
    assert all(r["state"] == "DONE" and len(r["tokens"]) == 3
               for r in s["per_request"])
    assert s["kernel_launches"] == {"ragged_attention": 0,
                                    "mixed_attention": 0,
                                    "paged_attention": 0,
                                    "flash_attention": 0,
                                    "confidence_gate": 0,
                                    "router_gate": 0,
                                    "rwkv6_scan": 0,
                                    "mamba_scan": 0}
    out = capsys.readouterr().out
    assert "served 4/4 requests" in out and "[ragged]" in out


def test_cli_serves_the_moe_cascade_on_cpu(capsys):
    """``--expensive granite-moe-3b-a800m`` under the three executors:
    every request DONE, the same streams (no drops at the smoke
    variant), the router counted in the report."""
    sums = set()
    for flag in ([], ["--no-ragged-step"], ["--split-step"]):
        args = serve_async.make_parser().parse_args(
            ["--device", "cpu", "--expensive", MOE, "--requests", "4",
             "--slots", "2", "--prompt-len", "12", "--gen-len", "3",
             "--length-dist", "lognormal", "--virtual-clock"] + flag)
        s = serve_async.run(args, VirtualClock())
        serve_async.report(s)
        assert s["completed"] == 4 and s["tier_names"][1] == MOE
        assert all(r["state"] == "DONE" and len(r["tokens"]) == 3
                   for r in s["per_request"])
        assert 1 in {r["tier"] for r in s["per_request"]}
        sums.add(s["stream_checksum"])
    assert len(sums) == 1
    assert "router_gate=0" in capsys.readouterr().out


@pytest.mark.parametrize("flag,mode", [("--no-ragged-step", "unified"),
                                       ("--split-step", "split")])
def test_cli_runs_padded_and_split_on_cpu(flag, mode, capsys):
    args = serve_async.make_parser().parse_args(
        ["--device", "cpu", "--requests", "4", "--slots", "2",
         "--prompt-len", "12", "--gen-len", "3", "--length-dist",
         "lognormal", "--virtual-clock", flag])
    s = serve_async.run(args, VirtualClock())
    serve_async.report(s)
    assert s["completed"] == 4 and s["ragged_step"] is False
    assert s["unified_step"] is (mode == "unified")
    assert s["flat_buckets"] == [None, None]
    assert all(r["state"] == "DONE" and len(r["tokens"]) == 3
               for r in s["per_request"])
    out = capsys.readouterr().out
    assert "served 4/4 requests" in out and f"[{mode}]" in out
    with pytest.raises(SystemExit):
        serve_async.make_parser().parse_args(["--ragged-step=no"])


def test_run_serves_given_configs_on_cpu():
    """``run(..., cfgs=)`` serves a configuration cut from a registered
    one — here the narrow 8-layer jamba period in place of
    ``--expensive``'s smoke variant — on the uniform path the engine
    picks by itself, every request DONE."""
    args = serve_async.make_parser().parse_args(
        ["--device", "cpu", "--expensive", JAMBA, "--requests", "4",
         "--slots", "2", "--prompt-len", "12", "--gen-len", "3",
         "--virtual-clock"])
    cfgs = (get_config(FAST, "smoke"), configs_of(HYBRID)[1])
    s = serve_async.run(args, VirtualClock(), cfgs=cfgs)
    assert s["completed"] == 4 and s["chunked_prefill"] is False
    assert all(r["state"] == "DONE" and len(r["tokens"]) == 3
               for r in s["per_request"])
    assert 1 in {r["tier"] for r in s["per_request"]}
    assert serve_async.tier_configs(args, cfgs) == cfgs
    assert serve_async.tier_configs(args)[1] == get_config(JAMBA, "smoke")


@pytest.mark.parametrize("flags,exp,mode", [
    (["--no-chunked-prefill"], EXP, "uniform+split"),
    (["--dense-kv"], EXP, "uniform+split dense"),
    ([], RWKV, "uniform+split"),
    ([], JAMBA, "uniform+split"),
    (["--dense-kv"], JAMBA, "uniform+split dense")])
def test_cli_runs_uniform_prefill_on_cpu(flags, exp, mode, capsys):
    """``--no-chunked-prefill``, ``--dense-kv``, and the rwkv6-3b and
    jamba-v0.1-52b cascades (uniform by themselves): every request DONE,
    and mixed prompt lengths refused."""
    base = ["--device", "cpu", "--requests", "4", "--slots", "2",
            "--prompt-len", "12", "--gen-len", "3", "--virtual-clock",
            "--expensive", exp]
    s = serve_async.run(serve_async.make_parser().parse_args(base + flags),
                        VirtualClock())
    serve_async.report(s)
    assert s["completed"] == 4 and s["chunked_prefill"] is False
    assert s["unified_step"] is False and s["paged_kv"] is ("--dense-kv"
                                                            not in flags)
    assert all(r["state"] == "DONE" and len(r["tokens"]) == 3
               for r in s["per_request"])
    assert f"[{mode}]" in capsys.readouterr().out
    with pytest.raises(ValueError, match="--length-dist uniform"):
        serve_async.run(serve_async.make_parser().parse_args(
            base + flags + ["--length-dist", "lognormal"]), VirtualClock())
