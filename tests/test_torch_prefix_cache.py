"""Refcounted KV prefix caching in the torch port against the JAX package,
on the CPU.

The engines first, case for case with ``tests/test_prefix_cache.py``
(preemption, in ``tests/test_torch_faults.py``, and sharding left out):
shared-prefix prompts of one length, lognormal lengths, an
over-subscribed arena that LRU-evicts index entries, and a two-tier
cascade whose escalated requests re-prefill on the expensive tier, each
under the ragged, padded and split executors at a fixed δ and a virtual
clock.  In every case the port's token streams (and tier routing) are
the same with the cache on and off, its confidences within 1e-8, and
its cache-on streams equal the JAX engine's cache-on streams, with the
confidences within 1e-8 and, at every emitted step, the port's logits
within 1e-4 of JAX's and a top-1/top-2 margin of more than twice that
difference.  Speculation (k = 4) over the two-tier workload gives the
streams of the run without either and leaks no block.

Then the pool: the port's ``TierSlotPool(prefix_chunk=8)`` under the
JAX suite's random-operation driver and invariant checker
(``tests/test_slots_properties.py``, imported; arena shrinkage is
driven in ``tests/test_torch_faults.py``), the JAX suite's unit cases on the port's pool, and the same
operation sequence through the JAX pool and the port's, answer for
answer and refcount for refcount.  Each engine run is made once and
shared by the module.
"""
import dataclasses
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
from repro.serving.engine import VirtualClock as JaxVirtualClock  # noqa: E402
from repro.serving.slots import TierSlotPool as JaxPool  # noqa: E402
from repro_torch.launch import serve_async  # noqa: E402
from repro_torch.models.params import from_jax, tree_leaves  # noqa: E402
from repro_torch.serving import (CascadeEngine, TierSlotPool,  # noqa: E402
                                 TierSpec)
from repro_torch.serving.engine import VirtualClock  # noqa: E402
from repro_torch.serving.slots import NULL_BLOCK, PrefixEntry  # noqa: E402
from tests.test_slots_properties import (BS, CAPACITY, CHUNK,  # noqa: E402
                                         MAX_SEQ, Driver, check_invariants)
from tests.test_torch_model import configs_of  # noqa: E402
from tests.test_torch_serving import (_tap_jax_logits,  # noqa: E402
                                      _tap_torch_rows)

FAST, EXP = "gemma3-1b", "phi4-mini-3.8b"
ENGINE_KW = dict(slots=2, prompt_len=24, gen_len=4, prefill_chunk=8,
                 kv_block_size=4)
EXECUTORS = {"ragged": {}, "padded": {"use_ragged_step": False},
             "split": {"use_unified_step": False}}


# ---------------------------------------------------------------------------
# workloads and engines
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    """name -> (JAX config, port config, JAX weights, port weights):
    gemma3-1b from PRNGKey(0), phi4-mini-3.8b from PRNGKey(1)."""
    out = {}
    for i, name in enumerate((FAST, EXP)):
        jcfg, cfg = configs_of(name)
        jp = jax.tree.map(np.asarray, jax_init_params(
            jcfg, jax.random.PRNGKey(i), jnp.float32))
        out[name] = (jcfg, cfg, jp, from_jax(jp))
    return out


def _shared_prefix_prompts(vocab, n=8, plen=24, shared=20, seed=0):
    """n prompts agreeing on their first `shared` tokens (one base
    sequence) with unique tails — the system-prompt workload."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, vocab, plen).astype(np.int32)
    out = []
    for _ in range(n):
        p = base.copy()
        p[shared:] = rng.integers(0, vocab, plen - shared)
        out.append(p)
    return out


def _lognormal_prompts(vocab):
    """Mixed lengths off one shared base: short prompts match shorter
    boundaries (or none), long ones the deepest."""
    rng = np.random.default_rng(3)
    base = rng.integers(0, vocab, 24).astype(np.int32)
    lens = np.clip(np.rint(rng.lognormal(np.log(12), 0.6, 8)),
                   2, 24).astype(int)
    prompts = []
    for L in lens:
        p = base[:L].copy()
        cut = max(1, int(0.8 * L))
        p[cut:] = rng.integers(0, vocab, L - cut)
        prompts.append(p)
    return prompts


# case -> (tier names, prompts(vocab), engine kwargs): the JAX suite's
# workloads; the two-tier cascade is gemma3-1b -> phi4-mini-3.8b, as on
# the main path, and the over-subscribed arena has 14 blocks against
# 2 rows * 7 pages + null = 15
CASES = {
    "uniform": ((FAST,), _shared_prefix_prompts, {}),
    "lognormal": ((FAST,), _lognormal_prompts, {}),
    "oversubscribed": ((FAST,), lambda v: _shared_prefix_prompts(
        v, n=10, seed=5), {"kv_blocks": 14}),
    "two-tier": ((FAST, EXP), lambda v: _shared_prefix_prompts(
        v, seed=2), {}),
}


def _engine(weights, package, names, **kw):
    kw = {**ENGINE_KW, **kw}
    if len(names) == 1:
        kw["deltas"] = []
    if package == "jax":
        return JaxEngine([JaxTierSpec(n, weights[n][0], weights[n][2])
                          for n in names], clock=JaxVirtualClock(), **kw)
    return CascadeEngine([TierSpec(n, weights[n][1], weights[n][3])
                          for n in names], clock=VirtualClock(),
                         device="cpu", **kw)


def _drain(eng, prompts):
    for p in prompts:
        eng.submit(p, arrival_time=0.0)
    summary = eng.run(max_steps=800)
    assert all(r.state.name == "DONE" for r in eng.requests)
    return summary


def _two_tier_delta(weights, prompts):
    """δ mid-gap of the port's tier-0 sequence confidences at δ = 0
    (nothing escalates), so the gate splits the workload."""
    probe = _engine(weights, "torch", (FAST, EXP), deltas=[0.0])
    _drain(probe, prompts)
    confs = sorted(r.seq_conf_by_tier[0] for r in probe.requests)
    i = int(np.argmax(np.diff(confs)))
    return float((confs[i] + confs[i + 1]) / 2)


@pytest.fixture(scope="module")
def served(weights):
    """(package, case, executor, cache[, k]) -> run, each made once on
    first use: a dict of the engine, its summary and, for the cache-on
    runs of k = 0, the per-launch logits (and the port's emitted rows)
    of the margin check."""
    runs, deltas = {}, {}

    def get(package, case, executor, cache, k=0):
        key = (package, case, executor, cache, k)
        if key in runs:
            return runs[key]
        names, make, kw = CASES[case]
        vocab = min(weights[n][1].vocab_size for n in names)
        prompts = make(vocab)
        kw = dict(kw, **EXECUTORS[executor], prefix_cache=cache)
        if len(names) == 2:
            if case not in deltas:
                deltas[case] = _two_tier_delta(weights, prompts)
            kw["deltas"] = [deltas[case]]
        if k:
            kw.update(speculation_k=k, spec_delta=0.0)
        eng = _engine(weights, package, names, **kw)
        out = {"engine": eng}
        tap = cache and not k
        if package == "jax":
            with pytest.MonkeyPatch.context() as mp:
                recording = [tap]
                logits = _tap_jax_logits(mp, recording) if tap else None
                out["summary"] = _drain(eng, prompts)
                jax.effects_barrier()
            out["logits"] = logits
        else:
            if tap:
                out["logits"], out["emitted"] = _tap_torch_rows(eng)
            out["summary"] = _drain(eng, prompts)
        runs[key] = out
        return out
    return get


def _streams(eng):
    return [(r.rid, tuple(r.tokens), r.tier,
             tuple(tuple(t) for t in r.tokens_by_tier))
            for r in eng.requests]


def _assert_confs_close(a, b):
    for x, y in zip(a.requests, b.requests):
        np.testing.assert_allclose(x.token_conf, y.token_conf, atol=1e-8,
                                   rtol=0)


def _assert_margins(mine, ref):
    """At every step the port emitted a token, its logits are within
    1e-4 of the JAX launch's and its top-1/top-2 margin exceeds twice
    that difference: equal argmaxes are not a float accident."""
    got_by, emitted, want_by = mine["logits"], mine["emitted"], \
        ref["logits"]
    steps = 0
    for tier in (0, 1):
        assert len(got_by[tier]) == len(want_by[tier]) \
            == len(emitted[tier])
        for got, want, rows in zip(got_by[tier], want_by[tier],
                                   emitted[tier]):
            for s in rows:
                err = np.abs(got[s] - want[s]).max()
                top2 = np.sort(got[s])[-2:]
                assert err < 1e-4
                assert top2[1] - top2[0] > 2 * err, (tier, s, err, top2)
                steps += 1
    assert steps == sum(len(t) for r in mine["engine"].requests
                        for t in r.tokens_by_tier)


# ---------------------------------------------------------------------------
# the engines: configuration and stream parity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flags", [{"use_chunked_prefill": False},
                                   {"use_paged_kv": False}])
def test_prefix_cache_requires_chunked_prefill(weights, flags):
    """The uniform and dense paths refuse the cache, with the JAX
    engine's error."""
    with pytest.raises(ValueError, match="prefix caching requires") as got:
        _engine(weights, "torch", (FAST,), prefix_cache=True, **flags)
    with pytest.raises(ValueError) as want:
        _engine(weights, "jax", (FAST,), prefix_cache=True, **flags)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("executor", sorted(EXECUTORS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_streams_match_cache_off_and_jax(served, case, executor):
    """Cache on against cache off in the port (streams and routing the
    same, confidences within 1e-8) and against the JAX engine's cache-on
    run (the same, under the margin rule at every emitted step); the
    prefix-cache counters and the pools' prefix accounting equal
    JAX's."""
    on = served("torch", case, executor, True)
    off = served("torch", case, executor, False)
    ref = served("jax", case, executor, True)
    mine, base, jeng = on["engine"], off["engine"], ref["engine"]
    assert _streams(mine) == _streams(base)
    _assert_confs_close(mine, base)
    assert serve_async.stream_checksum(mine) == \
        jax_serve_async.stream_checksum(jeng)
    assert _streams(mine) == _streams(jeng)
    _assert_confs_close(mine, jeng)
    _assert_margins(on, ref)
    assert on["summary"]["prefix_cache"] == ref["summary"]["prefix_cache"]
    assert on["summary"]["prefill_live_tokens"] == \
        ref["summary"]["prefill_live_tokens"]
    assert on["summary"]["steps"] == ref["summary"]["steps"]
    for got, want in zip(mine.memory_stats(), jeng.memory_stats()):
        for key in ("kv_high_water_blocks", "kv_shared_high_water_blocks",
                    "prefix_index_entries", "prefix_evictions",
                    "prefix_cow_copies"):
            assert got[key] == want[key], key
    assert off["summary"]["prefix_cache"]["lookups"] == 0
    assert on["summary"]["prefix_cache"]["hits"] > 0
    for rt in mine.runtimes:
        check_invariants(rt.pool)


@pytest.mark.parametrize("executor", sorted(EXECUTORS))
def test_shared_prompts_halve_live_prefill_tokens(served, executor):
    """The headline: on the 5/6-shared workload cached chunks are never
    re-prefilled, so live prefill tokens at least halve."""
    on, off = (served("torch", "uniform", executor, c) for c in (True,
                                                                 False))
    assert off["summary"]["prefill_live_tokens"] \
        >= 2 * on["summary"]["prefill_live_tokens"]
    stats = on["engine"].runtimes[0].pool.memory_stats()
    assert stats["kv_shared_high_water_blocks"] > 0
    assert stats["prefix_index_entries"] > 0


@pytest.mark.parametrize("executor", sorted(EXECUTORS))
def test_every_lognormal_admission_looks_up(served, executor):
    pc = served("torch", "lognormal", executor, True)["summary"][
        "prefix_cache"]
    assert pc["lookups"] == len(_lognormal_prompts(512))


@pytest.mark.parametrize("executor", sorted(EXECUTORS))
def test_oversubscribed_arena_evicts(served, executor):
    """Growth under pressure LRU-evicts index entries while later
    admissions still find survivors to hit."""
    on = served("torch", "oversubscribed", executor, True)
    stats = on["engine"].runtimes[0].pool.memory_stats()
    assert stats["prefix_evictions"] > 0
    assert stats["kv_shared_high_water_blocks"] > 0
    assert on["summary"]["prefix_cache"]["hits"] > 0


@pytest.mark.parametrize("executor", sorted(EXECUTORS))
def test_two_tiers_hit_their_own_index(served, executor):
    """Escalated requests re-prefill on the expensive tier and hit that
    tier's own index; block ids never cross tiers (each tier owns its
    pool, allocator and index)."""
    on = served("torch", "two-tier", executor, True)
    eng = on["engine"]
    assert {r.tier for r in eng.requests} == {0, 1}
    pc = on["summary"]["prefix_cache"]
    assert pc["hits_by_tier"][0] > 0 and pc["hits_by_tier"][1] > 0
    pools = [rt.pool for rt in eng.runtimes]
    assert pools[0] is not pools[1]
    assert pools[0].cache is not pools[1].cache
    for pool in pools:
        for ent in pool._index[0].values():
            assert all(b in pool.blocks._used for b in ent.blocks)


def test_speculation_over_cached_prefixes(served):
    """k = 4 on the ragged executor with the cache on: the streams of the
    cache-off run at k = 0 and at k = 4 and of the JAX engine's cache-on
    run at k = 4; drafts were verified; after the drain no row is bound,
    every live block is held by the prefix index alone (retained draft
    rows released their shared pages through the refcounted release)
    and the pools pass the invariant checker."""
    on = served("torch", "two-tier", "ragged", True, 4)
    mine = on["engine"]
    for other in (served("torch", "two-tier", "ragged", False),
                  served("torch", "two-tier", "ragged", False, 4),
                  served("jax", "two-tier", "ragged", True, 4)):
        assert _streams(mine) == _streams(other["engine"])
        _assert_confs_close(mine, other["engine"])
    s = on["summary"]
    assert s["speculation"]["drafted"] > 0
    assert s["prefix_cache"]["hits_by_tier"][1] > 0
    for rt in mine.runtimes:
        pool = rt.pool
        check_invariants(pool)
        assert pool.bound_rows() == [] and rt.draft_slots() == []
        assert pool.blocks.num_used == len(pool._index_refs)
        assert all(pool.blocks.refcount(b) == n
                   for b, n in pool._index_refs.items())


def test_cli_prefix_cache_keeps_streams(capsys):
    """``--prefix-cache --shared-prefix-frac 0.75`` on the CPU: the
    ``prefix cache`` report line, hits, fewer live prefill tokens and the
    stream checksum of the run without the cache."""
    base = ["--device", "cpu", "--requests", "6", "--slots", "2",
            "--prompt-len", "24", "--gen-len", "3", "--prefill-chunk", "8",
            "--kv-block-size", "4", "--length-dist", "lognormal",
            "--shared-prefix-frac", "0.75", "--virtual-clock",
            "--delta", "0.5"]
    runs = []
    for flags in ([], ["--prefix-cache"]):
        s = serve_async.run(serve_async.make_parser().parse_args(
            base + flags), VirtualClock())
        serve_async.report(s)
        runs.append(s)
    off, on = runs
    assert on["stream_checksum"] == off["stream_checksum"]
    assert on["prefix_cache_enabled"] and not off["prefix_cache_enabled"]
    assert on["shared_prefix_frac"] == 0.75
    assert on["prefix_cache"]["hits"] > 0
    assert on["prefill_live_tokens"] < off["prefill_live_tokens"]
    out = capsys.readouterr().out
    assert out.count("prefix cache  hit rate") == 1


def test_apply_shared_prefix_matches_jax():
    """The shared-prefix workload is the JAX package's, base sequence
    and cut included."""
    prompts = np.arange(60, dtype=np.int32).reshape(3, 20) % 7
    lens = np.asarray([20, 9, 1])
    got = serve_async.apply_shared_prefix(prompts, lens, 0.75, 512, 4)
    want = jax_serve_async.apply_shared_prefix(prompts, lens, 0.75, 512, 4)
    np.testing.assert_array_equal(got, want)
    assert serve_async.apply_shared_prefix(prompts, lens, 0.0, 512, 4) \
        is prompts
    with pytest.raises(ValueError, match="shared-prefix-frac"):
        serve_async.apply_shared_prefix(prompts, lens, 1.5, 512, 4)


# ---------------------------------------------------------------------------
# the pool
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cfgs():
    return configs_of(FAST)


def make_pool(cfg, num_blocks=None, oversubscribe=False, package="torch"):
    """The JAX suite's pool at one shard, in either package."""
    if num_blocks is None:
        full = CAPACITY * (MAX_SEQ // BS) + 1
        num_blocks = full // 2 + 1 if oversubscribe else full
    if package == "jax":
        return JaxPool(cfg, CAPACITY, MAX_SEQ, block_size=BS,
                       num_blocks=num_blocks, prefix_chunk=CHUNK)
    return TierSlotPool(cfg, CAPACITY, MAX_SEQ, block_size=BS,
                        num_blocks=num_blocks, prefix_chunk=CHUNK,
                        device="cpu")


class PortDriver(Driver):
    """The JAX suite's random-operation driver without arena shrinkage
    (driven in ``tests/test_torch_faults.py``): admit, admit-unaligned,
    grow, publish, release, the release and double-free guards, and
    reclaim."""
    OPS = tuple(op for op in Driver.OPS
                if op not in (Driver.op_shrink, Driver.op_unshrink))


@pytest.mark.parametrize("oversub", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_fuzz_interleavings(cfgs, seed, oversub):
    pool = make_pool(cfgs[1], oversubscribe=oversub)
    PortDriver(pool, random.Random(seed)).run(steps=60)


RECORDED = ("match_prefix", "publish_prefix", "can_admit", "bind",
            "ensure_blocks", "release", "_reclaim")


def _state(pool) -> dict:
    return dict(
        refcount=dict(pool.blocks._refcount),
        free=list(pool.blocks._free[0]),
        shared=(pool.blocks.num_shared, pool.blocks.shared_high_water,
                pool.blocks.high_water),
        index={k: (e.ntokens, list(e.blocks), e.last_use)
               for k, e in pool._index[0].items()},
        index_refs=dict(pool._index_refs),
        page_table=pool.page_table.tolist(),
        rows=[list(r) for r in pool._row_blocks],
        row_shared=list(pool._row_shared),
        published=list(pool._row_published),
        order=list(pool._order),
        counters=(pool.prefix_evictions, pool.prefix_cow_copies))


def _record(pool, log):
    """Log every outermost call of the RECORDED methods with its
    arguments, its answer (or error) and the pool's state after it."""
    depth = [0]
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
                    log.append((_name, a, kw, out, _state(pool)))
            return out
        setattr(pool, name, call)


@pytest.mark.parametrize("oversub", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_pool_operations_match_jax(cfgs, seed, oversub):
    """The driver's operations on the port's pool, replayed on the JAX
    pool: every answer (match, admission, growth, reclaim), every error
    and, after each call, refcounts, free list, index entries with their
    LRU stamps, page tables and counters are equal."""
    pool = make_pool(cfgs[1], oversubscribe=oversub)
    log = []
    _record(pool, log)
    PortDriver(pool, random.Random(100 + seed)).run(steps=60)
    assert {name for name, *_ in log} >= {"match_prefix", "publish_prefix",
                                          "bind", "release"}
    ref = make_pool(cfgs[0], oversubscribe=oversub, package="jax")
    for name, a, kw, out, state in log:
        try:
            want = getattr(ref, name)(*a, **kw)
        except (ValueError, RuntimeError) as e:
            want = (type(e), str(e))
        assert want == out, (name, a, kw)
        assert _state(ref) == state, (name, a, kw)


def test_prefix_boundaries_align_down(cfgs):
    pool = make_pool(cfgs[1])            # chunk 8, block 4: aligned
    assert pool._prefix_boundaries(24) == [8, 16, 24]
    assert pool._prefix_boundaries(7) == []
    pool.prefix_chunk = 6                # unaligned chunk rounds down
    assert pool._prefix_boundaries(24) == [4, 12, 16, 24]


def test_match_caps_below_full_prompt(cfgs):
    """A fully cached prompt still computes its last token's logits: the
    match is capped at len(prompt) - 1, so an exact-length hit misses."""
    pool = make_pool(cfgs[1])
    prompt = np.arange(50, 58, dtype=np.int32)   # 8 tokens == one chunk
    pool.bind(0, 8, row_tokens=12)
    pool.publish_prefix(0, prompt, 8)
    assert pool.match_prefix(prompt, 0) == (0, [])
    n, blks = pool.match_prefix(np.arange(50, 62, dtype=np.int32), 0)
    assert n == 8 and len(blks) == 2


def test_publish_and_share_refcounts(cfgs):
    pool = make_pool(cfgs[1])
    prompt = np.arange(0, 20, dtype=np.int32)
    pool.bind(0, 8, row_tokens=24)
    pool.publish_prefix(0, prompt, 8)
    n, blks = pool.match_prefix(prompt, 0)
    assert (n, len(blks)) == (8, 2)
    assert all(pool.blocks.refcount(b) == 2 for b in blks)  # row + index
    pool.bind(1, 8 + CHUNK, row_tokens=24, prefix=(8, blks))
    assert pool.shared_pages(1) == 2
    assert all(pool.blocks.refcount(b) == 3 for b in blks)
    pool.release(0)                  # publisher leaves; blocks stay live
    assert all(pool.blocks.refcount(b) == 2 for b in blks)
    assert pool.match_prefix(prompt, 0)[0] == 8
    pool.release(1)
    assert all(pool.blocks.refcount(b) == 1 for b in blks)  # index only
    assert pool.evictable_in(0) == len(set(blks))
    check_invariants(pool)


def test_release_errors_distinguish_shared_from_double(cfgs):
    pool = make_pool(cfgs[1])
    with pytest.raises(ValueError, match=r"slot 3 is not bound "
                                         r"\(double release\?\)"):
        pool.release(3)
    prompt = np.arange(0, 20, dtype=np.int32)
    pool.bind(0, 8, row_tokens=24)
    pool.publish_prefix(0, prompt, 8)
    pool.release(0)
    with pytest.raises(ValueError, match=r"slot 0 is already released; "
                                         r"2 of its blocks remain live via "
                                         r"shared references"):
        pool.release(0)
    pool.bind(1, 4, row_tokens=8)
    pool.release(1)
    with pytest.raises(ValueError, match=r"slot 1 is not bound "
                                         r"\(double release\?\)"):
        pool.release(1)


def test_lru_eviction_order_and_counters(cfgs):
    pool = make_pool(cfgs[1], num_blocks=33)
    p1 = np.arange(0, 20, dtype=np.int32)
    p2 = np.arange(40, 60, dtype=np.int32)
    pool.bind(0, 8, row_tokens=24)
    pool.publish_prefix(0, p1, 8)
    pool.bind(1, 8, row_tokens=24)
    pool.publish_prefix(1, p2, 8)
    pool.match_prefix(p1, 0)                     # p1 becomes most recent
    pool.release(0)
    pool.release(1)
    assert pool.prefix_index_entries(0) == 2
    pool._reclaim(0, pool.blocks.free_in(0) + 2)
    assert pool.prefix_evictions == 1            # p2's entry went first
    assert pool.match_prefix(p2, 0) == (0, [])
    assert pool.match_prefix(p1, 0)[0] == 8
    assert pool.memory_stats()["prefix_evictions"] == 1


def test_eviction_keeps_row_shared_blocks(cfgs):
    """Reclaim returns only blocks whose every reference is an index
    reference: an entry shared with a live row goes, its blocks stay."""
    pool = make_pool(cfgs[1], num_blocks=33)
    prompt = np.arange(0, 20, dtype=np.int32)
    pool.bind(0, 8, row_tokens=24)
    pool.publish_prefix(0, prompt, 8)
    n, blks = pool.match_prefix(prompt, 0)
    pool.bind(1, 8 + CHUNK, row_tokens=24, prefix=(n, blks))
    pool.release(0)
    free_before = pool.blocks.free_in(0)
    assert pool.evictable_in(0) == 0             # row 1 still maps them
    pool._reclaim(0, free_before + 1)
    assert pool.prefix_index_entries(0) == 0
    assert pool.blocks.free_in(0) == free_before
    assert all(pool.blocks.refcount(b) == 1 for b in blks)
    check_invariants(pool)


@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_cow_copy_duplicates_device_blocks(cfgs, kv):
    """``_copy_blocks`` copies every paged leaf (int8 KV's scale leaves
    too) bit for bit and touches no other block."""
    cfg = cfgs[1] if kv == "f32" else dataclasses.replace(
        cfgs[1], kv_quant="int8")
    pool = make_pool(cfg)
    src, dst = pool.blocks.alloc(0), pool.blocks.alloc(0)
    gen = torch.Generator().manual_seed(0)
    paged = [(leaf, ax) for leaf, (kind, ax) in
             zip(tree_leaves(pool.cache), tree_leaves(pool._meta))
             if kind == "paged"]
    for leaf, _ in paged:
        if leaf.dtype == torch.int8:
            leaf.copy_(torch.randint(-127, 128, leaf.shape, generator=gen,
                                     dtype=torch.int8))
        else:
            leaf.copy_(torch.randn(leaf.shape, generator=gen))
    before = [leaf.clone() for leaf, _ in paged]
    pool._copy_blocks([src], [dst])
    dtypes = set()
    for (leaf, ax), old in zip(paged, before):
        assert torch.equal(leaf.select(ax, dst), old.select(ax, src))
        keep = [b for b in range(pool.num_blocks) if b != dst]
        assert torch.equal(leaf.index_select(ax, torch.tensor(keep)),
                           old.index_select(ax, torch.tensor(keep)))
        dtypes.add(leaf.dtype)
    assert dtypes == ({torch.int8, torch.float32} if kv == "int8"
                      else {torch.float32})


def test_unaligned_prefix_entry_triggers_cow(cfgs):
    """An index entry whose boundary splits a block (never produced by
    the aligned publisher, but legal) is copied before the new row can
    write into it."""
    pool = make_pool(cfgs[1])
    prompt = np.arange(0, 20, dtype=np.int32)
    pool.bind(0, 8, row_tokens=24)
    pool.publish_prefix(0, prompt, 8)
    blocks = [int(pool.page_table[0, 0]), int(pool.page_table[0, 1])]
    for b in blocks:                 # hand-built unaligned entry
        pool.blocks.ref(b)
        pool._index_refs[b] = pool._index_refs.get(b, 0) + 1
    pool._index[0][pool._prefix_key(prompt, 6)] = \
        PrefixEntry(6, list(blocks), 999)
    check_invariants(pool)
    k = pool.cache["period"]["block0"]["mixer"]["k"]
    k[:, blocks[1]] = 2.5
    pool.bind(1, 8, row_tokens=24, prefix=(6, blocks))
    assert pool.prefix_cow_copies == 1
    assert pool.shared_pages(1) == 1             # only the full block
    assert int(pool.page_table[1, 0]) == blocks[0]
    private = int(pool.page_table[1, 1])
    assert private != blocks[1]
    assert torch.equal(k[:, private], k[:, blocks[1]])
    check_invariants(pool)


def test_bind_rollback_on_exhaustion_leaks_nothing(cfgs):
    """A bind that pins its shared prefix but cannot allocate its fresh
    pages rolls the pins back."""
    pool = make_pool(cfgs[1], num_blocks=9)      # 8 usable blocks + null
    prompt = np.arange(0, 20, dtype=np.int32)
    pool.bind(0, 16, row_tokens=16)
    pool.publish_prefix(0, prompt, 16)           # entries at 8 and 16
    n, blks = pool.match_prefix(prompt, 0)
    assert (n, len(blks)) == (16, 4)
    pool.bind(1, 20, row_tokens=20, prefix=(n, blks))
    pool.bind(2, 12, row_tokens=12)              # drain the free list
    assert pool.blocks.free_in(0) == 0 and pool.evictable_in(0) == 0
    assert not pool.can_admit(20, cached=n, prefix_blocks=blks)
    with pytest.raises(RuntimeError, match="bind without can_admit"):
        pool.bind(3, 20, row_tokens=20, prefix=(n, blks))
    assert pool._row_blocks[3] == []
    assert all(int(b) == NULL_BLOCK for b in pool.page_table[3])
    assert all(pool.blocks.refcount(b) > 0 for b in blks)
    check_invariants(pool)
