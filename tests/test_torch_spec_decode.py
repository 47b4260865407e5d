"""Speculative cascade decoding in the torch port against the JAX package,
on the CPU.

The pieces first: ``ops.spec_accept`` equals the JAX package's epilogue
exactly on seeded inputs; ``transformer.ragged_verify`` equals JAX's
within the f32 model tolerance; a draft tier's ``spec_fn`` (verify
forward, gate over every flat slot, accept epilogue, then the draft
loop, which the port runs for ``max(draft_len) - 1`` steps where JAX
scans ``k - 1``) gives JAX's picks, drafts and KV writes.  Then the
engines, on ``tests/test_spec_decode.py``'s workload (6 prompts, δ = 1
escalates every request, ``spec_delta = 0`` stages every draft): the
port's token streams at k = 2 and 4 equal its k = 0 streams and the JAX
engine's at the same k; its speculation counters, verify outcomes,
ticks and launches equal JAX's; with both tiers on one set of weights
every draft is accepted.  Confidences agree within 1e-8 (the
reference's own test rounds them to 6 decimals: a verify window runs at
another flat width than a one-token step, and in both packages the f32
logits then differ in the last bits).  Each JAX run is made once and shared by the module.
"""
import os

import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jax_ops  # noqa: E402
from repro.models import cache as jax_cache  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import transformer as jax_transformer  # noqa: E402
from repro.serving import CascadeEngine as JaxEngine  # noqa: E402
from repro.serving import TierSpec as JaxTierSpec  # noqa: E402
from repro.serving.engine import VirtualClock as JaxVirtualClock  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve_async  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.params import from_jax  # noqa: E402
from repro_torch.serving import CascadeEngine, TierSpec  # noqa: E402
from repro_torch.serving.engine import VirtualClock  # noqa: E402
from repro_torch.serving.request import RequestState  # noqa: E402
from tests.test_torch_model import (MODELS, _leaves, _np_tree,  # noqa: E402
                                    _plan, configs_of)

FAST = "gemma3-1b"
ENGINE_KW = dict(slots=4, prompt_len=24, gen_len=8, prefill_chunk=8,
                 kv_block_size=4, deltas=[1.0])


# ---------------------------------------------------------------------------
# spec_accept and ragged_verify
# ---------------------------------------------------------------------------


# (q_len per row, k): verify windows of every size up to 1 + k, decode
# rows (q_len 1), idle rows, a padded flat tail, rows longer than 1 + k
# (draft catch-up chunks), a tail row ending on the last flat slot
ACCEPT_CASES = {
    "k4-mixed": ([5, 1, 0, 3, 2, 5], 4),
    "k2-windows": ([3, 3, 1, 3], 2),
    "k4-chunks": ([8, 1, 5, 0], 4),
    "k1-full-width": ([2, 2, 2, 2], 1),
}


@pytest.mark.parametrize("case", sorted(ACCEPT_CASES))
def test_spec_accept_matches_jax(case):
    """Seeded picks over a 4-token vocabulary with the drafted tokens
    mostly equal to the previous slot's argmax: accepted prefixes of
    every length occur, and every output equals JAX's exactly."""
    qlens, k = ACCEPT_CASES[case]
    rng = np.random.default_rng(len(case))
    q_len = np.asarray(qlens, np.int32)
    W = max(8, 1 << (int(q_len.sum()) - 1).bit_length())
    argmax = rng.integers(0, 4, W).astype(np.int32)
    conf = rng.random(W).astype(np.float32)
    flat = rng.integers(0, 4, (1, W)).astype(np.int32)
    agree = rng.random(W - 1) < 0.75
    flat[0, 1:][agree] = argmax[:-1][agree]
    want = jax_ops.spec_accept(jnp.asarray(argmax), jnp.asarray(conf),
                               jnp.asarray(q_len), jnp.asarray(flat), k)
    got = ops.spec_accept(torch.from_numpy(argmax), torch.from_numpy(conf),
                          torch.from_numpy(q_len), torch.from_numpy(flat), k)
    assert got.keys() == want.keys()
    for key in want:
        w = np.asarray(want[key])
        assert got[key].dtype == {np.dtype(np.int32): torch.int32,
                                  np.dtype(np.float32): torch.float32}[
            w.dtype], key
        np.testing.assert_array_equal(got[key].numpy(), w, err_msg=key)
    acc = got["acc_len"].numpy()
    assert (acc <= np.maximum(q_len - 1, 0)).all()
    if case == "k4-mixed":
        assert len(set(acc[q_len > 1])) > 1


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("qlens", [[5, 1, 0, 3], [5, 5, 5, 5]])
def test_ragged_verify_matches_jax(name, qlens):
    """Every live slot's logits ``[1, W, V]`` and the pools the window
    wrote, against ``transformer.ragged_verify`` of the JAX package
    (atol = rtol = 1e-4 on logits, 1e-5 on pools, as the ragged step's
    test)."""
    jcfg, cfg = configs_of(name)
    jp = _np_tree(jax_init_params(jcfg, jax.random.PRNGKey(0), jnp.float32))
    rng = np.random.default_rng(sum(qlens) + len(name))
    R, P, bs = 4, 6, 4
    N, pt, q_len, q_start, toks, pos = _plan(rng, cfg.vocab_size, qlens,
                                             R, P, bs)
    pool = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32),
        _np_tree(jax_cache.init_paged_cache(jcfg, R, N, bs, jnp.float32)))
    pages = {"page_table": pt, "q_len": q_len, "q_start": q_start}
    want, want_c = jax_transformer.ragged_verify(
        jax.tree.map(jnp.asarray, jp), jcfg, jnp.asarray(toks),
        jax.tree.map(jnp.asarray, pool), jnp.asarray(pos),
        jax.tree.map(jnp.asarray, pages))
    got, got_c = transformer.ragged_verify(
        from_jax(jp), cfg, torch.from_numpy(toks), from_jax(pool),
        torch.from_numpy(pos),
        {k: torch.from_numpy(v) for k, v in pages.items()})
    total = int(q_len.sum())
    assert got.shape == (1, toks.shape[1], cfg.vocab_size)
    np.testing.assert_allclose(got.numpy()[0, :total],
                               np.asarray(want)[0, :total],
                               atol=1e-4, rtol=1e-4)
    blk = np.zeros(N, bool)
    blk[pt[q_len > 0].ravel()] = True
    for (k, g), w in zip(_leaves(got_c).items(),
                         _leaves(_np_tree(want_c)).values()):
        np.testing.assert_allclose(g.numpy()[:, blk], w[:, blk],
                                   atol=1e-5, rtol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    """gemma3-1b smoke weights from PRNGKey(0) and (1), as the JAX
    package's speculation tests draw them: (JAX config, port config,
    [(JAX weights, port weights)] per seed)."""
    jcfg, cfg = configs_of(FAST)
    out = []
    for seed in (0, 1):
        jp = _np_tree(jax_init_params(jcfg, jax.random.PRNGKey(seed),
                                      jnp.float32))
        out.append((jp, from_jax(jp)))
    return jcfg, cfg, out


def _prompts(vocab, n=6, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, rng.integers(4, 24)).astype(np.int32)
            for _ in range(n)]


def _engine(weights, package, k, seeds=(0, 1), **kw):
    """A two-tier gemma3 cascade (tier weights from ``seeds``) of the
    given package at speculation_k = k."""
    jcfg, cfg, params = weights
    kw = {**ENGINE_KW, **kw}
    if k:
        kw.setdefault("speculation_k", k)
        kw.setdefault("spec_delta", 0.0)        # stage every drafted token
    if package == "jax":
        return JaxEngine([JaxTierSpec(f"t{i}", jcfg, params[s][0])
                          for i, s in enumerate(seeds)],
                         clock=JaxVirtualClock(), **kw)
    return CascadeEngine([TierSpec(f"t{i}", cfg, params[s][1])
                          for i, s in enumerate(seeds)],
                         clock=VirtualClock(), device="cpu", **kw)


def _drain(eng, prompts):
    eng.warmup()
    for p in prompts:
        eng.submit(p, arrival_time=0.0)
    summary = eng.run(max_steps=800)
    assert all(r.state.name == "DONE" for r in eng.requests)
    return summary


@pytest.fixture(scope="module")
def served(weights):
    """(package, seeds, k) -> (engine, summary) after serving the
    workload, each run made once on first use."""
    cache = {}

    def get(package, k, seeds=(0, 1)):
        key = (package, seeds, k)
        if key not in cache:
            eng = _engine(weights, package, k, seeds)
            cache[key] = (eng, _drain(eng, _prompts(weights[1].vocab_size)))
        return cache[key]
    return get


def _tokens(eng):
    return {r.rid: (r.tier, list(r.tokens), [list(t)
                                             for t in r.tokens_by_tier])
            for r in eng.requests}


def _confs(eng):
    return {r.rid: np.asarray(r.token_conf, np.float64)
            for r in eng.requests}


@pytest.mark.parametrize("k", [2, 4])
def test_spec_streams_match_k0_and_jax(served, k):
    """Token streams (every tier's) bit-identical to the port's k = 0
    and to the JAX engine's at the same k; confidences within 1e-8 of
    k = 0's (a verify window's logits differ from a one-token step's in
    the last bits); drafts were staged and verified."""
    mine, s = served("torch", k)
    base, _ = served("torch", 0)
    ref, _ = served("jax", k)
    assert _tokens(mine) == _tokens(base)
    confs, base_confs = _confs(mine), _confs(base)
    assert confs.keys() == base_confs.keys()
    for rid, c in confs.items():
        np.testing.assert_allclose(c, base_confs[rid], atol=1e-8, rtol=0)
    assert _tokens(mine) == _tokens(ref)
    assert serve_async.stream_checksum(mine) == \
        serve_async.stream_checksum(base)
    for a, b in zip(mine.requests, ref.requests):
        np.testing.assert_allclose(a.token_conf, b.token_conf, rtol=1e-4)
    assert s["speculation"]["drafted"] > 0
    assert s["launches_by_kind"] == [{"spec": n} for n in s["launches"]]
    assert s["speculation"]["draft_steps_by_tier"][0] > 0
    assert s["speculation"]["draft_steps_by_tier"][1] == 0


@pytest.mark.parametrize("k", [2, 4])
def test_spec_counters_match_jax(served, k):
    """The speculation counters, the verify outcomes streamed into the
    draft tier's gate calibration, the ticks and the launches per tier
    equal the JAX engine's."""
    mine, s = served("torch", k)
    ref, js = served("jax", k)
    sp, jsp = s["speculation"], js["speculation"]
    for key in ("drafted", "accepted", "rolled_back", "drafted_by_tier",
                "accepted_by_tier", "rolled_back_by_tier"):
        assert sp[key] == jsp[key], key
    assert sp["drafted"] == sp["accepted"] + sp["rolled_back"]
    cal, jcal = mine.metrics.calibration, ref.metrics.calibration
    assert cal.verify_outcomes == jcal.verify_outcomes
    assert cal.verify_accepts == jcal.verify_accepts
    assert cal.verify_outcomes[0] > 0
    assert s["steps"] == js["steps"]
    assert s["launches"] == js["launches"]
    assert s["host_syncs"] == js["host_syncs"]
    g, jg = s["gate_calibration"][0], js["gate_calibration"][0]
    assert g["verify_accept_rate"] == jg["verify_accept_rate"] or (
        np.isnan(g["verify_accept_rate"])
        and np.isnan(jg["verify_accept_rate"]))
    assert abs(g["ece"] - jg["ece"]) <= 1e-9


def test_self_speculation_accepts_every_draft(served):
    """Both tiers on one set of weights: every draft is accepted (accept
    rate 1 in the counters and in the verify outcomes), the streams equal
    k = 0's, and the run takes fewer ticks and fewer verify-tier
    launches — with JAX's counters."""
    mine, s = served("torch", 4, (0, 0))
    base, s0 = served("torch", 0, (0, 0))
    ref, js = served("jax", 4, (0, 0))
    assert _tokens(mine) == _tokens(base) == _tokens(ref)
    sp = s["speculation"]
    assert sp["drafted"] > 0 and sp["accepted"] == sp["drafted"]
    assert sp["accept_rate"] == 1.0 and sp["rolled_back"] == 0
    assert mine.metrics.calibration.verify_accept_rate(0) == 1.0
    assert s["steps"] < s0["steps"]
    assert s["launches"][1] < s0["launches"][1]
    assert sp["drafted_by_tier"] == js["speculation"]["drafted_by_tier"]


def test_spec_tick_pays_one_launch_and_one_sync(weights):
    """Under speculation each tick still launches at most once and
    fetches at most once per tier (the draft loop's decode steps are
    inside the one launch, its picks fetched with the rest)."""
    eng = _engine(weights, "torch", 4, (0, 0))
    eng.warmup()
    for p in _prompts(weights[1].vocab_size, n=5):
        eng.submit(p, arrival_time=0.0)
    while not all(r.state is RequestState.DONE for r in eng.requests):
        m = eng.metrics
        l0, h0 = list(m.launches_by_tier), list(m.host_syncs_by_tier)
        d0 = list(m.spec_draft_steps_by_tier)
        eng.step()
        dl = [a - b for a, b in zip(m.launches_by_tier, l0)]
        dh = [a - b for a, b in zip(m.host_syncs_by_tier, h0)]
        assert max(dl) <= 1 and all(h <= n for h, n in zip(dh, dl))
        assert m.spec_draft_steps_by_tier[0] - d0[0] <= 3
        assert eng.tick_id < 400
    s = eng.metrics.summary()
    assert s["speculation"]["draft_steps_by_tier"][0] > 0
    assert eng.host_syncs == sum(s["host_syncs"])


def test_drafts_past_the_verifier_vocab_match_jax(weights):
    """A draft tier whose vocabulary (512) is larger than the verify
    tier's (300, as gemma3-1b's 262144 against phi4-mini-3.8b's 200064):
    drafted ids past the verifier's vocabulary are embedded as its last
    id, as the JAX package's clamping gather does, and rejected.  Streams
    equal k = 0's, counters equal JAX's."""
    import dataclasses
    jcfg, cfg, params = weights
    jsmall, small = (dataclasses.replace(c, vocab_size=300)
                     for c in (jcfg, cfg))
    jp = _np_tree(jax_init_params(jsmall, jax.random.PRNGKey(1),
                                  jnp.float32))
    prompts = _prompts(300)

    def run(package, k):
        kw = dict(ENGINE_KW, **({"speculation_k": k, "spec_delta": 0.0}
                                if k else {}))
        if package == "jax":
            eng = JaxEngine([JaxTierSpec("draft", jcfg, params[0][0]),
                             JaxTierSpec("verify", jsmall, jp)],
                            clock=JaxVirtualClock(), **kw)
        else:
            eng = CascadeEngine([TierSpec("draft", cfg, params[0][1]),
                                 TierSpec("verify", small, from_jax(jp))],
                                clock=VirtualClock(), device="cpu", **kw)
        return eng, _drain(eng, prompts)
    (mine, s), (base, _), (ref, js) = run("torch", 4), run("torch", 0), \
        run("jax", 4)
    assert _tokens(mine) == _tokens(base) == _tokens(ref)
    assert s["speculation"] == {**js["speculation"], "draft_steps_by_tier":
                                s["speculation"]["draft_steps_by_tier"]}
    assert s["speculation"]["rolled_back"] > 0


@pytest.mark.parametrize("draft_len", [[0, 4, 2, 0], [0, 2, 1, 3],
                                       [0, 1, 0, 0], [0, 0, 0, 0]])
def test_draft_loop_matches_jax_scan(weights, draft_len):
    """A draft tier's speculative step on one plan — row 0 decodes, rows
    1-3 catch up (3, 1 and 2 tokens) and draft ``draft_len`` tokens —
    against the JAX runtime's ``spec_fn``: the rows' picks, windows and
    accepted counts, every drafted token and confidence, and every block
    of the four rows.  The port runs ``max(draft_len) - 1`` decode steps,
    JAX ``k - 1``; the extra steps' writes all land in the null block."""
    k = 4
    mine = _engine(weights, "torch", k).runtimes[0]
    ref = _engine(weights, "jax", k).runtimes[0]
    assert mine.spec_draft and ref.spec_draft
    rng = np.random.default_rng(sum(draft_len))
    R, P = mine.capacity, mine.pool.page_table.shape[1]
    N = mine.pool.num_blocks
    pt = rng.permutation(np.arange(1, N))[:R * P].reshape(R, P).astype(
        np.int32)
    q_len = np.asarray([1, 3, 1, 2], np.int32)
    q_start = np.asarray([10, 12, 20, 5], np.int32)
    W = 8
    toks = np.zeros((1, W), np.int32)
    pos = np.zeros((1, W), np.int32)
    o = 0
    for b in range(R):
        n = int(q_len[b])
        toks[0, o:o + n] = rng.integers(0, weights[1].vocab_size, n)
        pos[0, o:o + n] = q_start[b] + np.arange(n)
        o += n
    dl = np.asarray(draft_len, np.int32)
    pool = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32), _np_tree(ref.pool.cache))
    mine.pool.cache = from_jax(pool)
    jout = ref.spec_fn(ref.params, jnp.asarray(toks),
                       jax.tree.map(jnp.asarray, pool), jnp.asarray(pos),
                       jnp.asarray(pt), jnp.asarray(q_len),
                       jnp.asarray(q_start), jnp.asarray(dl))
    jtok, jconf, jstok, jsconf, jacc, jdtok, jdconf, jcache = (
        np.asarray(a) if i < 7 else a for i, a in enumerate(jout))
    steps = max(int(dl.max()) - 1, 0)
    out = mine.spec_fn(*(torch.from_numpy(a) for a in (toks, pos, pt, q_len,
                                                       q_start, dl)),
                       steps)
    assert out["draft_tok"].shape == (R, steps + 1)
    np.testing.assert_array_equal(out["tok"].numpy(), jtok)
    np.testing.assert_allclose(out["conf"].numpy(), jconf, rtol=1e-4)
    np.testing.assert_array_equal(out["acc_len"].numpy(), jacc)
    for b in range(R):
        n = int(q_len[b])
        np.testing.assert_array_equal(out["spec_tok"][b, :n].numpy(),
                                      jstok[b, :n])
        d = int(dl[b])
        np.testing.assert_array_equal(out["draft_tok"][b, :d].numpy(),
                                      jdtok[b, :d])
        np.testing.assert_allclose(out["draft_conf"][b, :d].numpy(),
                                   jdconf[b, :d], rtol=1e-4)
    for (key, g), w in zip(_leaves(mine.pool.cache).items(),
                           _leaves(_np_tree(jcache)).values()):
        np.testing.assert_allclose(g.numpy()[:, 1:], w[:, 1:], atol=1e-5,
                                   rtol=1e-5, err_msg=key)


# ---------------------------------------------------------------------------
# configuration and the CLI
# ---------------------------------------------------------------------------


def _two_tiers(weights, name=None):
    cfg = weights[1] if name is None else get_config(name, "smoke")
    if name is None:
        p = weights[2][0][1]
    else:
        jcfg = configs_of(name)[0]
        p = from_jax(_np_tree(jax_init_params(jcfg, jax.random.PRNGKey(0),
                                              jnp.float32)))
    return [TierSpec("draft", cfg, p), TierSpec("verify", weights[1],
                                                weights[2][1][1])]


@pytest.mark.parametrize("case", ["negative-k", "one-tier", "not-ragged",
                                  "spec-delta-without-k", "moe-draft-tier"])
def test_speculation_config_validation(weights, case):
    """The JAX engine's four refusals (``tests/test_spec_decode.py``),
    and the port's own: a draft tier with MoE layers."""
    tiers = _two_tiers(weights)
    kw = dict(ENGINE_KW, device="cpu")
    match, call = {
        "negative-k": (">= 0", lambda: CascadeEngine(
            tiers, speculation_k=-1, **kw)),
        "one-tier": ("two", lambda: CascadeEngine(
            tiers[:1], **dict(kw, deltas=[]), speculation_k=2)),
        "not-ragged": ("ragged", lambda: CascadeEngine(
            tiers, speculation_k=2, use_ragged_step=False, **kw)),
        "spec-delta-without-k": ("spec_delta", lambda: CascadeEngine(
            tiers, spec_delta=0.5, **kw)),
        "moe-draft-tier": ("MoE", lambda: CascadeEngine(
            _two_tiers(weights, "granite-moe-3b-a800m"), speculation_k=2,
            **kw)),
    }[case]
    with pytest.raises(ValueError, match=match):
        call()


def test_cli_speculates_on_cpu(capsys):
    """``--speculate 2`` on the CPU: the streams of ``--speculate 0``,
    drafts staged and verified, the speculation and calibration lines in
    the report; self-speculation (``--expensive gemma3-1b
    --expensive-seed 0``) accepts every draft."""
    base = ["--device", "cpu", "--requests", "4", "--slots", "2",
            "--prompt-len", "12", "--gen-len", "5", "--length-dist",
            "lognormal", "--virtual-clock", "--delta", "1.0"]
    runs = {}
    for flags in ([], ["--speculate", "2", "--spec-delta", "0"],
                  ["--speculate", "2", "--spec-delta", "0", "--expensive",
                   FAST, "--expensive-seed", "0"]):
        s = serve_async.run(serve_async.make_parser().parse_args(
            base + flags), VirtualClock())
        serve_async.report(s)
        runs[len(flags)] = s
    s0, s2, self_spec = runs[0], runs[4], runs[8]
    assert s2["stream_checksum"] == s0["stream_checksum"]
    assert s2["speculation_k"] == 2 and s2["spec_delta"] == 0.0
    assert s0["speculation_k"] == 0 and s0["spec_delta"] is None
    assert s2["speculation"]["drafted"] > 0
    assert self_spec["speculation"]["accept_rate"] == 1.0
    assert self_spec["gate_calibration"][0]["verify_accept_rate"] == 1.0
    out = capsys.readouterr().out
    assert "speculation k=2  accept rate 1.00" in out
    assert "verified, accept 1.00)" in out
    assert "[ragged, speculate 2]" in out
