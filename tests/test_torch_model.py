"""The torch port's model stack against the JAX package, on the CPU.

Weights come from the JAX package's ``init_params`` and cross through
:func:`repro_torch.models.params.from_jax`; inputs and KV pools are
numpy arrays from a seed.  The attention paths are the serving ones —
``ragged_step`` (ragged executor), ``mixed_step`` (padded executor),
``prefill_chunk`` and paged ``decode`` (split executor) — whose kernels
run as their plain versions here.  granite-moe-3b-a800m adds the MoE
FFN, routed by ``router_gate`` (its plain version here).  The uniform
one-shot prefill (``forward(mode="prefill")``, ``flash_attention``;
``rwkv6_scan`` for rwkv6-3b's RWKV-6 layers, ``mamba_scan`` for
jamba-v0.1-52b's Mamba layers) and the dense-arena decode are held to
the JAX package for gemma3-1b, phi4-mini-3.8b, rwkv6-3b, jamba-smoke (two
Mamba layers, dense and MoE FFNs) and a narrow 8-layer jamba period
(attention at layer 4 among 7 Mamba layers, MoE on the odd layers),
part-cache tree included.
"""
import dataclasses
import functools
import os

import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.models import blocks as jax_blocks  # noqa: E402
from repro.models import cache as jax_cache  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import transformer as jax_transformer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import blocks, params, transformer  # noqa: E402
from repro_torch.models import cache as cache_lib  # noqa: E402
from repro_torch.models.cache import init_paged_cache  # noqa: E402

MODELS = ("gemma3-1b", "phi4-mini-3.8b", "granite-moe-3b-a800m")
JAMBA = "jamba-v0.1-52b"
HYBRID = "jamba-narrow-period"


def narrow_hybrid(configs):
    """One period of jamba-v0.1-52b (the attention layer at index 4 among
    7 Mamba layers, MoE FFNs on the odd layers) at d_model 64 with the
    smoke variant's Mamba (d_state 8), experts and FFN widths, built
    from ``configs`` — ``repro.configs`` or ``repro_torch.configs``,
    which give the same configuration."""
    full = configs.get_config(JAMBA, "")
    smoke = configs.get_config(JAMBA, "smoke")
    mamba, dense, moe = (smoke.period[0].mixer, smoke.period[0].ffn,
                         smoke.period[1].ffn)
    period = tuple(configs.Layer(
        l.mixer if l.mixer.kind == "attn" else mamba,
        moe if l.ffn.kind == "moe" else dense) for l in full.period)
    return dataclasses.replace(smoke, name=HYBRID, d_model=64, num_heads=2,
                               num_kv_heads=1, head_dim=32, period=period)


def configs_of(name):
    """(JAX config, port config) at the smoke widths, or the narrow
    hybrid period."""
    import repro.configs
    import repro_torch.configs
    if name == HYBRID:
        return (narrow_hybrid(repro.configs),
                narrow_hybrid(repro_torch.configs))
    return jax_get_config(name, "smoke"), get_config(name, "smoke")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.fixture(scope="module", params=MODELS)
def model(request):
    name = request.param
    jcfg = jax_get_config(name, "smoke")
    jp = _np_tree(jax_init_params(jcfg, jax.random.PRNGKey(0), jnp.float32))
    return name, jcfg, get_config(name, "smoke"), jp, params.from_jax(jp)


def test_configs_are_the_reference_configs():
    for name in MODELS:
        for variant in ("", "smoke", "long"):
            mine = dataclasses.asdict(get_config(name, variant))
            ref = dataclasses.asdict(jax_get_config(name, variant))
            assert mine == ref, (name, variant)


def test_from_jax_round_trip(model):
    """Same keys, shapes and values both ways; the port's declaration
    (and its own init) has the JAX tree's keys and shapes."""
    name, _, cfg, jp, tp = model
    jl, tl = _leaves(jp), _leaves(tp)
    assert jl.keys() == tl.keys()
    for k in jl:
        assert tl[k].dtype == torch.float32
        np.testing.assert_array_equal(tl[k].numpy(), jl[k])
    decl = _leaves(params.declare_model(cfg))
    mine = _leaves(params.init_params(cfg, 0, device="cpu"))
    assert decl.keys() == jl.keys() == mine.keys()
    for k in jl:
        assert tuple(decl[k].shape) == jl[k].shape == tuple(mine[k].shape)
    assert params.param_count_from_decl(cfg) == cfg.param_count()


def test_init_params_rules():
    cfg = get_config("phi4-mini-3.8b", "smoke")
    p = params.init_params(cfg, 3, device="cpu")
    assert torch.equal(p["final_norm"], torch.ones(cfg.d_model))
    assert torch.equal(p["period"]["block0"]["norm1"],
                       torch.ones(cfg.num_periods, cfg.d_model))
    assert abs(p["embed"].std().item() - 0.02) < 0.002
    wq = p["period"]["block0"]["mixer"]["wq"]     # fan-in of d_model
    assert abs(wq.std().item() - cfg.d_model ** -0.5) < 0.1 * \
        cfg.d_model ** -0.5
    again = params.init_params(cfg, 3, device="cpu")
    assert torch.equal(again["embed"], p["embed"])   # seeded


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_dense_ffn_matches_jax(act):
    rng = np.random.default_rng(0)
    d, f = 32, 48
    spec = dataclasses.replace(
        jax_get_config("gemma3-1b", "smoke").period[0].ffn, d_ff=f, act=act)
    names = ("wi0", "wi1", "wo") if act == "swiglu" else ("wi", "wo")
    p = {n: rng.standard_normal((f, d) if n == "wo" else (d, f)).astype(
        np.float32) * 0.2 for n in names}
    x = rng.standard_normal((1, 5, d)).astype(np.float32)
    want, _, _ = jax_blocks.dense_ffn(
        {k: jnp.asarray(v) for k, v in p.items()}, None, spec,
        jnp.asarray(x), None, "ragged_step")
    got = blocks.dense_ffn({k: torch.from_numpy(v) for k, v in p.items()},
                           None, spec, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_rmsnorm_rope_and_quant_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 6, 4, 32)).astype(np.float32)
    sc = rng.standard_normal(32).astype(np.float32)
    np.testing.assert_allclose(
        blocks.rmsnorm(torch.from_numpy(x), torch.from_numpy(sc)).numpy(),
        np.asarray(jax_blocks.rmsnorm(jnp.asarray(x), jnp.asarray(sc))),
        rtol=1e-6, atol=1e-6)
    cfg = get_config("gemma3-1b", "smoke")
    pos = np.array([[0, 1, 7, 300, 511, 640]], np.int32)
    k = x[:, :, :1]
    got = blocks.apply_rope(torch.from_numpy(x), torch.from_numpy(k),
                            torch.from_numpy(pos), cfg, "rope")
    want = jax_blocks.apply_rope(jnp.asarray(x), jnp.asarray(k),
                                 jnp.asarray(pos), jax_get_config(
                                     "gemma3-1b", "smoke"), "rope")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5)
    gq, gs = blocks._quant_i8(torch.from_numpy(x))
    wq, ws = jax_blocks._quant_i8(jnp.asarray(x))
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-7)


def test_init_params_rules_moe():
    """The router at ``normal:0.02``; an expert leaf [E, d, F] takes the
    JAX package's fan-in of every dim but the last, E·d (per period)."""
    cfg = get_config("granite-moe-3b-a800m", "smoke")
    f = cfg.period[0].ffn
    E, d = f.num_experts, cfg.d_model
    p = params.init_params(cfg, 5, device="cpu")["period"]["block0"]["ffn"]
    assert tuple(p["router"].shape) == (cfg.num_periods, d, E)
    assert abs(p["router"].std().item() - 0.02) < 0.004
    for name, fan_in in (("wi0", E * d), ("wi1", E * d),
                         ("wo", E * f.d_ff)):
        assert p[name].shape[1] == E
        std = p[name].std().item()
        assert abs(std - fan_in ** -0.5) < 0.05 * fan_in ** -0.5, name


def _moe_case(rng, E, K, cf, act="swiglu", d=32, f=16):
    spec = dataclasses.replace(
        jax_get_config("granite-moe-3b-a800m", "smoke").period[0].ffn,
        num_experts=E, top_k=K, capacity_factor=cf, d_ff=f, act=act)
    names = ("wi0", "wi1", "wo") if act == "swiglu" else ("wi", "wo")
    p = {"router": rng.standard_normal((d, E)).astype(np.float32)}
    for n in names:
        shape = (E, f, d) if n == "wo" else (E, d, f)
        p[n] = (rng.standard_normal(shape) * 0.2).astype(np.float32)
    return spec, p


def _moe_dropped(x, p, spec):
    """How many (token, pick) pairs overflow their expert's capacity
    (one group: N <= 1024), counted in numpy from the JAX routing."""
    N = x.shape[0] * x.shape[1]
    E, K = spec.num_experts, spec.top_k
    cap = min(N, max(1, int(np.ceil(N * K * spec.capacity_factor / E))))
    _, idx = jax_ref.router_gate_ref(
        jnp.asarray(x.reshape(N, -1) @ p["router"]), K)
    return int(np.maximum(np.bincount(np.asarray(idx).ravel(),
                                      minlength=E) - cap, 0).sum())


@pytest.mark.parametrize("cf,act,shape", [
    (1.0, "swiglu", (2, 12)),     # cap 6 of 24 tokens x 2 picks: drops
    (2.0, "swiglu", (3, 8)),      # cap = group size: nothing dropped
    (1.0, "gelu", (1, 24)),
    (0.5, "swiglu", (4, 6)),      # cap 3: most pairs dropped
])
def test_moe_ffn_matches_jax(cf, act, shape):
    """The port's ``moe_ffn`` (index dispatch/combine, the router kernel's
    plain version) against the JAX ``moe_ffn`` (one-hot einsums,
    ``lax.top_k``) with E = 8, k = 2, within atol = rtol = 1e-5 (only the
    order of the combine's sum differs)."""
    rng = np.random.default_rng(int(cf * 10) + len(act))
    spec, p = _moe_case(rng, 8, 2, cf, act)
    x = rng.standard_normal(shape + (32,)).astype(np.float32)
    want, _, aux = jax_blocks.moe_ffn(
        {k: jnp.asarray(v) for k, v in p.items()}, None, spec,
        jnp.asarray(x), None, "ragged_step")
    got = blocks.moe_ffn({k: torch.from_numpy(v) for k, v in p.items()},
                         None, spec, torch.from_numpy(x))
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    dropped = _moe_dropped(x, p, spec)
    assert (dropped > 0) == (cf < 2.0), dropped
    assert set(aux) == {"lb_loss", "z_loss"}    # JAX only: not served


def test_moe_ffn_groups_and_padding_tokens_match_jax():
    """N = 2048 token slots split into two groups of 1024, each with its
    own capacity; the port's padding slots route and fill queues as
    JAX's do."""
    rng = np.random.default_rng(7)
    spec, p = _moe_case(rng, 4, 2, 1.0, d=16, f=8)
    x = rng.standard_normal((4, 512, 16)).astype(np.float32)
    x[1, 100:] = x[0, 0]                        # repeated padding rows
    want, _, _ = jax_blocks.moe_ffn(
        {k: jnp.asarray(v) for k, v in p.items()}, None, spec,
        jnp.asarray(x), None, "mixed_step")
    got = blocks.moe_ffn({k: torch.from_numpy(v) for k, v in p.items()},
                         None, spec, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# --------------------------------------------------------------------------
# ragged step
# --------------------------------------------------------------------------


def _plan(rng, vocab, qlens, R, P, bs):
    """A random ragged plan: page tables, per-row starts, flat tokens."""
    N = R * P + 1
    pt = rng.permutation(np.arange(1, N))[:R * P].reshape(R, P).astype(
        np.int32)
    q_len = np.asarray(qlens, np.int32)
    q_start = np.asarray([int(rng.integers(0, P * bs - max(q_len) + 1))
                          for _ in range(R)], np.int32)
    total = int(q_len.sum())
    W = max(8, 1 << (max(total, 1) - 1).bit_length())
    toks = np.zeros((1, W), np.int32)
    pos = np.zeros((1, W), np.int32)
    o = 0
    for b in range(R):
        n = int(q_len[b])
        toks[0, o:o + n] = rng.integers(0, vocab, n)
        pos[0, o:o + n] = q_start[b] + np.arange(n)
        o += n
    return N, pt, q_len, q_start, toks, pos


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_attention_ragged_step_matches_jax(model, kv_quant):
    """One attention layer in ragged_step mode: the output and every pool
    row a live token wrote (block 0 takes the padding writes and is never
    compared)."""
    name, jcfg, cfg, jp, tp = model
    jcfg = dataclasses.replace(jcfg, kv_quant=kv_quant)
    cfg = dataclasses.replace(cfg, kv_quant=kv_quant)
    rng = np.random.default_rng(2)
    R, P, bs = 4, 6, 4
    N, pt, q_len, q_start, _, pos = _plan(rng, cfg.vocab_size,
                                          [5, 0, 1, 7], R, P, bs)
    W = pos.shape[1]
    x = rng.standard_normal((1, W, cfg.d_model)).astype(np.float32)
    pool = _np_tree(jax_cache.init_paged_cache(jcfg, R, N, bs,
                                               jnp.float32))
    pool = pool["period"]["block0"]["mixer"]
    pool = {k: v[0] for k, v in pool.items()}
    for k in ("k", "v"):
        pool[k] = (rng.integers(-127, 128, pool[k].shape).astype(np.int8)
                   if kv_quant else
                   rng.standard_normal(pool[k].shape).astype(np.float32))
    for k in ("k_scale", "v_scale"):
        if k in pool:
            pool[k] = rng.uniform(0.01, 0.05, pool[k].shape).astype(
                np.float32)
    lp = jax.tree.map(lambda a: a[0], jp["period"]["block0"]["mixer"])
    spec = cfg.period[0].mixer
    pages = {"page_table": pt, "q_len": q_len, "q_start": q_start}
    want_y, want_c = jax_blocks.attention(
        jax.tree.map(jnp.asarray, lp), jcfg, jcfg.period[0].mixer,
        jnp.asarray(x), jax.tree.map(jnp.asarray, pool), jnp.asarray(pos),
        "ragged_step", pages=jax.tree.map(jnp.asarray, pages))
    tcache = {k: torch.from_numpy(v.copy()) for k, v in pool.items()}
    got_y, got_c = blocks.attention(
        params.from_jax(lp), cfg, spec, torch.from_numpy(x), tcache,
        torch.from_numpy(pos), "ragged_step",
        pages={k: torch.from_numpy(v) for k, v in pages.items()})
    assert got_c is tcache                      # updated in place
    total = int(q_len.sum())
    np.testing.assert_allclose(got_y.numpy()[0, :total],
                               np.asarray(want_y)[0, :total],
                               rtol=1e-4, atol=1e-4)
    live = np.zeros(N, bool)
    live[pt[q_len > 0].ravel()] = True           # blocks of live rows
    for k in pool:
        np.testing.assert_allclose(
            got_c[k].numpy()[live], np.asarray(want_c[k])[live],
            rtol=1e-5, atol=1e-5, err_msg=k)
    written = got_c["k"].numpy()[live] != pool["k"][live]
    assert written.any()


@pytest.mark.parametrize("qlens", [[5, 0, 1, 7], [1, 1, 1, 1], [8, 8, 0, 0],
                                   [0, 0, 3, 0]])
def test_ragged_step_logits_match_jax(model, qlens):
    """Last-slot logits of a whole ragged step on live rows, plus the KV
    pools it wrote, against ``transformer.ragged_step`` of the JAX
    package."""
    name, jcfg, cfg, jp, tp = model
    rng = np.random.default_rng(sum(qlens))
    R, P, bs = 4, 6, 4
    N, pt, q_len, q_start, toks, pos = _plan(rng, cfg.vocab_size, qlens,
                                             R, P, bs)
    pool = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32),
        _np_tree(jax_cache.init_paged_cache(jcfg, R, N, bs, jnp.float32)))
    pages = {"page_table": pt, "q_len": q_len, "q_start": q_start}
    want, want_c = jax_transformer.ragged_step(
        jax.tree.map(jnp.asarray, jp), jcfg, jnp.asarray(toks),
        jax.tree.map(jnp.asarray, pool), jnp.asarray(pos),
        jax.tree.map(jnp.asarray, pages))
    tcache = params.from_jax(pool)
    got, got_c = transformer.ragged_step(
        tp, cfg, torch.from_numpy(toks), tcache, torch.from_numpy(pos),
        {k: torch.from_numpy(v) for k, v in pages.items()})
    live = q_len > 0
    assert got.shape == (R, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                               atol=1e-4, rtol=1e-4)
    blk = np.zeros(N, bool)
    blk[pt[live].ravel()] = True
    for (k, g), w in zip(_leaves(got_c).items(),
                         _leaves(_np_tree(want_c)).values()):
        np.testing.assert_allclose(g.numpy()[:, blk], w[:, blk],
                                   atol=1e-5, rtol=1e-5, err_msg=k)


def test_last_slot_gather_matches_jax():
    rng = np.random.default_rng(4)
    flat = rng.standard_normal((1, 16, 9)).astype(np.float32)
    padded = rng.standard_normal((4, 16, 9)).astype(np.float32)
    for q_len in ([3, 0, 5, 2], [0, 0, 0, 0], [16, 0, 0, 0]):
        q_len = np.asarray(q_len, np.int32)
        for logits, is_flat in ((flat, True), (padded, False)):
            want = jax_transformer.last_slot_gather(
                jnp.asarray(logits), jnp.asarray(q_len), flat=is_flat)
            got = transformer.last_slot_gather(torch.from_numpy(logits),
                                               torch.from_numpy(q_len),
                                               flat=is_flat)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------------------------
# padded and split steps
# --------------------------------------------------------------------------


def _random_pool(rng, jcfg, R, N, bs):
    """Random KV pools (int8 values with small positive scales for an
    int8 cache)."""
    def fill(path, a):
        if a.dtype == np.int8:
            return rng.integers(-127, 128, a.shape).astype(np.int8)
        if "scale" in jax.tree_util.keystr(path):
            return rng.uniform(0.01, 0.05, a.shape).astype(np.float32)
        return rng.standard_normal(a.shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(
        fill, _np_tree(jax_cache.init_paged_cache(jcfg, R, N, bs,
                                                  jnp.float32)))


def _check_pools(got_c, want_c):
    """Every pool block but the null block 0, which takes the dead slots'
    duplicate writes."""
    for (k, g), w in zip(_leaves(got_c).items(),
                         _leaves(_np_tree(want_c)).values()):
        np.testing.assert_allclose(g.numpy()[:, 1:], w[:, 1:], atol=1e-5,
                                   rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("mode", ["mixed_step", "prefill_chunk"])
@pytest.mark.parametrize("qlens,kv_quant", [
    ([5, 0, 1, 7], None),       # chunk, idle, decode, full width
    ([1, 1, 1, 1], None),       # decode-only rows at chunk width
    ([7, 3, 0, 1], "int8"),     # tail rows over int8 pools
])
def test_padded_step_logits_match_jax(model, mode, qlens, kv_quant):
    """A padded ``[B, C]`` step (``mixed_step``, or the split executor's
    ``prefill_chunk``) against the JAX package: the logits of live slots
    and every pool block it wrote."""
    name, jcfg, cfg, jp, tp = model
    jcfg = dataclasses.replace(jcfg, kv_quant=kv_quant)
    cfg = dataclasses.replace(cfg, kv_quant=kv_quant)
    rng = np.random.default_rng(sum(qlens) + len(mode))
    R, P, bs, C = 4, 6, 4, 7
    N = R * P + 1
    pt = rng.permutation(np.arange(1, N))[:R * P].reshape(R, P).astype(
        np.int32)
    q_len = np.asarray(qlens, np.int32)
    q_start = rng.integers(0, P * bs - C + 1, R).astype(np.int32)
    pos = (q_start[:, None] + np.arange(C)).astype(np.int32)
    toks = rng.integers(0, cfg.vocab_size, (R, C)).astype(np.int32)
    pool = _random_pool(rng, jcfg, R, N, bs)
    pages = {"page_table": pt, "q_len": q_len}
    want, want_c = getattr(jax_transformer, mode)(
        jax.tree.map(jnp.asarray, jp), jcfg, jnp.asarray(toks),
        jax.tree.map(jnp.asarray, pool), jnp.asarray(pos),
        jax.tree.map(jnp.asarray, pages))
    got, got_c = getattr(transformer, mode)(
        tp, cfg, torch.from_numpy(toks), params.from_jax(pool),
        torch.from_numpy(pos),
        {k: torch.from_numpy(v) for k, v in pages.items()})
    if mode == "mixed_step":
        live = q_len > 0                        # last-slot logits [B, V]
        assert got.shape == (R, cfg.vocab_size)
    else:
        live = np.arange(C)[None, :] < q_len[:, None]   # [B, C, V]
        assert got.shape == (R, C, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                               atol=1e-4, rtol=1e-4)
    _check_pools(got_c, want_c)


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_paged_decode_step_logits_match_jax(model, kv_quant):
    """The split executor's decode launch, ``decode_step(pages=)``, with
    one row masked to the null block as a mid-prefill row is: live rows'
    logits and every pool block but the null one against the JAX
    package."""
    name, jcfg, cfg, jp, tp = model
    jcfg = dataclasses.replace(jcfg, kv_quant=kv_quant)
    cfg = dataclasses.replace(cfg, kv_quant=kv_quant)
    rng = np.random.default_rng(11)
    R, P, bs = 5, 6, 4
    N = R * P + 1
    pt = rng.permutation(np.arange(1, N))[:R * P].reshape(R, P).astype(
        np.int32)
    pt[2] = 0                                   # masked row
    pos = rng.integers(0, P * bs, (R, 1)).astype(np.int32)
    toks = rng.integers(0, cfg.vocab_size, (R, 1)).astype(np.int32)
    pool = _random_pool(rng, jcfg, R, N, bs)
    want, want_c = jax_transformer.decode_step(
        jax.tree.map(jnp.asarray, jp), jcfg, jnp.asarray(toks),
        jax.tree.map(jnp.asarray, pool), jnp.asarray(pos),
        pages={"page_table": jnp.asarray(pt)})
    got, got_c = transformer.decode_step(
        tp, cfg, torch.from_numpy(toks), params.from_jax(pool),
        torch.from_numpy(pos), pages={"page_table": torch.from_numpy(pt)})
    live = np.ones(R, bool)
    live[2] = False
    assert got.shape == (R, 1, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                               atol=1e-4, rtol=1e-4)
    _check_pools(got_c, want_c)


def with_capacity(cfg, cf):
    """``cfg`` with every MoE layer's capacity factor set to ``cf``."""
    return dataclasses.replace(cfg, period=tuple(
        dataclasses.replace(l, ffn=dataclasses.replace(
            l.ffn, capacity_factor=cf)) for l in cfg.period))


@pytest.mark.parametrize("mode", ["ragged_step", "mixed_step",
                                  "prefill_chunk"])
def test_moe_steps_with_drops_match_jax(mode):
    """granite's smoke stack at capacity factor 0.5 (cap = a quarter of
    the group's slots, so experts drop pairs, padding slots' included):
    the live slots' logits against the JAX package, atol = rtol = 1e-4."""
    name = "granite-moe-3b-a800m"
    jcfg = with_capacity(jax_get_config(name, "smoke"), 0.5)
    cfg = with_capacity(get_config(name, "smoke"), 0.5)
    jp = _np_tree(jax_init_params(jcfg, jax.random.PRNGKey(1), jnp.float32))
    rng = np.random.default_rng(len(mode))
    R, P, bs, C = 4, 6, 4, 7
    if mode == "ragged_step":
        N, pt, q_len, q_start, toks, pos = _plan(rng, cfg.vocab_size,
                                                 [5, 0, 1, 7], R, P, bs)
        pages = {"page_table": pt, "q_len": q_len, "q_start": q_start}
        live = q_len > 0
    else:
        N = R * P + 1
        pt = rng.permutation(np.arange(1, N))[:R * P].reshape(R, P).astype(
            np.int32)
        q_len = np.asarray([5, 0, 1, 7], np.int32)
        q_start = rng.integers(0, P * bs - C + 1, R).astype(np.int32)
        pos = (q_start[:, None] + np.arange(C)).astype(np.int32)
        toks = rng.integers(0, cfg.vocab_size, (R, C)).astype(np.int32)
        pages = {"page_table": pt, "q_len": q_len}
        live = (q_len > 0 if mode == "mixed_step"
                else np.arange(C)[None, :] < q_len[:, None])
    pool = _random_pool(rng, jcfg, R, N, bs)
    want, _ = getattr(jax_transformer, mode)(
        jax.tree.map(jnp.asarray, jp), jcfg, jnp.asarray(toks),
        jax.tree.map(jnp.asarray, pool), jnp.asarray(pos),
        jax.tree.map(jnp.asarray, pages))
    got, _ = getattr(transformer, mode)(
        params.from_jax(jp), cfg, torch.from_numpy(toks),
        params.from_jax(pool), torch.from_numpy(pos),
        {k: torch.from_numpy(v) for k, v in pages.items()})
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                               atol=1e-4, rtol=1e-4)


def test_dense_caches_are_not_ported(model):
    """Dense caches are served now (see the prefill/decode parity tests
    below); what stays refused is a block pool handed to the dense decode
    without its page tables — its block dim is not a row per request."""
    name, _, cfg, _, tp = model
    cache = init_paged_cache(cfg, 2, 5, 4, torch.float32, "cpu")
    tok = torch.zeros(2, 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="dense decode"):
        transformer.decode_step(tp, cfg, tok, cache, tok)
    with pytest.raises(ValueError, match="requires pages"):
        transformer.forward(tp, cfg, {"tokens": tok}, mode="mixed_step",
                            cache=cache, pos=tok)


def test_init_paged_cache_layout(model):
    name, jcfg, cfg, _, _ = model
    for quant in (None, "int8"):
        jc = jax_cache.init_paged_cache(
            dataclasses.replace(jcfg, kv_quant=quant), 3, 9, 4, jnp.float32)
        tc = init_paged_cache(dataclasses.replace(cfg, kv_quant=quant), 3, 9,
                              4, torch.float32, "cpu")
        jl, tl = _leaves(_np_tree(jc)), _leaves(tc)
        assert jl.keys() == tl.keys()
        for k in jl:
            assert tuple(tl[k].shape) == jl[k].shape
            assert str(tl[k].dtype).split(".")[-1] == str(jl[k].dtype)
            assert not tl[k].any()


# --------------------------------------------------------------------------
# uniform one-shot prefill and the dense arena
# --------------------------------------------------------------------------


UNIFORM_MODELS = ("gemma3-1b", "phi4-mini-3.8b", "rwkv6-3b")
# (model, kv_quant): rwkv6-3b and jamba-smoke (two Mamba layers) have no
# KV cache to quantise; the narrow hybrid period has one attention layer
UNIFORM_CASES = [(n, q) for n in UNIFORM_MODELS for q in (None, "int8")
                 if not (q and n == "rwkv6-3b")] + [
    (JAMBA, None), (HYBRID, None), (HYBRID, "int8")]


@functools.lru_cache(maxsize=None)
def _uniform_weights(name):
    jcfg = configs_of(name)[0]
    return jcfg, _np_tree(jax_init_params(jcfg, jax.random.PRNGKey(2),
                                          jnp.float32))


def uniform_model(name, kv_quant):
    """(name, JAX config, port config, JAX weights, port weights)."""
    jcfg, jp = _uniform_weights(name)
    return (name, dataclasses.replace(jcfg, kv_quant=kv_quant),
            dataclasses.replace(configs_of(name)[1], kv_quant=kv_quant),
            jp, params.from_jax(jp))


def _check_tree(got, want, atol, rtol=1e-5):
    got, want = _leaves(got), _leaves(_np_tree(want))
    assert got.keys() == want.keys()
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy().astype(np.float32),
                                   want[k].astype(np.float32), atol=atol,
                                   rtol=rtol, err_msg=k)


@pytest.mark.parametrize("name,kv_quant", UNIFORM_CASES)
def test_prefill_matches_jax(name, kv_quant):
    """``forward(mode="prefill")`` (gemma3's window 16 < S = 21 in its
    sliding layers) against the JAX package: the last position's logits
    (all the port computes) within 1e-4, and the part-cache tree leaf for
    leaf (k/v after RoPE, or int8 with scales: an int8 value may sit one
    step off where the f32 keys differ by float noise at a rounding
    midpoint; RWKV-6 ``x_prev`` and final ``state``; Mamba ``conv`` and
    final ``ssm``) within 1e-5."""
    name, jcfg, cfg, jp, tp = uniform_model(name, kv_quant)
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (3, 21)).astype(np.int32)
    want, want_c, _ = jax_transformer.forward(
        jax.tree.map(jnp.asarray, jp), jcfg, {"tokens": jnp.asarray(toks)},
        mode="prefill")
    got, got_c = transformer.prefill(tp, cfg, {"tokens":
                                               torch.from_numpy(toks)})
    assert got.shape == (3, 1, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, -1:],
                               atol=1e-4, rtol=1e-4)
    _check_tree(got_c, want_c, atol=1.0 if kv_quant else 1e-5)


def _dense_from_part(jcfg, part, B, T):
    """A dense ``[B, T]`` arena with a prefill's part cache in its first
    positions (numpy), and random values past them."""
    rng = np.random.default_rng(7)
    full = _np_tree(jax_cache.init_cache(jcfg, B, T, jnp.float32))

    def put(f, p):
        p = np.asarray(p)
        if f.shape == p.shape:
            return p.copy()
        out = (rng.standard_normal(f.shape) if f.dtype != np.int8 else
               rng.integers(-127, 128, f.shape)).astype(f.dtype)
        out[tuple(slice(0, n) for n in p.shape)] = p
        return out
    return jax.tree.map(put, full, _np_tree(part))


@pytest.mark.parametrize("name,kv_quant", UNIFORM_CASES)
def test_dense_decode_step_matches_jax(name, kv_quant):
    """``decode_step(pages=None)`` over the dense arena after a prefill,
    rows at different positions (one behind, so it overwrites a prompt
    position): logits within 1e-4 and the whole updated cache — the
    written KV position, the RWKV-6 state and token-shift leaves and the
    Mamba ``conv`` window and ``ssm`` state stepped in place — within
    1e-5.  An int8 arena's probabilities meet the
    values in bf16 on both sides, rounded at the same places."""
    name, jcfg, cfg, jp, tp = uniform_model(name, kv_quant)
    rng = np.random.default_rng(4)
    B, S, T = 3, 21, 30
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    _, part, _ = jax_transformer.forward(
        jax.tree.map(jnp.asarray, jp), jcfg, {"tokens": jnp.asarray(toks)},
        mode="prefill")
    full = _dense_from_part(jcfg, part, B, T)
    tok = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    pos = np.asarray([[S], [S - 3], [S + 4]], np.int32)
    want, want_c = jax_transformer.decode_step(
        jax.tree.map(jnp.asarray, jp), jcfg, jnp.asarray(tok),
        jax.tree.map(jnp.asarray, full), jnp.asarray(pos))
    cache = params.from_jax(full)
    got, got_c = transformer.decode_step(tp, cfg, torch.from_numpy(tok),
                                         cache, torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    _check_tree(got_c, want_c, atol=1e-5)
    _check_tree(cache, want_c, atol=1e-5)       # updated in place


def test_rwkv6_block_matches_jax():
    """The RWKV-6 time mix alone (``rwkv6_scan_ref`` inside) over T =
    130, past the TPU kernel's 128-step chunk: the output and the new
    cache — the final state ``S_T`` — against the JAX block's prefill,
    then one decode step from that cache; and the chunked modes raise as
    in the JAX package."""
    jcfg = jax_get_config("rwkv6-3b", "smoke")
    cfg = get_config("rwkv6-3b", "smoke")
    spec = cfg.period[0].mixer
    jp = _np_tree(jax_init_params(jcfg, jax.random.PRNGKey(5),
                                  jnp.float32))["period"]
    p = {k: v[0] for k, v in jp["block0"]["mixer"].items()}
    x = np.random.default_rng(6).standard_normal(
        (1, 130, cfg.d_model)).astype(np.float32)
    want, want_c = jax_blocks.rwkv6(
        {k: jnp.asarray(v) for k, v in p.items()}, jcfg, spec,
        jnp.asarray(x), None, None, "prefill")
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    got, got_c = blocks.rwkv6(tp, cfg, spec, torch.from_numpy(x), None,
                              None, "prefill")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    _check_tree(got_c, want_c, atol=1e-5)
    x1 = x[:, :1] * 0.5
    want1, want_c1 = jax_blocks.rwkv6(
        {k: jnp.asarray(v) for k, v in p.items()}, jcfg, spec,
        jnp.asarray(x1), want_c, None, "decode")
    got1, got_c1 = blocks.rwkv6(tp, cfg, spec, torch.from_numpy(x1),
                                {k: v.clone() for k, v in got_c.items()},
                                None, "decode")
    np.testing.assert_allclose(got1.numpy(), np.asarray(want1), atol=1e-5,
                               rtol=1e-5)
    _check_tree(got_c1, want_c1, atol=1e-5)
    for mode in ("ragged_step", "mixed_step", "prefill_chunk"):
        with pytest.raises(NotImplementedError, match="uniform"):
            blocks.rwkv6(tp, cfg, spec, torch.from_numpy(x1), got_c, None,
                         mode)


def test_rwkv_caches_match_jax_layout():
    """rwkv6-3b's dense and paged caches: the JAX keys, shapes and dtypes
    (recurrent leaves keep one row per request in the paged cache), and
    ``has_recurrent_state`` as the JAX package decides it."""
    for name in UNIFORM_MODELS + ("granite-moe-3b-a800m",):
        jcfg, cfg = jax_get_config(name, "smoke"), get_config(name, "smoke")
        assert cache_lib.has_recurrent_state(cfg) == \
            jax_cache.has_recurrent_state(jcfg) == (name == "rwkv6-3b")
        for jc, tc in (
                (jax_cache.init_cache(jcfg, 3, 7, jnp.float32),
                 cache_lib.init_cache(cfg, 3, 7, torch.float32, "cpu")),
                (jax_cache.init_paged_cache(jcfg, 3, 9, 4, jnp.float32),
                 init_paged_cache(cfg, 3, 9, 4, torch.float32, "cpu"))):
            jl, tl = _leaves(_np_tree(jc)), _leaves(tc)
            assert jl.keys() == tl.keys()
            for k in jl:
                assert tuple(tl[k].shape) == jl[k].shape
                assert str(tl[k].dtype).split(".")[-1] == str(jl[k].dtype)


def test_rwkv_params_match_jax_declaration():
    """rwkv6-3b's parameter tree: the JAX keys and shapes at the smoke and
    published widths (3.07 B parameters), and ``from_jax`` round trip."""
    from repro.models import params as jax_params
    for variant in ("smoke", ""):
        jd = jax_params.declare_model(jax_get_config("rwkv6-3b", variant))
        td = params.declare_model(get_config("rwkv6-3b", variant))
        jl = _leaves(jax.tree.map(lambda p: p.shape, jd,
                                  is_leaf=lambda x: isinstance(
                                      x, jax_params.P)))
        tl = _leaves(params.tree_map(lambda p: p.shape, td))
        assert jl == tl
    assert params.param_count_from_decl(get_config("rwkv6-3b", "")) \
        == 3_073_313_280


# --------------------------------------------------------------------------
# Mamba and the jamba hybrid
# --------------------------------------------------------------------------


def test_jamba_configs_are_the_reference_configs():
    """jamba-v0.1-52b at its published, smoke and long variants, and the
    narrow hybrid period, are the JAX package's configurations."""
    for variant in ("", "smoke", "long"):
        assert dataclasses.asdict(get_config(JAMBA, variant)) == \
            dataclasses.asdict(jax_get_config(JAMBA, variant))
    jcfg, cfg = configs_of(HYBRID)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert [(l.mixer.kind, l.ffn.kind) for l in cfg.period] == [
        ("mamba", "dense"), ("mamba", "moe")] * 2 + [
        ("attn", "dense"), ("mamba", "moe")] + [
        ("mamba", "dense"), ("mamba", "moe")]


def test_mamba_block_matches_jax():
    """The Mamba mixer alone (``mamba_scan_ref`` inside) over T = 70:
    the output and the new cache — the last 3 conv inputs and the final
    state — against the JAX block's prefill, then two decode steps from
    that cache, each writing ``conv`` and ``ssm`` in place; atol = rtol
    = 1e-5.  The chunked modes raise the JAX package's error."""
    jcfg, cfg = configs_of(JAMBA)
    spec = cfg.period[0].mixer
    jp = _np_tree(jax_init_params(jcfg, jax.random.PRNGKey(5),
                                  jnp.float32))["period"]
    p = {k: v[0] for k, v in jp["block0"]["mixer"].items()}
    jpp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 70, cfg.d_model)).astype(np.float32)
    want, want_c = jax_blocks.mamba(jpp, jcfg, spec, jnp.asarray(x), None,
                                    None, "prefill")
    got, got_c = blocks.mamba(tp, cfg, spec, torch.from_numpy(x), None,
                              None, "prefill")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    _check_tree(got_c, want_c, atol=1e-5)
    assert got_c["conv"]._base is None          # a copy, not a view of x
    cache = {k: v.clone() for k, v in got_c.items()}
    for step in range(2):
        x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        want, want_c = jax_blocks.mamba(jpp, jcfg, spec, jnp.asarray(x1),
                                        want_c, None, "decode")
        got, out_c = blocks.mamba(tp, cfg, spec, torch.from_numpy(x1),
                                  cache, None, "decode")
        assert out_c is cache
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5, err_msg=str(step))
        _check_tree(cache, want_c, atol=1e-5)
    for mode in ("ragged_step", "mixed_step", "prefill_chunk"):
        with pytest.raises(NotImplementedError) as mine:
            blocks.mamba(tp, cfg, spec, torch.from_numpy(x1), cache, None,
                         mode)
        with pytest.raises(NotImplementedError) as ref:
            jax_blocks.mamba(jpp, jcfg, spec, jnp.asarray(x1), want_c,
                             None, mode)
        assert str(mine.value) == str(ref.value)


def test_mamba_short_prompt_conv_cache():
    """A prompt shorter than the conv window (S = 2 < d_conv - 1 = 3)
    caches what the JAX block caches: the prompt's inputs only."""
    jcfg, cfg = configs_of(JAMBA)
    spec = cfg.period[0].mixer
    jp = _np_tree(jax_init_params(jcfg, jax.random.PRNGKey(8),
                                  jnp.float32))["period"]
    p = {k: v[0] for k, v in jp["block0"]["mixer"].items()}
    x = np.random.default_rng(9).standard_normal(
        (1, 2, cfg.d_model)).astype(np.float32)
    want, want_c = jax_blocks.mamba({k: jnp.asarray(v) for k, v in p.items()},
                                    jcfg, spec, jnp.asarray(x), None, None,
                                    "prefill")
    got, got_c = blocks.mamba({k: torch.from_numpy(np.array(v))
                               for k, v in p.items()}, cfg, spec,
                              torch.from_numpy(x), None, None, "prefill")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    _check_tree(got_c, want_c, atol=1e-5)


def test_init_params_rules_mamba():
    """``A_log`` is exactly log(1..d_state) in every channel and period;
    softplus(``dt_bias``) lies in [1e-3, 1e-1] and spreads over it;
    ``conv_b`` is zeros, ``D`` ones; and the draws are seeded."""
    cfg = configs_of(HYBRID)[1]
    p = params.init_params(cfg, 4, device="cpu")["period"]
    for key, layer in zip(sorted(p), cfg.period):
        if layer.mixer.kind != "mamba":
            continue
        m = p[key]["mixer"]
        n = layer.mixer.d_state
        want = torch.log(torch.arange(1, n + 1, dtype=torch.float32))
        assert torch.equal(m["A_log"], want.expand_as(m["A_log"]))
        dt = torch.nn.functional.softplus(m["dt_bias"].double())
        assert dt.min() >= 1e-3 * (1 - 1e-5) and dt.max() <= 1e-1 * (1 + 1e-5)
        assert dt.max() - dt.min() > 0.05
        assert not m["conv_b"].any() and torch.equal(
            m["D"], torch.ones_like(m["D"]))
    again = params.init_params(cfg, 4, device="cpu")["period"]
    assert torch.equal(again["block0"]["mixer"]["dt_bias"],
                       p["block0"]["mixer"]["dt_bias"])


def test_jamba_params_match_jax_declaration():
    """jamba-v0.1-52b's parameter tree at the published widths, 4 periods
    and cut to 1, and at the smoke widths: the JAX keys, shapes and init
    rules, from the declarations alone (nothing allocated), and the
    parameter counts (51.57 B, and 13.30 B for one period): the
    configuration's analytic count plus the conv biases it leaves out
    (d_inner per Mamba layer)."""
    from repro.models import params as jax_params
    full, jfull = get_config(JAMBA, ""), jax_get_config(JAMBA, "")
    for cfg, jcfg in ((full, jfull),
                      (dataclasses.replace(full, num_periods=1),
                       dataclasses.replace(jfull, num_periods=1)),
                      configs_of(JAMBA), configs_of(HYBRID)):
        jd = jax_params.declare_model(jcfg)
        jl = _leaves(jax.tree.map(lambda p: (p.shape, p.init), jd,
                                  is_leaf=lambda x: isinstance(
                                      x, jax_params.P)))
        tl = _leaves(params.tree_map(lambda p: (p.shape, p.init),
                                     params.declare_model(cfg)))
        assert jl == tl
        conv_b = sum(l.mixer.expand * cfg.d_model for l in cfg.layers
                     if l.mixer.kind == "mamba")
        assert params.param_count_from_decl(cfg) == \
            cfg.param_count() + conv_b
    assert params.param_count_from_decl(full) == 51_570_315_264
    assert params.param_count_from_decl(
        dataclasses.replace(full, num_periods=1)) == 13_295_235_072


@pytest.mark.parametrize("name", [JAMBA, HYBRID])
def test_mamba_caches_match_jax_layout(name):
    """The hybrid's dense and paged caches: the JAX keys, shapes and
    dtypes — Mamba ``conv`` and ``ssm`` one row per request in the paged
    cache too, the attention layer's KV in the block pool — and
    ``has_recurrent_state`` true in both packages."""
    jcfg, cfg = configs_of(name)
    assert cache_lib.has_recurrent_state(cfg)
    assert jax_cache.has_recurrent_state(jcfg)
    for jc, tc in (
            (jax_cache.init_cache(jcfg, 3, 7, jnp.float32),
             cache_lib.init_cache(cfg, 3, 7, torch.float32, "cpu")),
            (jax_cache.init_paged_cache(jcfg, 3, 9, 4, jnp.float32),
             init_paged_cache(cfg, 3, 9, 4, torch.float32, "cpu"))):
        jl, tl = _leaves(_np_tree(jc)), _leaves(tc)
        assert jl.keys() == tl.keys()
        for k in jl:
            assert tuple(tl[k].shape) == jl[k].shape, k
            assert str(tl[k].dtype).split(".")[-1] == str(jl[k].dtype)
    paged = _leaves(init_paged_cache(cfg, 3, 9, 4, torch.float32, "cpu"))
    d_in, n = 2 * cfg.d_model, cfg.period[0].mixer.d_state
    assert paged["period/block0/mixer/ssm"].shape == (1, 3, d_in, n)
    assert paged["period/block0/mixer/conv"].shape == (1, 3, 3, d_in)
    if name == HYBRID:
        assert paged["period/block4/mixer/k"].shape == (1, 9, 4, 1, 32)
