"""The rest of the JAX registry in the port: starcoder2-7b, musicgen-large,
qwen2-vl-72b, moonshot-v1-16b-a3b and kimi-k2-1t-a32b, on the CPU.

The configurations equal the JAX package's in all three variants; all
ten architectures' parameter declarations (keys, shapes, init rules)
and parameter counts equal the JAX package's at the published widths
(nothing allocated); ``from_jax`` carries ``frontend_proj`` and the
``head`` layers.  At the smoke widths, one ``make_train_step`` per new
config against the JAX package's loss and gradients (``frontend_proj``'s
included); a ragged step at head width 112 on a narrow kimi-shaped
config (2 heads of 112, 1 KV head, its dense head layer before an MoE
period), so that no check of the port refuses 112 on the CPU; and the
engine's token streams against the JAX engine for gemma3-1b ->
qwen2-vl-72b (uniform by itself: the vision frontend), -> a
moonshot-v1-16b-a3b with its dense head layer before an MoE period
(ragged) and -> starcoder2-7b (ragged), under the margin rule of
``tests/test_torch_serving.py``.
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

import repro.configs  # noqa: E402
import repro_torch.configs  # noqa: E402
from repro.launch import steps as jax_steps  # noqa: E402
from repro.models import cache as jax_cache  # noqa: E402
from repro.models import params as jax_params  # noqa: E402
from repro.models import transformer as jax_transformer  # noqa: E402
from repro_torch.data import bigram_lm  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import params, transformer  # noqa: E402
from repro_torch.models.params import from_jax, value_and_grad  # noqa: E402
from tests import test_torch_serving as serving  # noqa: E402
from tests.test_torch_model import _leaves, _plan  # noqa: E402
from tests.torch_one_thread import one_torch_thread  # noqa: E402,F401

NEW = ("starcoder2-7b", "musicgen-large", "qwen2-vl-72b",
       "moonshot-v1-16b-a3b", "kimi-k2-1t-a32b")
FAST, VISION, MOONSHOT, STARCODER, KIMI = (
    "gemma3-1b", "qwen2-vl-72b", "moonshot-v1-16b-a3b", "starcoder2-7b",
    "kimi-k2-1t-a32b")


def with_head(configs, name, num_periods=1, **widths):
    """The smoke variant of ``name`` (moonshot or kimi: a dense layer,
    then an MoE layer) rebuilt as the published stack is: its dense
    layer as the ``head`` layer before ``num_periods`` MoE periods, at
    the smoke widths or ``widths``; from ``configs`` — ``repro.configs``
    or ``repro_torch.configs``, which give the same configuration."""
    smoke = configs.get_config(name, "smoke")
    dense, moe = smoke.period
    assert dense.ffn.kind == "dense" and moe.ffn.kind == "moe"
    return dataclasses.replace(smoke, name=f"{name}-head-smoke",
                               head=(dense,), period=(moe,),
                               num_periods=num_periods, **widths)


# kimi's head width: d_model 224, 2 heads of 112, 1 KV head
KIMI_NARROW = dict(d_model=224, num_heads=2, num_kv_heads=1, head_dim=112)


def _decl_leaves(decl, P):
    return _leaves(jax.tree.map(lambda p: (tuple(p.shape), p.init), decl,
                                is_leaf=lambda x: isinstance(x, P)))


@pytest.mark.parametrize("name", NEW)
def test_configs_are_the_reference_configs(name):
    for variant in ("", "smoke", "long"):
        mine = dataclasses.asdict(repro_torch.configs.get_config(name,
                                                                 variant))
        ref = dataclasses.asdict(repro.configs.get_config(name, variant))
        assert mine == ref, (name, variant)


def test_registry_is_the_reference_registry():
    assert repro_torch.configs.ASSIGNED == repro.configs.ASSIGNED
    assert repro_torch.configs.list_configs() == repro.configs.list_configs()


@pytest.mark.parametrize("name", repro.configs.ASSIGNED)
def test_declarations_and_param_counts_match_jax(name):
    """At the published widths and the smoke widths: the JAX keys,
    shapes and init rules from the declarations alone, and equal
    parameter counts (kimi-k2-1t-a32b's 1.03 T included)."""
    for variant in ("", "smoke"):
        cfg = repro_torch.configs.get_config(name, variant)
        jcfg = repro.configs.get_config(name, variant)
        assert _decl_leaves(params.declare_model(cfg), params.P) == \
            _decl_leaves(jax_params.declare_model(jcfg), jax_params.P)
        assert params.param_count_from_decl(cfg) == \
            jax_params.param_count_from_decl(jcfg)
        assert cfg.param_count() == jcfg.param_count()
    if name in (MOONSHOT, KIMI):         # the dense first layer
        assert "head" in params.declare_model(
            repro_torch.configs.get_config(name, ""))


@functools.lru_cache(maxsize=None)
def jax_weights(cfg):
    """Weights of ``cfg`` as a numpy tree with the JAX package's keys:
    the port's ``init_params`` from seed 0 (the JAX package's eager
    ``init_params`` compiles a draw per leaf shape), one draw per
    configuration, shared by the tests of the module.  The declaration
    test holds the two trees' keys, shapes and init rules equal."""
    return params.tree_map(lambda t: t.numpy(), params.init_params(
        cfg, 0, device="cpu"))


def test_from_jax_carries_frontend_proj_and_head_layers():
    """qwen2-vl-72b's ``frontend_proj`` [frontend_dim, d_model] and a
    moonshot stack's ``head`` layers cross leaf for leaf, with the port's
    own declaration's keys and shapes."""
    for jcfg, cfg in ((repro.configs.get_config(VISION, "smoke"),
                       repro_torch.configs.get_config(VISION, "smoke")),
                      (with_head(repro.configs, MOONSHOT),
                       with_head(repro_torch.configs, MOONSHOT))):
        jp = jax_weights(jcfg)
        tl, jl = _leaves(from_jax(jp)), _leaves(jp)
        assert tl.keys() == jl.keys()
        for k in jl:
            np.testing.assert_array_equal(tl[k].numpy(), jl[k])
        decl = _leaves(params.declare_model(cfg))
        assert {k: tuple(p.shape) for k, p in decl.items()} == {
            k: v.shape for k, v in jl.items()}
    assert tl["head/layer0/mixer/wq"].shape == (cfg.d_model,
                                                cfg.num_heads * cfg.head_dim)
    assert _leaves(from_jax(jax_weights(
        repro.configs.get_config(VISION, "smoke"))))[
            "frontend_proj"].shape == (64, 256)


def test_ragged_step_at_head_width_112_matches_jax():
    """kimi's head width 112 (2 heads, 1 KV head, d_model 224; the dense
    head layer, then an MoE period of 4 experts top-2) through a whole
    ragged step: last-slot logits within 1e-4 and every live pool row
    within 1e-5 of the JAX package's ``ragged_step``."""
    jcfg = with_head(repro.configs, KIMI, **KIMI_NARROW)
    cfg = with_head(repro_torch.configs, KIMI, **KIMI_NARROW)
    jp = jax_weights(jcfg)
    rng = np.random.default_rng(112)
    R, P, bs = 4, 6, 4
    N, pt, q_len, q_start, toks, pos = _plan(rng, cfg.vocab_size,
                                             [5, 0, 1, 7], R, P, bs)
    pool = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32),
        jax.tree.map(np.asarray, jax_cache.init_paged_cache(
            jcfg, R, N, bs, jnp.float32)))
    pages = {"page_table": pt, "q_len": q_len, "q_start": q_start}
    want, want_c = jax.jit(jax_transformer.ragged_step, static_argnums=1)(
        jax.tree.map(jnp.asarray, jp), jcfg, jnp.asarray(toks),
        jax.tree.map(jnp.asarray, pool), jnp.asarray(pos),
        jax.tree.map(jnp.asarray, pages))
    got, got_c = transformer.ragged_step(
        from_jax(jp), cfg, torch.from_numpy(toks), from_jax(pool),
        torch.from_numpy(pos),
        {k: torch.from_numpy(v) for k, v in pages.items()})
    live = q_len > 0
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                               atol=1e-4, rtol=1e-4)
    blk = np.zeros(N, bool)
    blk[pt[live].ravel()] = True
    got_l, want_l = _leaves(got_c), _leaves(jax.tree.map(np.asarray,
                                                         want_c))
    assert got_l.keys() == want_l.keys()
    assert got_l["head/layer0/mixer/k"].shape[-1] == 112
    for k in want_l:
        # the head layer's pools [N, ...], the stacked periods' [n, N, ...]
        at = (blk,) if k.startswith("head/") else (slice(None), blk)
        np.testing.assert_allclose(got_l[k].numpy()[at], want_l[k][at],
                                   atol=1e-5, rtol=1e-5, err_msg=k)


def _train_batch(cfg, seed):
    rng = np.random.default_rng(seed)
    b = {"tokens": bigram_lm(num_seqs=2, seq_len=16, vocab=cfg.vocab_size,
                             seed=seed)}
    if cfg.frontend:
        b["frontend_embeds"] = rng.standard_normal(
            (2, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)
    return b


@pytest.mark.parametrize("name", NEW)
def test_train_step_matches_jax(name):
    """One ``make_train_step`` of the smoke config: its loss within 1e-6
    relative of the JAX ``lm_loss``, and the gradients of the port's
    ``lm_loss`` within 1e-4 of ``jax.grad``'s, leaf for leaf
    (``frontend_proj`` of the frontend configs, the MoE router and
    experts of moonshot and kimi)."""
    jcfg = repro.configs.get_config(name, "smoke")
    cfg = repro_torch.configs.get_config(name, "smoke")
    jp = jax_weights(jcfg)
    b = _train_batch(cfg, NEW.index(name))
    (want_l, _), want_g = jax.jit(jax.value_and_grad(
        lambda p, x: jax_steps.lm_loss(p, jcfg, x), has_aux=True))(
            jp, {k: jnp.asarray(v) for k, v in b.items()})
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    step, opt = steps.make_train_step(cfg, lr=1e-2)
    tp = from_jax(jp)
    new_p, _, m = step(tp, opt.init(tp), tb)
    np.testing.assert_allclose(float(m["loss"]), float(want_l), rtol=1e-6)
    (loss, _), grads = value_and_grad(
        lambda p, x: steps.lm_loss(p, cfg, x), from_jax(jp), tb)
    np.testing.assert_allclose(float(loss), float(want_l), rtol=1e-6)
    got_g = _leaves(grads)
    want_g = _leaves(jax.tree.map(np.asarray, want_g))
    assert got_g.keys() == want_g.keys()
    if cfg.frontend:
        assert float(np.abs(want_g["frontend_proj"]).max()) > 0
    for k in want_g:
        np.testing.assert_allclose(got_g[k].numpy(), want_g[k], atol=1e-4,
                                   rtol=1e-4, err_msg=k)
    assert not torch.equal(_leaves(new_p)["embed"], tp["embed"])


@pytest.fixture(scope="module")
def weights():
    """The stream-parity tests' weights, as ``test_torch_serving``'s
    fixture keys them."""
    out = {}
    for name, jcfg, cfg in (
            (FAST,) + serving.configs_of(FAST),
            (VISION,) + serving.configs_of(VISION),
            (MOONSHOT, with_head(repro.configs, MOONSHOT),
             with_head(repro_torch.configs, MOONSHOT)),
            (STARCODER,) + serving.configs_of(STARCODER)):
        jp = jax_weights(jcfg)
        out[name] = (jcfg, jp, from_jax(jp))
        out[name, "torch"] = cfg
    return out


@pytest.mark.parametrize("exp,dist,executor", [
    (VISION, "uniform", "auto"), (MOONSHOT, "lognormal", "ragged"),
    (STARCODER, "lognormal", "ragged")])
def test_stream_parity_with_jax_engine(weights, exp, dist, executor,
                                       monkeypatch):
    """gemma3-1b -> qwen2-vl-72b, which both engines put on the uniform
    prefill by themselves (zero frontend embeddings over the first
    ``frontend_len`` positions, M-RoPE); -> moonshot with its dense head
    layer before an MoE period and -> starcoder2-7b on the ragged
    executor: equal ``stream_checksum``, every emitted step's logits
    within 1e-4 and under the margin rule."""
    key = (id(weights), dist)
    if key not in serving._PROBED:
        # the probe (δ = 0: only gemma3-1b decodes) on the port's engine,
        # whose tier-0 confidences the test holds to the JAX engine's
        probe = serving._drain(serving._torch_engine(weights, 0.0, exp=exp),
                               serving._workload(dist))
        confs = sorted(r.seq_conf_by_tier[0] for r in probe.requests)
        i = int(np.argmax(np.diff(confs)))
        serving._PROBED[key] = float((confs[i] + confs[i + 1]) / 2)
    eng = serving._check_stream_parity(weights, dist, monkeypatch, executor,
                                       exp=exp)
    assert eng.chunked_prefill == (exp != VISION)
