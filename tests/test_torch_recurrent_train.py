"""The port's train mode of the recurrent layers (RWKV-6 time and channel
mix, Mamba) and its early-exit heads against the JAX package, on the CPU.

Weights are drawn from a seed and reach the port through ``from_jax``;
inputs come from seeded numpy.  Held to the JAX package: the
differentiable scans ``blocks._RWKV6Scan`` and ``blocks._MambaScan``
against ``jax.grad`` of the JAX recurrence (``kernels/ref.py``), each
recurrent layer's train-mode gradients against ``jax.grad`` of the JAX
layer body, the train forward and the LM-loss gradients of rwkv6-3b,
jamba-v0.1-52b (smoke) and a 2-period narrow jamba with remat on and
off, one LtC step gemma3-1b -> rwkv6-3b, and gemma3-1b's early-exit
heads: their declaration, logits, Eq 6 and a train step that leaves
them a zero gradient.  Tolerances: atol = rtol = 1e-5 on logits and
losses, 1e-4 on gradients.  Each JAX function is jitted once per module
and shared, and torch runs on one intra-op thread.
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
from repro.configs.base import Layer as JaxLayer  # noqa: E402
from repro.core import losses as jax_losses  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.launch import steps as jax_steps  # noqa: E402
from repro.models import blocks as jax_blocks  # noqa: E402
from repro.models import params as jax_params  # noqa: E402
from repro.models import transformer as jax_transformer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import Layer  # noqa: E402
from repro_torch.core import losses  # noqa: E402
from repro_torch.data import bigram_lm  # noqa: E402
from repro_torch.kernels import mamba_scan as mamba_mod  # noqa: E402
from repro_torch.kernels import rwkv6_scan as rwkv_mod  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import blocks, init_params, transformer  # noqa: E402
from repro_torch.models import params as params_mod  # noqa: E402
from repro_torch.models.params import from_jax, value_and_grad  # noqa: E402
from tests.test_torch_train import assert_trees_close  # noqa: E402

FAST, RWKV, JAMBA, EXP = ("gemma3-1b", "rwkv6-3b", "jamba-v0.1-52b",
                          "phi4-mini-3.8b")
NARROW = "jamba narrow 2 periods"
B, S = 2, 16
TOL = dict(atol=1e-5, rtol=1e-5)            # logits and losses
GTOL = dict(atol=1e-4, rtol=1e-4)           # gradients
# the logits of rwkv6-3b and of the 16-layer narrow jamba: f32 summation
# order differs between the packages' products and scans, and RWKV-6's
# per-head group norm and 16 layers of depth amplify it past 1e-5
DEEP_TOL = dict(atol=5e-5, rtol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Smoke widths run op by op on tiny tensors: one intra-op thread is
    as fast alone and does not spin against the other test workers'
    threads (restored for the worker's next module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def narrow_jamba(get, layer_cls, periods=2):
    """jamba-v0.1-52b's period (attention at layer 4 among 7 Mamba
    layers, MoE FFNs on the odd layers) at d_model 64, with the smoke
    variant's Mamba (d_state 8), experts and FFN widths, ``periods``
    times (``chip_smoke.narrow_jamba_period``, here of either
    package)."""
    smoke = get(JAMBA, "smoke")
    mamba, dense, moe = (smoke.period[0].mixer, smoke.period[0].ffn,
                         smoke.period[1].ffn)
    period = tuple(layer_cls(l.mixer if l.mixer.kind == "attn" else mamba,
                             moe if l.ffn.kind == "moe" else dense)
                   for l in get(JAMBA, "").period)
    return dataclasses.replace(smoke, name="jamba-narrow-period",
                               d_model=64, num_heads=2, num_kv_heads=1,
                               head_dim=32, period=period,
                               num_periods=periods)


def early_exit(get):
    """gemma3-1b's smoke stack in 3 periods, exits after periods 0 and
    1 (``tests/test_models_smoke.py::test_early_exit_heads``)."""
    return dataclasses.replace(get(FAST, "smoke"), num_periods=3,
                               early_exit_periods=(0, 1))


CONFIGS = {
    FAST: lambda get, _: get(FAST, "smoke"),
    RWKV: lambda get, _: get(RWKV, "smoke"),
    JAMBA: lambda get, _: get(JAMBA, "smoke"),
    NARROW: narrow_jamba,
    "gemma3 exits": lambda get, _: early_exit(get),
}


@functools.lru_cache(maxsize=None)
def model(name):
    """(JAX config, weights as numpy, port config).  The weights are
    drawn by the port's ``init_params`` (the JAX package's init rules)
    from a seed and go to the port through ``from_jax``: the JAX
    package's eager ``init_params`` compiles a draw per leaf shape, seconds
    a model."""
    cfg = CONFIGS[name](get_config, Layer)
    tree = init_params(cfg, list(CONFIGS).index(name), device="cpu")
    return (CONFIGS[name](jax_get_config, JaxLayer),
            params_mod.tree_map(lambda t: t.numpy(), tree), cfg)


def tokens(seed=0, b=B, s=S, vocab=512):
    return bigram_lm(num_seqs=b, seq_len=s, vocab=vocab, seed=seed)


# --------------------------------------------------------------------------
# the differentiable scans
# --------------------------------------------------------------------------


def _scan_inputs(kind, seed):
    """The kernel layout at the smoke widths, from a seed: RWKV-6 r, k,
    v [B, H 8, T, hd 32], w in (0, 1), u [8, 32]; Mamba x [B, T, d 64],
    dt > 0, B_t, C_t [B, T, n 8], A < 0 [64, 8]."""
    rng = np.random.default_rng(seed)
    if kind == "rwkv6":
        r, k, v = (rng.standard_normal((B, 8, S, 32)) * 0.5
                   for _ in range(3))
        w = np.exp(-np.exp(rng.standard_normal((B, 8, S, 32)) * 0.5 - 0.5))
        u = rng.standard_normal((8, 32)) * 0.5
        arrays = (r, k, v, w, u)
    else:
        arrays = (rng.standard_normal((B, S, 64)),
                  np.log1p(np.exp(rng.standard_normal((B, S, 64)))) * 0.1,
                  rng.standard_normal((B, S, 8)),
                  rng.standard_normal((B, S, 8)),
                  -np.exp(rng.standard_normal((64, 8)) * 0.3))
    return [a.astype(np.float32) for a in arrays]


SCANS = {"rwkv6": (blocks._RWKV6Scan, jax_ref.rwkv6_scan_ref,
                   rwkv_mod.rwkv6_scan_ref),
         "mamba": (blocks._MambaScan, jax_ref.mamba_scan_ref,
                   mamba_mod.mamba_scan_ref)}


@pytest.mark.parametrize("kind", sorted(SCANS))
def test_scan_function_gradients_match_jax(kind):
    """Every input's gradient of ``sum(y · g)`` through the Function
    against ``jax.grad`` of the JAX recurrence (``lax.scan``), u's
    summed over the batch."""
    fn, jax_fn, _ = SCANS[kind]
    arrays = _scan_inputs(kind, 1)
    g = np.random.default_rng(2).standard_normal(
        arrays[0].shape).astype(np.float32)
    want, want_g = jax.jit(jax.value_and_grad(
        lambda *a: jnp.sum(jax_fn(*a) * g), argnums=tuple(range(5))))(
            *arrays)
    got = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    y, _ = fn.apply(*got)
    loss = (y * torch.from_numpy(g)).sum()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), **TOL)
    for i, (t, w) in enumerate(zip(got, want_g)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), **GTOL,
                                   err_msg=f"{kind} input {i}")


@pytest.mark.parametrize("kind", sorted(SCANS))
def test_scan_function_state_gradient_is_plain_autograd(kind):
    """With a cotangent on the final state too, and with none on it, the
    Function's gradients equal plain autograd through the step loop bit
    for bit (its backward re-runs that loop); a final state left out of
    the loss contributes nothing."""
    fn, _, plain = SCANS[kind]
    arrays = _scan_inputs(kind, 3)
    rng = np.random.default_rng(4)
    for with_state in (True, False):
        ins = [[torch.from_numpy(a).requires_grad_(True) for a in arrays]
               for _ in range(2)]
        outs = [fn.apply(*ins[0]), plain(*ins[1])]
        gy = torch.from_numpy(rng.standard_normal(
            outs[0][0].shape).astype(np.float32))
        gs = torch.from_numpy(rng.standard_normal(
            outs[0][1].shape).astype(np.float32))
        for (y, s_T) in outs:
            loss = (y * gy).sum() + (with_state * (s_T * gs).sum())
            loss.backward()
        assert torch.equal(outs[0][0], outs[1][0])
        for a, b in zip(*ins):
            assert torch.equal(a.grad, b.grad), (kind, with_state)


# --------------------------------------------------------------------------
# whole models: train forward, LM-loss gradients, remat
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def jax_lm(name):
    """The JAX train logits and ``value_and_grad(lm_loss)`` of ``name``,
    its periods checkpointed as ``make_train_step`` trains them, jitted
    together once per module."""
    jcfg = dataclasses.replace(model(name)[0], remat=True)

    def fn(p, b):
        logits, aux = jax_transformer.train_logits(p, jcfg, b)
        return logits, aux, jax.value_and_grad(
            lambda p: jax_steps.lm_loss(p, jcfg, b), has_aux=True)(p)
    return jax.jit(fn)


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no-remat"])
@pytest.mark.parametrize("name", [RWKV, JAMBA, NARROW])
def test_train_logits_and_lm_grads_match_jax(name, remat):
    """Every position's logits, the aux losses, the LM loss and every
    gradient leaf of rwkv6-3b and jamba-v0.1-52b at the smoke widths
    and of the narrow jamba in 2 periods of 8 layers (7 Mamba, 1
    attention, 4 MoE FFNs), each period checkpointed or not, against the
    JAX package's (checkpointed: ``jax.checkpoint`` changes no value).
    Measured max abs differences (the same with remat on and off):
    logits 1.87e-5 (rwkv6-3b), 5.0e-6 (jamba), 1.32e-5 (narrow jamba),
    held to ``DEEP_TOL`` for rwkv6-3b and the narrow jamba; losses
    ≤ 1.9e-6; gradients 1.88e-4 (rwkv6-3b, on leaves of up to ~1e2:
    0.86 of the tolerance), 1.7e-6, 3.2e-5."""
    jcfg, jp, cfg = model(name)
    cfg = dataclasses.replace(cfg, remat=remat)
    toks = tokens(11)
    want, want_aux, ((want_l, _), want_g) = jax_lm(name)(
        jp, {"tokens": jnp.asarray(toks)})
    p = from_jax(jp)
    batch = {"tokens": torch.from_numpy(toks)}
    with torch.no_grad():
        got, aux = transformer.train_logits(p, cfg, batch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **(TOL if name == JAMBA else DEEP_TOL))
    for k in ("lb_loss", "z_loss"):
        np.testing.assert_allclose(float(aux[k]), float(want_aux[k]), **TOL)
    if name != RWKV:
        assert float(aux["lb_loss"]) > 0
    (loss, _), grads = value_and_grad(
        lambda p, b: steps.lm_loss(p, cfg, b), p, batch)
    np.testing.assert_allclose(float(loss), float(want_l), **TOL)
    assert_trees_close(grads, want_g, **GTOL)


def test_remat_launches_each_scan_twice_and_changes_nothing(monkeypatch):
    """Under remat the checkpointed period re-runs its forward in
    backward: each recurrent layer calls its scan twice a step, once
    without remat and once under ``no_grad``; the gradients are equal
    bit for bit either way."""
    _, jp, cfg = model(NARROW)
    calls = {"rwkv6": 0, "mamba": 0}
    for kind, attr in (("rwkv6", "rwkv6_scan"), ("mamba", "mamba_scan")):
        orig = getattr(blocks.kernel_ops, attr)

        def counted(*a, _orig=orig, _kind=kind):
            calls[_kind] += 1
            return _orig(*a)
        monkeypatch.setattr(blocks.kernel_ops, attr, counted)
    batch = {"tokens": torch.from_numpy(tokens(12))}
    grads = {}
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        calls["mamba"] = 0
        _, grads[remat] = value_and_grad(
            lambda p, b: steps.lm_loss(p, c, b), from_jax(jp), batch)
        assert calls["mamba"] == 7 * 2 * (1 + remat)
    for a, b in zip(params_mod.tree_leaves(grads[True]),
                    params_mod.tree_leaves(grads[False])):
        assert torch.equal(a, b)
    calls["mamba"] = 0
    with torch.no_grad():
        transformer.train_logits(from_jax(jp), cfg, batch)
    assert calls["mamba"] == 14
    _, rp, rcfg = model(RWKV)
    calls["rwkv6"] = 0
    value_and_grad(lambda p, b: steps.lm_loss(p, rcfg, b), from_jax(rp),
                   batch)
    assert calls["rwkv6"] == 2


# --------------------------------------------------------------------------
# LtC with a recurrent expensive member
# --------------------------------------------------------------------------


def test_ltc_step_against_rwkv6_matches_jax():
    """One Eq 4 step of gemma3-1b against the frozen rwkv6-3b (smoke
    widths, 512 ids each): ``l_org``, ``l_casc`` and the fast params
    after the adafactor update (max abs difference ≤ 6.0e-8 in the
    params); the expensive weights untouched."""
    jcfg, jp, cfg = model(FAST)
    jecfg, ep, ecfg = model(RWKV)
    jstep, jopt = jax_steps.make_ltc_train_step(jcfg, jecfg, lr=1e-2)
    step, opt = steps.make_ltc_train_step(cfg, ecfg, lr=1e-2)
    toks = tokens(13, b=4)
    want_p, _, want_m = jax.jit(jstep)(jp, jopt.init(jp), ep,
                                       {"tokens": jnp.asarray(toks)})
    got_p = from_jax(jp)
    t_ep = from_jax(ep)
    got_p, _, m = step(got_p, opt.init(got_p), t_ep,
                       {"tokens": torch.from_numpy(toks)})
    for k in ("l_org", "l_casc"):
        np.testing.assert_allclose(float(m[k]), float(want_m[k]), **TOL)
    assert_trees_close(got_p, want_p, **TOL)
    assert_trees_close(t_ep, ep, atol=0, rtol=0)


# --------------------------------------------------------------------------
# early-exit heads
# --------------------------------------------------------------------------


def test_exit_heads_declare_init_count_and_bridge_like_jax():
    """``declare_model`` declares ``exit_heads/exit{i}/{norm, proj}`` as
    the JAX package does (shapes, axes and init rules), ``init_params``
    draws that tree, ``param_count_from_decl`` counts it as JAX does, and
    ``from_jax`` carries it; with a modality frontend beside them the
    tree adds ``frontend_proj`` as the JAX package's does."""
    jcfg, jp, cfg = model("gemma3 exits")
    decl = params_mod.declare_model(cfg)
    jdecl = jax_params.declare_model(jcfg)
    flat = dict(_flat_decl(decl))
    assert flat == dict(_flat_decl(jdecl))
    assert set(decl["exit_heads"]) == {"exit0", "exit1"}
    head = decl["exit_heads"]["exit1"]
    assert head["norm"] == params_mod.P((256,), (None,), "ones")
    assert head["proj"] == params_mod.P((256, 512), ("d_model", "vocab"))
    assert params_mod.param_count_from_decl(cfg) == \
        jax_params.param_count_from_decl(jcfg)
    drawn = init_params(cfg, 0, device="cpu")
    assert {k: tuple(v.shape) for k, v in _flat_tree(drawn)} == \
        {k: p[0] for k, p in flat.items()}
    assert torch.equal(drawn["exit_heads"]["exit0"]["norm"],
                       torch.ones(256))
    bridged = from_jax(jp)
    assert_trees_close(bridged["exit_heads"], jp["exit_heads"], atol=0,
                       rtol=0)
    frontend = dict(frontend="audio", frontend_dim=64, frontend_len=8)
    fdecl = params_mod.declare_model(dataclasses.replace(cfg, **frontend))
    assert dict(_flat_decl(fdecl)) == dict(_flat_decl(
        jax_params.declare_model(dataclasses.replace(jcfg, **frontend))))
    assert fdecl["frontend_proj"] == params_mod.P((64, 256),
                                                  ("frontend", "d_model"))
    assert set(fdecl["exit_heads"]) == {"exit0", "exit1"}


def _flat_decl(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat_decl(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], tuple(tree)


def _flat_tree(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat_tree(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def jax_exits(jcfg, p, b):
    """The JAX early-exit forward with Eq 6 over (exit 0, exit 1, final),
    ``jax.grad`` of ``lm_loss`` and one ``make_train_step`` step, in one
    jitted program."""
    jstep, jopt = jax_steps.make_train_step(jcfg, lr=1e-2)

    def fn(p, b):
        logits, _, aux = jax_transformer.forward(p, jcfg, b, mode="train")
        chain = [el[:, :-1] for el in aux["exit_logits"]] + [logits[:, :-1]]
        chain_loss, chain_m = jax_losses.ltc_chain_loss(
            chain, b["tokens"][:, 1:], w=1.0)
        (lm, _), g = jax.value_and_grad(
            lambda p: jax_steps.lm_loss(p, jcfg, b), has_aux=True)(p)
        new_p, _, m = jstep(p, jopt.init(p), b)
        return (logits, aux["exit_logits"], chain_loss, chain_m, lm, g,
                new_p, m)
    return jax.jit(fn)(p, b)


def test_early_exit_forward_chain_loss_and_train_step_match_jax():
    """gemma3-1b (smoke) in 3 periods with exits after periods 0 and 1:
    ``aux["exit_logits"]`` (both heads, also beside ``return_hidden``
    and under remat), Eq 6 (``ltc_chain_loss``) and its metrics, the LM
    loss with its gradients — the exit heads' exactly zero in both
    packages, as the LM loss reads only the final logits — and one
    ``make_train_step`` step (max abs differences: logits ≤ 4.8e-7,
    params after the step ≤ 6.0e-8; the heads unchanged)."""
    jcfg, jp, cfg = model("gemma3 exits")
    toks = tokens(14)
    (want, want_exits, want_chain, want_cm, want_lm, want_g, want_p,
     want_m) = jax_exits(jcfg, jp, {"tokens": jnp.asarray(toks)})
    p = from_jax(jp)
    batch = {"tokens": torch.from_numpy(toks)}
    with torch.no_grad():
        got, aux = transformer.train_logits(p, cfg, batch)
        hidden, aux_h = transformer.forward(p, cfg, batch, mode="train",
                                            return_hidden=True)
        _, aux_r = transformer.train_logits(
            p, dataclasses.replace(cfg, remat=True), batch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert len(aux["exit_logits"]) == 2 and hidden.shape == (B, S, 256)
    for e, eh, er, w in zip(aux["exit_logits"], aux_h["exit_logits"],
                            aux_r["exit_logits"], want_exits):
        assert e.shape == (B, S, 512)
        np.testing.assert_allclose(e.numpy(), np.asarray(w), **TOL)
        assert torch.equal(e, eh) and torch.equal(e, er)
    chain = [e[:, :-1] for e in aux["exit_logits"]] + [got[:, :-1]]
    loss, m = losses.ltc_chain_loss(chain, batch["tokens"][:, 1:], w=1.0)
    np.testing.assert_allclose(float(loss), float(want_chain), **TOL)
    assert m.keys() == want_cm.keys()
    for k in m:
        np.testing.assert_allclose(float(m[k]), float(want_cm[k]), **TOL)

    (lm, _), grads = value_and_grad(lambda p, b: steps.lm_loss(p, cfg, b),
                                    p, batch)
    np.testing.assert_allclose(float(lm), float(want_lm), **TOL)
    assert_trees_close(grads, want_g, **GTOL)
    for i in ("exit0", "exit1"):
        for k in ("norm", "proj"):
            assert not np.asarray(want_g["exit_heads"][i][k]).any()
            assert not grads["exit_heads"][i][k].any()

    step, opt = steps.make_train_step(cfg, lr=1e-2)
    got_p, _, m = step(p, opt.init(p), batch)
    np.testing.assert_allclose(float(m["loss"]), float(want_m["loss"]),
                               **TOL)
    assert_trees_close(got_p, want_p, **TOL)
    assert_trees_close(got_p["exit_heads"], jp["exit_heads"], atol=0,
                       rtol=0)
