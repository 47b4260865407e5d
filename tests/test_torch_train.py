"""The torch port's training path against the JAX package, on the CPU.

Weights come from the JAX package's ``init_params`` through
``from_jax``; token batches from ``bigram_lm`` (numpy, shared).  Held to
the JAX package: the train-mode forward (every position's logits and the
MoE aux losses) of gemma3-1b (windowed and global layers, tied head),
phi4-mini-3.8b and granite-moe-3b-a800m at the smoke widths, the
``lm_loss`` gradients, the plain, microbatched, chunked-CE and LtC train
steps over three steps, ``launch.train.run``, the npz checkpoints both
ways, ``launch.serve.serve_cascade`` and ``greedy_decode`` under the
margin rule of ``tests/test_torch_serving.py``, the prefill and serve
step functions, and ``CascadeServer`` over numpy members.  Inside the port, remat on must equal
remat off bit for bit.  The JAX step functions are jitted once per
module and shared.
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

from repro.checkpoint import checkpoint as jax_ckpt  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import serve as jax_serve  # noqa: E402
from repro.launch import steps as jax_steps  # noqa: E402
from repro.launch import train as jax_train  # noqa: E402
from repro.models import blocks as jax_blocks  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import transformer as jax_transformer  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import bigram_lm  # noqa: E402
from repro_torch.launch import serve, steps, train  # noqa: E402
from repro_torch.models import blocks, init_params, transformer  # noqa: E402
from repro_torch.models.params import (from_jax, tree_leaves,  # noqa: E402
                                       value_and_grad)
from repro_torch.serving import CascadeEngine  # noqa: E402
from tests.test_torch_serving import (_tap_jax_logits,  # noqa: E402
                                      _tap_torch_rows)

FAST, EXP, MOE = "gemma3-1b", "phi4-mini-3.8b", "granite-moe-3b-a800m"
MODELS = (FAST, EXP, MOE)
B, S = 2, 16


@functools.lru_cache(maxsize=None)
def model(name):
    """(JAX config, JAX weights as numpy, port config)."""
    jcfg = jax_get_config(name, "smoke")
    jp = jax.tree.map(np.asarray, jax_init_params(
        jcfg, jax.random.PRNGKey(MODELS.index(name)), jnp.float32))
    return jcfg, jp, get_config(name, "smoke")


def tokens(seed=0, b=B, s=S):
    return bigram_lm(num_seqs=b, seq_len=s, vocab=512, seed=seed)


def _flat(tree, prefix=""):
    """{path: numpy leaf} of a tree of dicts and lists (JAX or port)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().numpy()}
    return {prefix: np.asarray(tree)}


def assert_trees_close(got, want, atol, rtol):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    for k in g:
        np.testing.assert_allclose(g[k], w[k], atol=atol, rtol=rtol,
                                   err_msg=k)


@pytest.mark.parametrize("name", MODELS)
def test_train_logits_and_aux_match_jax(name):
    """Every position's logits and the summed aux losses at the smoke
    widths: gemma3-1b's windowed (16) and global layers over 24 tokens,
    its tied head; phi4-mini-3.8b; granite's MoE lb and z losses."""
    jcfg, jp, cfg = model(name)
    toks = tokens(1, s=24)
    want, want_aux = jax.jit(jax_transformer.train_logits, static_argnums=1)(
        jp, jcfg, {"tokens": jnp.asarray(toks)})
    got, aux = transformer.train_logits(from_jax(jp), cfg,
                                        {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    for k in ("lb_loss", "z_loss"):
        np.testing.assert_allclose(float(aux[k]), float(want_aux[k]),
                                   rtol=1e-5, atol=1e-5)
    if name == MOE:
        assert float(aux["lb_loss"]) > 0 and float(aux["z_loss"]) > 0
    if name != FAST:
        return
    hidden, _ = transformer.forward(from_jax(jp), cfg,
                                    {"tokens": torch.from_numpy(toks)},
                                    mode="train", return_hidden=True)
    want_h, _, _ = jax.jit(lambda p, b: jax_transformer.forward(
        p, jcfg, b, mode="train", return_hidden=True))(
            jp, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(hidden.numpy(), np.asarray(want_h),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name,chunked_ce", [(FAST, 0), (EXP, 16),
                                             (MOE, 0)])
def test_lm_loss_gradients_match_jax(name, chunked_ce):
    jcfg, jp, cfg = model(name)
    toks = tokens(2, s=24)
    (want_l, _), want_g = jax.jit(jax.value_and_grad(
        lambda p, b: jax_steps.lm_loss(p, jcfg, b, chunked_ce=chunked_ce),
        has_aux=True))(jp, {"tokens": jnp.asarray(toks)})
    (loss, _), grads = value_and_grad(
        lambda p, b: steps.lm_loss(p, cfg, b, chunked_ce=chunked_ce),
        from_jax(jp), {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(loss), float(want_l), rtol=1e-5)
    assert_trees_close(grads, want_g, atol=1e-5, rtol=1e-3)


def test_moe_train_ffn_with_drops_matches_jax():
    """granite's MoE FFN at capacity factor 0.5 (experts drop pairs):
    output, aux losses and every gradient, the router's included."""
    jcfg, jp, cfg = model(MOE)
    spec = cfg.period[0].ffn
    spec = dataclasses.replace(spec, capacity_factor=0.5)
    jspec = dataclasses.replace(jcfg.period[0].ffn, capacity_factor=0.5)
    p = jax.tree.map(lambda a: a[0], jp["period"]["block0"]["ffn"])
    x = np.random.default_rng(3).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)

    def jax_loss(p, x):
        y, _, aux = jax_blocks.moe_ffn(p, jcfg, jspec, x, None, "train")
        return jnp.sum(y * y) + aux["lb_loss"] + aux["z_loss"], (y, aux)

    (_, (want, want_aux)), want_g = jax.jit(jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True))(p, jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = blocks.moe_ffn_train(tp, cfg, spec, tx)
    loss = (y * y).sum() + aux["lb_loss"] + aux["z_loss"]
    loss.backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    for k in ("lb_loss", "z_loss"):
        np.testing.assert_allclose(float(aux[k]), float(want_aux[k]),
                                   rtol=1e-5)
    assert_trees_close({k: t.grad for k, t in tp.items()}, want_g[0],
                       atol=1e-5, rtol=1e-3)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_g[1]),
                               atol=1e-5, rtol=1e-3)


def test_train_attention_chunks_long_sequences_like_jax():
    """At S >= 4096 the train-mode attention takes its queries in chunks
    of 1024 (JAX: a scan over the chunks); the window masks across the
    chunk edges."""
    jcfg, jp, cfg = model(FAST)
    cfg = dataclasses.replace(cfg, d_model=16, num_heads=2, num_kv_heads=1,
                              head_dim=8)
    jcfg = dataclasses.replace(jcfg, d_model=16, num_heads=2,
                               num_kv_heads=1, head_dim=8)
    rng = np.random.default_rng(4)
    p = {k: rng.normal(size=s).astype(np.float32) * 0.3 for k, s in
         (("wq", (16, 16)), ("wk", (16, 8)), ("wv", (16, 8)),
          ("wo", (16, 16)))}
    x = rng.normal(size=(1, 4096, 16)).astype(np.float32)
    pos = np.arange(4096, dtype=np.int32)[None]
    for spec, jspec in zip((cfg.period[0].mixer, cfg.period[-1].mixer),
                           (jcfg.period[0].mixer, jcfg.period[-1].mixer)):
        want, _ = jax_blocks.attention(p, jcfg, jspec, jnp.asarray(x), None,
                                       jnp.asarray(pos), "train")
        got, cache = blocks.attention(
            {k: torch.from_numpy(v) for k, v in p.items()}, cfg, spec,
            torch.from_numpy(x), None, torch.from_numpy(pos), "train")
        assert cache is None
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-5)


@functools.lru_cache(maxsize=None)
def jax_train_step(name, microbatches, chunked_ce):
    jcfg = model(name)[0]
    step, opt = jax_steps.make_train_step(jcfg, lr=1e-2,
                                          microbatches=microbatches,
                                          chunked_ce=chunked_ce)
    return jax.jit(step), opt


def batches(n=3, b=4):
    return [tokens(10 + i, b=b) for i in range(n)]


@pytest.mark.parametrize("name,microbatches,chunked_ce", [
    (FAST, 1, 0), (FAST, 2, 0), (FAST, 1, 16), (MOE, 1, 0)])
def test_train_steps_match_jax(name, microbatches, chunked_ce):
    """Three adafactor steps of ``make_train_step`` (remat forced on
    gemma3's periods): the plain step, 2 microbatches, chunked CE, and
    granite's with the MoE aux losses in the loss."""
    jcfg, jp, cfg = model(name)
    jstep, jopt = jax_train_step(name, microbatches, chunked_ce)
    step, opt = steps.make_train_step(cfg, lr=1e-2,
                                      microbatches=microbatches,
                                      chunked_ce=chunked_ce)
    assert opt.name == jopt.name == "adafactor"
    want_p, want_s = jp, jopt.init(jp)
    got_p = from_jax(jp)
    got_s = opt.init(got_p)
    for toks in batches():
        want_p, want_s, want_m = jstep(want_p, want_s,
                                       {"tokens": jnp.asarray(toks)})
        got_p, got_s, m = step(got_p, got_s,
                               {"tokens": torch.from_numpy(toks)})
        np.testing.assert_allclose(float(m["loss"]),
                                   float(want_m["loss"]), rtol=1e-4)
    assert_trees_close(got_p, want_p, atol=1e-5, rtol=1e-4)
    assert int(got_s["step"]) == int(want_s["step"]) == 3


EXP_VOCAB = 300


@functools.lru_cache(maxsize=None)
def exp_model():
    """phi4-mini-3.8b's smoke stack with a vocabulary of 300, below
    gemma3's 512, as the published pair's 200064 sits below 262144."""
    jcfg = dataclasses.replace(model(EXP)[0], vocab_size=EXP_VOCAB)
    ep = jax.tree.map(np.asarray, jax_init_params(
        jcfg, jax.random.PRNGKey(9), jnp.float32))
    return jcfg, ep, dataclasses.replace(model(EXP)[2],
                                         vocab_size=EXP_VOCAB)


def test_ltc_train_step_matches_jax():
    """Eq 4 for the gemma3-1b -> phi4-mini-3.8b pair, phi4 frozen: three
    steps, ``l_org`` and ``l_casc`` each step, the fast params after.
    Tokens past the expensive vocabulary embed there as its last id (the
    JAX package's gather clamps); the labels are not clamped."""
    jcfg, jp, cfg = model(FAST)
    jecfg, ep, ecfg = exp_model()
    jstep, jopt = jax_steps.make_ltc_train_step(jcfg, jecfg, w=1.0,
                                                cost_c=0.5, lr=1e-2)
    jstep = jax.jit(jstep)
    step, opt = steps.make_ltc_train_step(cfg, ecfg, w=1.0, cost_c=0.5,
                                          lr=1e-2)
    want_p, want_s = jp, jopt.init(jp)
    got_p, t_ep = from_jax(jp), from_jax(ep)
    got_s = opt.init(got_p)
    seen = 0
    for toks in batches():
        seen += int((toks >= EXP_VOCAB).sum())
        want_p, want_s, want_m = jstep(want_p, want_s, ep,
                                       {"tokens": jnp.asarray(toks)})
        got_p, got_s, m = step(got_p, got_s, t_ep,
                               {"tokens": torch.from_numpy(toks)})
        for k in ("l_org", "l_casc"):
            np.testing.assert_allclose(float(m[k]), float(want_m[k]),
                                       rtol=1e-4)
    assert seen > 0
    assert_trees_close(got_p, want_p, atol=1e-5, rtol=1e-4)
    # the expensive model is frozen: its weights are untouched
    assert_trees_close(t_ep, ep, atol=0, rtol=0)


def test_remat_equals_no_remat_bit_for_bit():
    """Checkpointing gemma3's periods recomputes them in backward and
    changes no bit of the loss or the updated params."""
    _, jp, cfg = model(FAST)
    toks = {"tokens": torch.from_numpy(tokens(30, b=4))}
    outs = []
    for remat in (True, False):
        step, opt = steps.make_train_step(cfg, lr=1e-2, force_remat=remat)
        p = from_jax(jp)
        outs.append(step(p, opt.init(p), toks))
    (p1, _, m1), (p2, _, m2) = outs
    assert float(m1["loss"]) == float(m2["loss"])
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        assert torch.equal(a, b)


def test_checkpoints_load_across_packages(tmp_path):
    """A JAX checkpoint loads into the port (nested dict, and into a
    ``like`` tree with lists) and the port's into JAX, exactly."""
    _, jp, _ = model(FAST)
    tree = {"model": jp, "heads": [{"w": np.arange(6.0).reshape(2, 3)},
                                   {"w": np.ones(2, np.float32)}]}
    jax_ckpt.save(str(tmp_path / "jax"), tree, step=7)
    got = ckpt.load(str(tmp_path / "jax"))
    assert_trees_close(got["model"], jp, atol=0, rtol=0)
    assert set(got["heads"]) == {"#0", "#1"}
    like = {"model": from_jax(jp),
            "heads": [{"w": torch.zeros(2, 3, dtype=torch.float64)},
                      {"w": torch.zeros(2)}]}
    got = ckpt.load(str(tmp_path / "jax.npz"), like=like)
    assert isinstance(got["heads"], list)
    assert got["heads"][0]["w"].dtype == torch.float64
    assert_trees_close(got, tree, atol=0, rtol=0)

    ckpt.save(str(tmp_path / "port"), like, step=3)
    back = jax_ckpt.load(str(tmp_path / "port"), like=jax.tree.map(
        jnp.asarray, {"model": jp, "heads": [
            {"w": np.zeros((2, 3))}, {"w": np.zeros(2, np.float32)}]}))
    assert_trees_close(back, like, atol=0, rtol=0)
    with np.load(str(tmp_path / "port.npz")) as z:
        assert '"step": 3' in str(z["__meta__"])


def test_train_run_matches_jax(monkeypatch):
    """``launch.train.run`` on the same weights and data as the JAX
    package's: three LtC steps' ``l_org``."""
    jcfg, jp, _ = model(FAST)
    monkeypatch.setattr(jax_train, "init_params",
                        lambda cfg, key, dtype: jax.tree.map(jnp.asarray,
                                                             jp))
    monkeypatch.setattr(train, "init_params",
                        lambda cfg, seed, dtype, device: from_jax(jp))
    kw = dict(variant="smoke", steps=3, batch=2, seq=16, log_every=0,
              return_losses=True, expensive=EXP)
    ep = model(EXP)[1]
    _, want = jax_train.run(FAST, exp_params=jax.tree.map(jnp.asarray, ep),
                            **kw)
    history = []
    _, got = train.run(FAST, exp_params=from_jax(ep), device="cpu",
                       history=history, **kw)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert [h["step"] for h in history] == [1, 2, 3]
    assert all("l_casc" in h for h in history)


def test_serve_cascade_matches_jax(monkeypatch):
    """``serve_cascade`` on the same weights: equal tokens and escalation
    count, ``seq_conf`` within 1e-4, and at every emitted step the
    port's logits within 1e-4 of JAX's with a top-1/top-2 margin of more
    than twice that difference (the margin rule of
    ``tests/test_torch_serving.py``).  δ sits mid-gap of the fast tier's
    sequence confidences, so the gate splits the batch."""
    jf, je = model(FAST)[1], model(EXP)[1]
    kw = dict(variant="smoke", batch=6, prompt_len=16, gen_len=4,
              verbose=False)
    tf, te = from_jax(jf), from_jax(je)
    _, conf0, _ = serve.serve_cascade(FAST, EXP, delta=0.0, fast_params=tf,
                                      exp_params=te, device="cpu", **kw)
    confs = np.sort(conf0.numpy())
    i = int(np.argmax(np.diff(confs)))
    delta = float((confs[i] + confs[i + 1]) / 2)

    recording = [True]
    jax_logits = _tap_jax_logits(monkeypatch, recording)
    want_t, want_c, want_s = jax_serve.serve_cascade(
        FAST, EXP, delta=delta, fast_params=jax.tree.map(jnp.asarray, jf),
        exp_params=jax.tree.map(jnp.asarray, je), **kw)
    jax.effects_barrier()
    taps = []

    def engine(*a, **k):
        eng = CascadeEngine(*a, **k)
        taps.append(_tap_torch_rows(eng))
        return eng
    monkeypatch.setattr(serve, "CascadeEngine", engine)
    got_t, got_c, stats = serve.serve_cascade(
        FAST, EXP, delta=delta, fast_params=tf, exp_params=te,
        device="cpu", **kw)
    assert 0 < stats.n_exp < 6
    assert stats.n_exp == want_s.n_exp
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=1e-4)
    torch_logits, emitted = taps[0]
    steps_checked = 0
    for tier in (0, 1):
        assert len(torch_logits[tier]) == len(jax_logits[tier])
        for got, want, rows in zip(torch_logits[tier], jax_logits[tier],
                                   emitted[tier]):
            for s in rows:
                err = np.abs(got[s] - want[s]).max()
                top2 = np.sort(got[s])[-2:]
                assert err < 1e-4
                assert top2[1] - top2[0] > 2 * err
                steps_checked += 1
    assert steps_checked == 6 * 4 + stats.n_exp * 4


def test_greedy_decode_gates_every_token():
    """``greedy_decode`` (uniform prefill, dense decode, every token from
    the confidence gate) against the JAX package's on the same weights:
    equal tokens and confidences within 1e-4, under the margin rule —
    at every emitted position the teacher-forced logits of the two
    packages agree within 1e-4 and their top-1/top-2 margin is more than
    twice that difference."""
    jcfg, jp, cfg = model(FAST)
    p = from_jax(jp)
    prompts = tokens(40, b=3, s=12)
    want_t, want_c = jax_serve.greedy_decode(
        jcfg, jax.tree.map(jnp.asarray, jp), jnp.asarray(prompts), 5)
    toks, conf = serve.greedy_decode(cfg, p, torch.from_numpy(prompts), 5)
    assert toks.shape == conf.shape == (3, 5)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(want_t))
    np.testing.assert_allclose(conf.numpy(), np.asarray(want_c), rtol=1e-4)
    full = np.concatenate([prompts, toks.numpy()], 1)
    got, _ = transformer.train_logits(p, cfg,
                                      {"tokens": torch.from_numpy(full)})
    want, _ = jax.jit(jax_transformer.train_logits, static_argnums=1)(
        jp, jcfg, {"tokens": jnp.asarray(full)})
    got, want = got[:, 11:16].numpy(), np.asarray(want)[:, 11:16]
    err = np.abs(got - want).max(-1)
    top2 = np.sort(got, -1)[..., -2:]
    assert (err < 1e-4).all()
    assert (top2[..., 1] - top2[..., 0] > 2 * err).all()
    np.testing.assert_array_equal(toks.numpy(), got.argmax(-1))
    torch.testing.assert_close(conf, torch.softmax(torch.from_numpy(got),
                                                   -1).amax(-1),
                               rtol=1e-4, atol=1e-6)


def test_prefill_and_serve_steps_match_jax():
    """``make_prefill_step`` (last logits and the part cache) and two
    ``make_serve_step`` decode steps over the dense arena (logits, the
    gate's confidence and the whole cache) against the JAX package's."""
    from repro.models import init_cache as jax_init_cache
    from repro_torch.models.cache import init_cache

    jcfg, jp, cfg = model(FAST)
    p, jpa = from_jax(jp), jax.tree.map(jnp.asarray, jp)
    prompts = tokens(41, b=2, s=12)
    want_l, want_part = jax.jit(jax_steps.make_prefill_step(jcfg))(
        jpa, {"tokens": jnp.asarray(prompts)})
    got_l, part = steps.make_prefill_step(cfg)(
        p, {"tokens": torch.from_numpy(prompts)})
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l),
                               rtol=1e-5, atol=1e-5)
    assert_trees_close(part, want_part, atol=1e-5, rtol=1e-5)

    def put(full, new):
        return full.at[tuple(slice(0, s) for s in new.shape)].set(new)
    jcache = jax.tree.map(put, jax_init_cache(jcfg, 2, 16), want_part)
    cache = init_cache(cfg, 2, 16, device="cpu")
    for leaf, new in zip(tree_leaves(cache), tree_leaves(part)):
        leaf[tuple(slice(0, s) for s in new.shape)].copy_(new)
    jstep = jax.jit(jax_steps.make_serve_step(jcfg))
    step = steps.make_serve_step(cfg)
    tok = np.asarray(want_l)[:, -1].argmax(-1)[:, None].astype(np.int32)
    for t in range(2):
        pos = np.full((2, 1), 12 + t, np.int32)
        want_l, want_c, jcache = jstep(jpa, jnp.asarray(tok),
                                       jnp.asarray(pos), jcache)
        got_l, got_c, cache = step(p, torch.from_numpy(tok),
                                   torch.from_numpy(pos), cache)
        np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c),
                                   rtol=1e-5, atol=1e-7)
        assert_trees_close(cache, jcache, atol=1e-5, rtol=1e-5)
        tok = np.asarray(want_l)[:, -1].argmax(-1)[:, None].astype(np.int32)


def _member_fns(server_lib, m, G=3):
    """A numpy member: outputs ``prompt[:, :G] + 100·m``, confidence the
    prompt's first entry over 8, so confidences 0.25 and 0.5 sit exactly
    on the gates' δ."""
    def generate(prompts):
        prompts = np.asarray(prompts)
        return (prompts[:, :G] + 100 * m).astype(np.int32), \
            prompts[:, 0].astype(np.float32) / 8
    return server_lib.ServingMember(f"m{m}", generate, 10.0 ** m)


@pytest.mark.parametrize("deltas", [(0.5,), (0.25, 0.5)])
def test_cascade_server_matches_jax(deltas):
    """``CascadeServer.serve`` and ``summary`` over numpy members against
    the JAX package's copy: the same outputs, member of each request,
    escalation rates and cost, a confidence equal to δ escalating, over
    two batches and an empty one."""
    from repro.core import server as jax_server
    from repro_torch.core import server

    M = len(deltas) + 1
    rng = np.random.default_rng(3)
    batches = [rng.integers(0, 8, (9, 5)), rng.integers(0, 8, (4, 5)),
               np.zeros((0, 5), np.int64)]
    got_srv = server.CascadeServer([_member_fns(server, m)
                                    for m in range(M)], deltas)
    want_srv = jax_server.CascadeServer([_member_fns(jax_server, m)
                                         for m in range(M)], deltas)
    for prompts in batches:
        got, want = got_srv.serve(prompts), want_srv.serve(prompts)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype
    assert got_srv.summary() == want_srv.summary()
    assert [g.escalated for g in got_srv.stats.gates] == \
        [g.escalated for g in want_srv.stats.gates]
    first = batches[0][:, 0] / 8
    assert got_srv.stats.gates[0].escalated == \
        int((first <= deltas[0]).sum()) + int((batches[1][:, 0] / 8
                                                <= deltas[0]).sum())
    with pytest.raises(ValueError):
        server.CascadeServer([_member_fns(server, 0)], deltas)


@pytest.mark.parametrize("name", ["rwkv6-3b", "jamba-v0.1-52b"])
def test_recurrent_train_mode_is_not_ported(name):
    """The recurrent layers' train mode is ported now (its parity with
    the JAX package is ``tests/test_torch_recurrent_train.py``): the
    train forward gives finite logits.  What stays unported for them is
    a chunked token-batch step, which carries no recurrent state across
    chunks and raises."""
    cfg = get_config(name, "smoke")
    p = init_params(cfg, 0, device="cpu")
    tokens = torch.zeros(1, 4, dtype=torch.int32)
    logits, _ = transformer.train_logits(p, cfg, {"tokens": tokens})
    assert logits.shape == (1, 4, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    with pytest.raises(NotImplementedError, match="uniform"):
        transformer.forward(p, cfg, {"tokens": tokens}, mode="mixed_step",
                            cache={}, pos=torch.zeros_like(tokens),
                            pages={"page_table": torch.zeros(
                                1, 1, dtype=torch.int32),
                                "q_len": torch.ones(1, dtype=torch.int32)})


def test_entry_points_default_to_cuda_and_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device"):
        train.run(FAST, steps=1, batch=2, seq=8)
    with pytest.raises(RuntimeError, match="device"):
        serve.serve_cascade(batch=2, prompt_len=8, gen_len=2, verbose=False)
