"""The torch port's losses, optimizers, cascade evaluation, δ selection
and calibration against the JAX package, on the CPU.

Inputs are numpy arrays from a seed; every loss of Eqs 3–6 and of the
baselines (with masks, label smoothing and an out-of-range label) and
its gradient with respect to the logits within atol 1e-6, rtol 1e-5;
three updates of each optimizer on a tree with leaves of rank 1, 2 and
3; ``evaluate_cascade`` for 2 and 3 members over a 201-point sweep with
confidences on grid points; the δ grid bit for bit, and the selected δ
bitwise; ``ece``, ``fit_temperature`` and the ConfNet / IDK heads.
"""
import os

import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import calibration as jax_cal  # noqa: E402
from repro.core import cascade as jax_cascade  # noqa: E402
from repro.core import confidence as jax_conf  # noqa: E402
from repro.core import losses as jax_losses  # noqa: E402
from repro.core import thresholds as jax_thr  # noqa: E402
from repro.optim import optimizer as jax_opt  # noqa: E402
from repro_torch.core import calibration, cascade, confidence  # noqa: E402
from repro_torch.core import losses, thresholds  # noqa: E402
from repro_torch.models.params import tree_map  # noqa: E402
from repro_torch.optim import optimizer  # noqa: E402
from tests.torch_one_thread import one_torch_thread  # noqa: E402,F401

N, K = 64, 10
TOL = dict(atol=1e-6, rtol=1e-5)


def data(seed=0, n=N, k=K):
    rng = np.random.default_rng(seed)
    fast = (rng.normal(size=(n, k)) * 2).astype(np.float32)
    exp = (rng.normal(size=(n, k)) * 3).astype(np.float32)
    labels = rng.integers(0, k, size=n).astype(np.int32)
    labels[:n // 3] = fast[:n // 3].argmax(-1)   # some fast-right samples
    mask = (rng.random(n) < 0.7).astype(np.float32)
    return fast, exp, labels, mask


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(
        got, torch.Tensor) else got), np.asarray(want), **(tol or TOL))


def _eq3(kind):
    """(jax fn, port fn) of (fast, exp, labels, mask) -> scalar."""
    return {
        "ce": (lambda f, e, y, m: jax_losses.cross_entropy(f, y),
               lambda f, e, y, m: losses.cross_entropy(f, y)),
        "ce_mask_smooth": (
            lambda f, e, y, m: jax_losses.cross_entropy(f, y, m, 0.1),
            lambda f, e, y, m: losses.cross_entropy(f, y, m, 0.1)),
        "cascade": (lambda f, e, y, m: jax_losses.cascade_loss(f, e, y, 0.3),
                    lambda f, e, y, m: losses.cascade_loss(f, e, y, 0.3)),
        "cascade_mask_margin": (
            lambda f, e, y, m: jax_losses.cascade_loss(
                f, e, y, 0.5, m, conf_kind="margin"),
            lambda f, e, y, m: losses.cascade_loss(
                f, e, y, 0.5, m, conf_kind="margin")),
        "ltc": (lambda f, e, y, m: jax_losses.ltc_loss(
                    f, e, y, w=0.7, cost_c=0.4, mask=m,
                    label_smoothing=0.05)[0],
                lambda f, e, y, m: losses.ltc_loss(
                    f, e, y, w=0.7, cost_c=0.4, mask=m,
                    label_smoothing=0.05)[0]),
        "ltc_chain": (
            lambda f, e, y, m: jax_losses.ltc_chain_loss(
                [f, 0.5 * (f + e), e], y, w=1.3, cost_c=0.2, mask=m)[0],
            lambda f, e, y, m: losses.ltc_chain_loss(
                [f, 0.5 * (f + e), e], y, w=1.3, cost_c=0.2, mask=m)[0]),
        "confnet": (
            lambda f, e, y, m: jax_losses.confnet_loss(
                jax.nn.sigmoid(e[:, 0]), f, y, m),
            lambda f, e, y, m: losses.confnet_loss(
                torch.sigmoid(e[:, 0]), f, y, m)),
        "idk": (lambda f, e, y, m: jax_losses.idk_loss(
                    jax.nn.sigmoid(e[:, 0]), f, y, 0.3),
                lambda f, e, y, m: losses.idk_loss(
                    torch.sigmoid(e[:, 0]), f, y, 0.3)),
    }[kind]


@pytest.mark.parametrize("out_of_range", [False, True])
@pytest.mark.parametrize("kind", ["ce", "ce_mask_smooth", "cascade",
                                  "cascade_mask_margin", "ltc", "ltc_chain",
                                  "confnet", "idk"])
def test_losses_and_logit_gradients_match_jax(kind, out_of_range):
    """Each loss and its gradient with respect to both logit arrays (the
    expensive one's is zero where the JAX package stop-gradients it,
    except through the chain's middle exit and the heads' input)."""
    f, e, y, m = data(1)
    if out_of_range:
        y = y.copy()
        y[3], y[7] = K, -1          # a zero one-hot row in JAX: NLL = lse
    jf, pf = _eq3(kind)
    want, want_g = jax.value_and_grad(jf, argnums=(0, 1))(
        jnp.asarray(f), jnp.asarray(e), jnp.asarray(y), jnp.asarray(m))
    tf, te = t(f).requires_grad_(True), t(e).requires_grad_(True)
    got = pf(tf, te, t(y).long(), t(m))
    gf, ge = torch.autograd.grad(got, (tf, te), allow_unused=True)
    close(got, want)
    # None: the loss does not reach those logits (JAX: zeros)
    close(torch.zeros_like(tf) if gf is None else gf, want_g[0])
    close(torch.zeros_like(te) if ge is None else ge, want_g[1])


def test_ltc_metrics_and_moe_aux_loss():
    f, e, y, m = data(2)
    _, want = jax_losses.ltc_loss(f, e, y, w=2.0, mask=m)
    _, got = losses.ltc_loss(t(f), t(e), t(y).long(), w=2.0, mask=t(m))
    assert got.keys() == want.keys()
    for k in got:
        close(got[k], want[k])
    _, want = jax_losses.ltc_chain_loss([f, e, f + e], y)
    _, got = losses.ltc_chain_loss([t(f), t(e), t(f + e)], t(y).long())
    assert got.keys() == want.keys()
    aux = {"lb_loss": 1.25, "z_loss": 3.5}
    assert losses.moe_aux_loss(aux) == pytest.approx(
        float(jax_losses.moe_aux_loss(aux)))
    assert losses.moe_aux_loss({}) == 0.0


@pytest.mark.parametrize("pad", [0, 5])
def test_chunked_lm_loss_matches_jax(pad):
    """Sequence chunks of 8 over S = 16 + pad (padded to a chunk
    multiple, as JAX pads), with a mask, and the gradients with respect
    to the hidden states and the projection."""
    rng = np.random.default_rng(3)
    Bn, Sn, D, V = 2, 16 + pad, 12, 40
    h = rng.normal(size=(Bn, Sn, D)).astype(np.float32)
    proj = rng.normal(size=(D, V)).astype(np.float32)
    lab = rng.integers(0, V, size=(Bn, Sn)).astype(np.int32)
    mask = (rng.random((Bn, Sn)) < 0.8).astype(np.float32)
    want, want_g = jax.value_and_grad(
        lambda a, b: jax_losses.chunked_lm_loss(a, b, lab, chunk=8,
                                                mask=mask),
        argnums=(0, 1))(jnp.asarray(h), jnp.asarray(proj))
    th, tp = t(h).requires_grad_(True), t(proj).requires_grad_(True)
    got = losses.chunked_lm_loss(th, tp, t(lab), chunk=8, mask=t(mask))
    gh, gp = torch.autograd.grad(got, (th, tp))
    close(got, want)
    close(gh, want_g[0])
    close(gp, want_g[1])
    full = losses.cross_entropy(th @ tp, t(lab), t(mask))
    close(got, full.detach().numpy())


@pytest.mark.parametrize("kind", ["max_prob", "entropy", "margin"])
def test_confidence_scores_match_jax(kind):
    f = data(4)[0]
    close(confidence.score(t(f), kind, 1.7), jax_conf.score(f, kind, 1.7))


def tree(seed=5):
    rng = np.random.default_rng(seed)
    return {"b": rng.normal(size=(7,)).astype(np.float32),
            "w": rng.normal(size=(5, 6)).astype(np.float32),
            "experts": [rng.normal(size=(3, 4, 5)).astype(np.float32)]}


@pytest.mark.parametrize("name,kw", [
    ("sgd", {}), ("sgd", {"weight_decay": 5e-3, "nesterov": True}),
    ("sgd", {"weight_decay": 1e-2}), ("adamw", {}),
    ("adamw", {"weight_decay": 0.01}), ("adafactor", {})])
def test_optimizers_match_jax(name, kw):
    """Three updates on leaves of rank 1, 2 and 3 (an expert stack:
    adafactor factors it per expert)."""
    params, jparams = tree_map(t, tree()), tree()
    opt, jopt = optimizer.get_optimizer(name, **kw), \
        jax_opt.get_optimizer(name, **kw)
    state, jstate = opt.init(params), jopt.init(jparams)
    if name == "adafactor":
        assert state["v"]["experts"][0]["vr"].shape == (3, 4)
        assert state["v"]["experts"][0]["vc"].shape == (3, 5)
    for i in range(3):
        g = tree(10 + i)
        params, state = opt.update(params, tree_map(t, g), state, 0.05)
        jparams, jstate = jopt.update(jparams, g, jstate, 0.05)
    for a, b in zip(jax.tree.leaves(jparams), [params["b"],
                                              params["experts"][0],
                                              params["w"]]):
        close(b, a)
    # jax.tree.leaves sorts dict keys; the port's trees keep the order
    # they were built in, so compare in JAX's order
    for a, b in zip(jax.tree.leaves(jstate), jax.tree.leaves(
            tree_map(lambda x: x.numpy(), state))):
        close(b, a)
    assert int(state["step"]) == 3


def test_schedules_match_jax():
    sd, jsd = optimizer.step_decay(0.1, [3, 6], 0.2), \
        jax_opt.step_decay(0.1, [3, 6], 0.2)
    cs, jcs = optimizer.cosine(0.1, 20, warmup=4), \
        jax_opt.cosine(0.1, 20, warmup=4)
    for s in range(0, 24, 1):
        assert sd(s) == pytest.approx(float(jsd(s)), rel=1e-6)
        close(cs(s), jcs(s))


def cascade_inputs(m, seed=6, n=200):
    """Confidences of m-1 gates, some sitting exactly on δ grid points,
    and correctness of m members."""
    rng = np.random.default_rng(seed)
    grid = np.asarray(jnp.linspace(0.0, 1.0, 201))
    confs = rng.random((m - 1, n)).astype(np.float32)
    confs[:, :40] = grid[rng.integers(0, 201, size=(m - 1, 40))]
    corrects = (rng.random((m, n)) < np.linspace(0.5, 0.9, m)[:, None]
                ).astype(np.float32)
    return confs, corrects, np.arange(1, m + 1, dtype=np.float32) * 2.5


@pytest.mark.parametrize("m", [2, 3])
def test_evaluate_cascade_matches_jax(m):
    confs, corrects, costs = cascade_inputs(m)
    grid = np.asarray(jnp.linspace(0.0, 1.0, 201))
    deltas = np.stack([grid] + [grid[::-1]] * (m - 2), 1)
    want = jax_cascade.evaluate_cascade(confs, corrects, costs, deltas)
    got = cascade.evaluate_cascade(confs, corrects, costs, deltas)
    for k in ("acc", "cost", "frac_used", "n_exp"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    # N^exp / N = the next member's share, gate by gate (a mean is the
    # sum times f32(1/N), as XLA computes jnp.mean)
    np.testing.assert_array_equal(
        got["n_exp"].numpy() * np.float32(1 / confs.shape[1]),
        got["frac_used"][:, 1:].numpy())


def test_two_element_metrics_match_jax():
    confs, corrects, _ = cascade_inputs(2, seed=7)
    for delta in (0.35, np.asarray([0.0, 0.35, 1.0], np.float32)):
        want = jax_cascade.two_element_metrics(confs[0], corrects[0],
                                               corrects[1], 3.0, 11.0, delta)
        got = cascade.two_element_metrics(confs[0], corrects[0],
                                          corrects[1], 3.0, 11.0, delta)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_cascade_executor_matches_jax():
    f, e, _, _ = data(8)
    mid = 0.5 * (f + e)
    members = [(f, 1.0), (mid, 4.0), (e, 9.0)]
    want_p, want_i = jax_cascade.CascadeExecutor(
        [jax_cascade.Member(str(i), c, lambda b, x=x: x)
         for i, (x, c) in enumerate(members)], [0.4, 0.6])(None)
    got_p, got_i = cascade.CascadeExecutor(
        [cascade.Member(str(i), c, lambda b, x=x: t(x))
         for i, (x, c) in enumerate(members)], [0.4, 0.6])(None)
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    close(got_i["cost"], want_i["cost"])
    for a, b in zip(got_i["escalated"], want_i["escalated"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("num", [201, 16])
def test_delta_grid_is_jnp_linspace_bit_for_bit(num):
    want = np.asarray(jnp.linspace(0.0, 1.0, num))
    got = thresholds.linspace(num).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    # torch.linspace is not
    assert (torch.linspace(0, 1, num).numpy() != want).any()


@pytest.mark.parametrize("seed", [9, 10, 11])
def test_delta_selection_matches_jax_bitwise(seed):
    confs, corrects, costs = cascade_inputs(2, seed=seed, n=300)
    want = jax_thr.best_accuracy_delta(confs[0], corrects[0], corrects[1],
                                       costs)
    got = thresholds.best_accuracy_delta(confs[0], corrects[0],
                                         corrects[1], costs)
    assert got == want
    for target, eps in ((0.8, 0.0), (0.75, 0.05), (0.999, 0.0)):
        want = jax_thr.min_cost_delta(confs[0], corrects[0], corrects[1],
                                      costs, target, eps)
        got = thresholds.min_cost_delta(confs[0], corrects[0], corrects[1],
                                        costs, target, eps)
        assert got == want
    assert want[3] is False          # 0.999 is out of reach: the fallback


def test_ece_matches_jax():
    rng = np.random.default_rng(12)
    confs = rng.random(500).astype(np.float32)
    confs[:20] = 0.0                 # in no bin
    confs[20:40] = np.asarray(jnp.linspace(0.0, 1.0, 16))[
        rng.integers(0, 16, 20)]     # on bin edges
    corrects = (rng.random(500) < confs).astype(np.float32)
    for bins in (15, 10):
        assert calibration.ece(t(confs), t(corrects), bins) == \
            pytest.approx(jax_cal.ece(confs, corrects, bins), abs=1e-6)


def test_fit_temperature_matches_jax():
    f, _, y, _ = data(13, n=200)
    f = f * 3
    want = jax_cal.fit_temperature(f, y, steps=100, lr=0.05)
    got = calibration.fit_temperature(t(f), t(y).long(), steps=100, lr=0.05)
    assert got == pytest.approx(want, rel=1e-4)
    assert abs(got - 1.0) > 0.05     # the fit moved T


@pytest.mark.parametrize("kind", ["confnet", "idk"])
def test_fit_conf_head_matches_jax(kind, monkeypatch):
    """50 Adam steps from the same head (the JAX init bridged into the
    port's)."""
    rng = np.random.default_rng(14)
    feats = rng.normal(size=(128, 16)).astype(np.float32)
    f, _, y, _ = data(15, n=128)
    key = jax.random.PRNGKey(0)
    head0 = jax_cal.init_conf_head(key, 16, 32)
    monkeypatch.setattr(calibration, "init_conf_head",
                        lambda gen, d, h, device: calibration.ConfHead(
                            *(t(a) for a in head0)))
    want = jax_cal.fit_conf_head(key, feats, f, y, kind=kind, steps=50,
                                 hidden=32)
    got = calibration.fit_conf_head(torch.Generator(), t(feats), t(f),
                                    t(y).long(), kind=kind, steps=50,
                                    hidden=32)
    for a, b in zip(got, want):
        close(a, b, atol=1e-5, rtol=0)
    close(calibration.conf_head_apply(got, t(feats)),
          jax_cal.conf_head_apply(want, feats), atol=1e-5, rtol=0)


def test_init_conf_head_shapes_and_device():
    head = calibration.init_conf_head(torch.Generator().manual_seed(0), 16,
                                      8, device="cpu")
    assert [tuple(a.shape) for a in head] == [(16, 8), (8,), (8, 1), (1,)]
    assert float(head.b1.abs().sum()) == 0.0
