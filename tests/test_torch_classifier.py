"""The torch port's classifier experiments against the JAX package, on
the CPU: the synthetic datasets and ``Batches`` bit for bit, the zoo's
forward passes and MACs, and the training loops of ``train_classifier``
(plain, LtC, the ConfNet and IDK heads) and ``train_early_exit`` (Eq 6).

The training loops draw their own initial weights and batch order.  The
port's initial weights are the JAX ones (its ``init_*`` functions are
patched to return them through ``from_jax``), and ``n == batch_size``,
so each epoch is one full-batch step and the order changes only the
order of a mean's sum.  (The JAX loop seeds its order with
``hash(cfg.name)``, which changes from process to process, so its order
cannot be reproduced, not even by JAX.)
"""
import os

import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.data import pipeline as jax_pipeline  # noqa: E402
from repro.data import synthetic as jax_synth  # noqa: E402
from repro.models import classifier as jax_clf  # noqa: E402
from repro_torch.data import Batches, synthetic  # noqa: E402
from repro_torch.models import classifier  # noqa: E402
from repro_torch.models.params import from_jax  # noqa: E402
from tests.test_torch_train import assert_trees_close  # noqa: E402

IN_DIM, CLASSES = 12, 10


def test_datasets_match_jax_bit_for_bit():
    for kw in (dict(num_samples=600, num_classes=7, dim=9, seed=3),
               dict(num_samples=500, hard_frac=0.0, seed=1)):
        want = jax_synth.gaussian_mixture(**kw)
        got = synthetic.gaussian_mixture(**kw)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    want, want_info = jax_synth.teacher_task(2000, seed=5, return_info=True)
    got, info = synthetic.teacher_task(2000, seed=5, return_info=True)
    assert info == want_info
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    for g, w in zip(got.split(seed=2), want.split(seed=2)):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    assert sum(len(d.x) for d in got.split((0.7, 0.2, 0.1))) == 2000


@pytest.mark.parametrize("shuffle,drop_last", [(True, True),
                                               (False, False)])
def test_batches_match_jax(shuffle, drop_last):
    ds = jax_synth.gaussian_mixture(103, seed=4)
    arrays = {"x": ds.x, "y": ds.y}
    want = jax_pipeline.Batches(arrays, 16, shuffle=shuffle, seed=6,
                                drop_last=drop_last)
    got = Batches(arrays, 16, shuffle=shuffle, seed=6, drop_last=drop_last)
    for _ in range(2):
        w, g = list(want.epoch()), list(got.epoch())
        assert len(g) == len(w) == (6 if drop_last else 7)
        for a, b in zip(g, w):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


def zoo():
    return classifier.zoo(IN_DIM, CLASSES), jax_clf.zoo(IN_DIM, CLASSES)


def test_zoo_macs_and_forward_match_jax():
    x = np.random.default_rng(7).normal(size=(33, IN_DIM)).astype(np.float32)
    mine, ref = zoo()
    assert mine.keys() == ref.keys()
    for name in mine:
        assert mine[name].macs == ref[name].macs
        jp = jax_clf.init_mlp(ref[name], jax.random.PRNGKey(1))
        want, want_f = jax_clf.mlp_apply(jp, x, with_features=True)
        got, feats = classifier.mlp_apply(from_jax(jp), torch.from_numpy(x),
                                          with_features=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(feats.numpy(), np.asarray(want_f),
                                   atol=1e-5, rtol=1e-5)
    # the init rule's shapes and scales (the draws differ from JAX's)
    p = classifier.init_mlp(mine["vgg11"], torch.Generator().manual_seed(0),
                            "cpu")
    jp = jax_clf.init_mlp(ref["vgg11"], jax.random.PRNGKey(0))
    assert jax.tree.map(np.shape, jp) == jax.tree.map(
        lambda a: tuple(a.shape), p)


def early_cfgs():
    return (classifier.EarlyExitConfig("ee", (32, 24, 16), (0, 1), CLASSES,
                                       IN_DIM),
            jax_clf.EarlyExitConfig("ee", (32, 24, 16), (0, 1), CLASSES,
                                    IN_DIM))


def test_early_exit_forward_and_macs_match_jax():
    mine, ref = early_cfgs()
    for i in range(3):
        assert mine.macs_upto(i) == ref.macs_upto(i)
    x = np.random.default_rng(8).normal(size=(9, IN_DIM)).astype(np.float32)
    jp = jax_clf.init_early_exit(ref, jax.random.PRNGKey(2))
    want = jax_clf.early_exit_apply(jp, ref, x)
    got = classifier.early_exit_apply(from_jax(jp), mine,
                                      torch.from_numpy(x))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=1e-5)


def task(n=64):
    ds = jax_synth.teacher_task(n, seed=9)
    exp = np.random.default_rng(10).normal(size=(n, CLASSES)).astype(
        np.float32) * 3
    return ds.x, ds.y, exp


def bridge_init(monkeypatch, key, cfg_ref, conf_head):
    """The JAX loop's initial weights (its key split, in its order), as
    the port's init functions' results."""
    jp = jax_clf.init_mlp(cfg_ref, key)
    monkeypatch.setattr(classifier, "init_mlp",
                        lambda cfg, gen, device: from_jax(jp))
    if conf_head:
        kh, _ = jax.random.split(key)
        hid = cfg_ref.width
        head = {"w1": jax.random.normal(kh, (hid, 64)) / np.sqrt(hid),
                "b1": jnp.zeros((64,)), "w2": jnp.zeros((64, 1)),
                "b2": jnp.zeros((1,))}
        monkeypatch.setattr(classifier, "init_train_head",
                            lambda width, gen, device: from_jax(head))


@pytest.mark.parametrize("mode", ["ce", "ltc", "confnet", "idk"])
def test_train_classifier_matches_jax(mode, monkeypatch):
    """Three full-batch epochs (``n == batch_size``) of SGD with
    momentum, weight decay, the global-norm clip and the step decay:
    the plain loss, LtC (w = 1, C = 0.5) and each confidence head."""
    x, y, exp = task()
    mine, ref = zoo()
    key = jax.random.PRNGKey(11)
    kw = dict(epochs=3, batch_size=len(x), lr=0.05)
    if mode == "ltc":
        kw.update(exp_logits=exp, ltc_w=1.0, cost_c=0.5)
    if mode in ("confnet", "idk"):
        kw.update(conf_head=True, conf_head_kind=mode)
    bridge_init(monkeypatch, key, ref["mobilenetv2"], "conf_head" in kw)
    want = jax_clf.train_classifier(ref["mobilenetv2"], x, y, key=key, **kw)
    got = classifier.train_classifier(mine["mobilenetv2"], x, y, seed=0,
                                      device="cpu", **kw)
    assert_trees_close(got, want, atol=1e-5, rtol=0)
    # training moved the weights
    assert not np.allclose(np.asarray(jax.tree.leaves(want)[0]),
                           np.asarray(jax.tree.leaves(
                               jax_clf.init_mlp(ref["mobilenetv2"],
                                                key))[0]))
    lg, conf = classifier.predict(got, torch.from_numpy(x),
                                  conf_head="conf_head" in kw)
    wl, wc = jax_clf.predict(want, x, conf_head="conf_head" in kw)
    np.testing.assert_allclose(lg.numpy(), np.asarray(wl), atol=1e-4,
                               rtol=1e-4)
    assert (conf is None) == (wc is None)


def test_train_early_exit_ltc_matches_jax(monkeypatch):
    """Eq 6's joint training of three exits, ``ltc_w`` > 0."""
    x, y, _ = task()
    mine, ref = early_cfgs()
    key = jax.random.PRNGKey(12)
    jp = jax_clf.init_early_exit(ref, key)
    monkeypatch.setattr(classifier, "init_early_exit",
                        lambda cfg, gen, device: from_jax(jp))
    kw = dict(ltc_w=1.0, cost_c=0.5, epochs=3, batch_size=len(x), lr=0.05)
    want = jax_clf.train_early_exit(ref, x, y, key=key, **kw)
    got = classifier.train_early_exit(mine, x, y, device="cpu", **kw)
    assert_trees_close(got, want, atol=1e-5, rtol=0)


def test_clip_by_global_norm_matches_jax():
    rng = np.random.default_rng(13)
    g = {"a": rng.normal(size=(3, 4)).astype(np.float32),
         "b": [rng.normal(size=5).astype(np.float32)]}
    for max_norm in (0.5, 100.0):
        want = jax_clf.clip_by_global_norm(g, max_norm)
        got = classifier.clip_by_global_norm(from_jax(g), max_norm)
        assert_trees_close(got, want, atol=1e-7, rtol=1e-6)


def test_training_is_reproducible_from_the_seed():
    """The port's order and init come from the seed (no ``hash``): two
    runs agree bit for bit, another seed differs."""
    x, y, _ = task(96)
    cfg = classifier.zoo(IN_DIM, CLASSES)["mobilenetv2"]
    kw = dict(epochs=2, batch_size=32, device="cpu")
    a = classifier.train_classifier(cfg, x, y, seed=3, **kw)
    b = classifier.train_classifier(cfg, x, y, seed=3, **kw)
    c = classifier.train_classifier(cfg, x, y, seed=4, **kw)
    assert torch.equal(a["head"]["w"], b["head"]["w"])
    assert not torch.equal(a["head"]["w"], c["head"]["w"])
