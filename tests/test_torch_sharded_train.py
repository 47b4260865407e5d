"""Sharded training in the torch port, on the CPU, against the JAX
package's jitted steps on placed inputs.

* Seven mesh cases, two steps each: the port's ``make_train_step`` /
  ``make_ltc_train_step`` built with ``mesh=`` (a ``TierMesh`` over the
  CPU device repeated) on params placed by ``param_specs``
  (``steps.place``), an optimizer state placed by ``opt_state_specs``
  and the global batch, against the JAX step on 8 host devices with the
  same mesh, params placed by ``param_specs``, the state by
  ``opt_state_specs`` and the batch by ``shard_batch`` (one subprocess
  for the module, started with its first test so that it runs beside
  the port).  Compared: each step's losses (``l_org`` / ``l_casc``
  under LtC), the train forward's ``lb_loss`` / ``z_loss`` before each
  step, and after the two steps every parameter and optimizer-state
  leaf, gathered (``steps.gather``); every replica of a leaf must hold
  the same bits.  The MoE cases count one ``moe_route`` launch a MoE
  layer a forward (two under remat), however many shards.
* ``batch_pspec`` / ``shard_batch`` rows against JAX's addressable
  shards; ``opt_state_specs`` against JAX's for all ten configs at their
  published widths on stub ``2x4`` and ``16x16`` meshes; the per-device
  ``opt_state_shapes`` against JAX's shard shapes on ``2x4``; gradients
  through ``mesh.all_reduce`` / ``all_gather``; the refusals;
  ``transformer.forward(mode="train", group=)`` (its exit heads and
  hidden states too) and a ``chunked_ce`` step on ``2x2`` against the
  unsharded ones; Adafactor's sharded update of single leaves split on
  their last, second-to-last or both dims (and rank-1, expert stacks)
  against the whole leaf's.

Weights come from the port's ``init_params`` (numpy to JAX); batches
from a numpy seed.  Torch runs on one intra-op thread.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data import pipeline as jax_pipeline  # noqa: E402
from repro.launch import steps as jax_steps  # noqa: E402
from repro_torch.configs import ASSIGNED, get_config  # noqa: E402
from repro_torch.data import batch_pspec, shard_batch  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import (init_params, params, sharding,  # noqa: E402
                                transformer)
from repro_torch.models.params import tree_leaves, tree_map  # noqa: E402
from tests.test_torch_model import narrow_hybrid  # noqa: E402
from tests.test_torch_model_axis import StubMesh, _flat  # noqa: E402
from tests.torch_one_thread import one_torch_thread  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAST, EXP, MOE = "gemma3-1b", "phi4-mini-3.8b", "granite-moe-3b-a800m"
RWKV, JAMBA = "rwkv6-3b", "jamba-v0.1-52b"
EXP_VOCAB = 300
STEPS = 2

# the model of each case: (registry name, fsdp, vocabulary or None); the
# jamba case is layers 3-4 of its published period narrowed (a Mamba
# layer with a MoE FFN, then the attention layer; jamba_layers) with the
# published fsdp=True
MODELS = {"gemma3": (FAST, False, None), "gemma3-fsdp": (FAST, True, None),
          "phi4": (EXP, False, EXP_VOCAB), "granite": (MOE, False, None),
          "rwkv6": (RWKV, False, None), "jamba": (JAMBA, True, None)}
# name: (model, mesh, batch rows x seq, microbatches, expensive model)
CASES = {
    "granite-2x4": ("granite", (2, 4), (8, 64), 1, None),
    "granite-2x1-micro2": ("granite", (2, 1), (8, 64), 2, None),
    "ltc-2x1": ("gemma3", (2, 1), (4, 32), 1, "phi4"),
    "ltc-1x2": ("gemma3", (1, 2), (4, 32), 1, "phi4"),
    "rwkv6-1x2": ("rwkv6", (1, 2), (4, 32), 1, None),
    "jamba-2x2": ("jamba", (2, 2), (4, 32), 1, None),
    "gemma3-fsdp-2x1": ("gemma3-fsdp", (2, 1), (4, 32), 1, None),
}
LR = 1e-2
# Measured largest differences, the port's sharded step against the JAX
# jitted step (f32 sums in other orders): losses 4.9e-7 relative; params
# 1.2e-6 (rwkv6-3b 5.4e-5); adafactor's statistics 3.2e-5 relative, 1.4e-7
# absolute (rwkv6-3b 1.5e-3, 4.1e-5).  rwkv6-3b's gradients are that far
# from JAX's unsharded too (tests/test_torch_recurrent_train.py: 1.9e-4),
# and the port's unsharded step ends 1.08e-4 from this JAX step.
LOSS_TOL = dict(atol=5e-5, rtol=5e-5)
PARAM_TOL = dict(atol=1e-5, rtol=1e-4)
STATE_TOL = dict(atol=1e-6, rtol=2e-4)
DEEP = {"rwkv6": (dict(atol=1e-4, rtol=1e-4), dict(atol=1e-4, rtol=5e-3))}


def configs(model: str):
    """(JAX config, port config) of a case's model at the smoke widths."""
    import repro.configs
    import repro_torch.configs
    name, fsdp, vocab = MODELS[model]
    if name == JAMBA:
        pair = (jamba_layers(repro.configs), jamba_layers(repro_torch.configs))
    else:
        pair = (jax_get_config(name, "smoke"), get_config(name, "smoke"))
    return tuple(dataclasses.replace(c, fsdp=fsdp,
                                     vocab_size=vocab or c.vocab_size)
                 for c in pair)


def jamba_layers(configs):
    """Layers 3 and 4 of jamba-v0.1-52b's period (Mamba + MoE FFN, then
    attention + dense FFN) at the narrow widths of
    ``tests/test_torch_model.narrow_hybrid``, built from ``configs``
    (either package's registry)."""
    cfg = narrow_hybrid(configs)
    return dataclasses.replace(cfg, period=cfg.period[3:5])


def batches(case: str) -> list:
    model, _, (b, s), _, _ = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    vocab = configs(model)[1].vocab_size
    return [rng.integers(0, vocab, (b, s)).astype(np.int32)
            for _ in range(STEPS)]


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Each model's smoke weights from the port's ``init_params`` (seed:
    its place in ``MODELS``), and the module's inputs for the JAX
    subprocess in a pickle."""
    tp = {m: init_params(configs(m)[1], i, device="cpu")
          for i, m in enumerate(MODELS)}
    path = tmp_path_factory.mktemp("sharded_train")
    with open(path / "in.pkl", "wb") as f:
        pickle.dump({"weights": {m: tree_map(lambda t: t.numpy(), p)
                                 for m, p in tp.items()},
                     "cases": CASES,
                     "configs": {m: configs(m)[0] for m in MODELS},
                     "batches": {c: batches(c) for c in CASES},
                     "lr": LR}, f)
    return tp, str(path)


_JAX_STEPS = """
    import dataclasses, pickle, sys
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec
    from repro.configs import ASSIGNED, get_config
    from repro.data import shard_batch
    from repro.launch import steps as steps_lib
    from repro.models import params as params_lib, transformer
    from repro.models import sharding as sharding_lib

    assert jax.device_count() == 8, jax.device_count()
    inp = pickle.load(open(sys.argv[1] + "/in.pkl", "rb"))

    def mesh_of(shape):
        d, m = shape
        return Mesh(np.array(jax.devices()[:d * m]).reshape(d, m),
                    ("data", "model"))

    def put(tree, specs, mesh):
        return jax.tree.map(lambda a, s: jax.device_put(
            jnp.asarray(a), NamedSharding(mesh, PartitionSpec(*s))),
            tree, specs)

    out = {"cases": {}}
    part = int(sys.argv[2])
    for case in JAX_PARTS[part]:
        model, shape, _, micro, exp = inp["cases"][case]
        cfg, mesh = inp["configs"][model], mesh_of(shape)
        pspecs = params_lib.param_specs(cfg, mesh)
        params = put(inp["weights"][model], pspecs, mesh)
        if exp:
            ecfg = inp["configs"][exp]
            step, opt = steps_lib.make_ltc_train_step(cfg, ecfg,
                                                      lr=inp["lr"])
            extra = (put(inp["weights"][exp],
                         params_lib.param_specs(ecfg, mesh), mesh),)
        else:
            step, opt = steps_lib.make_train_step(cfg, lr=inp["lr"],
                                                  microbatches=micro)
            extra = ()
        ospecs = steps_lib.opt_state_specs(opt.name, cfg, mesh)
        state = put(jax.device_get(opt.init(params)), ospecs, mesh)
        # the step, and the train forward's aux losses on its inputs for
        # a config with MoE layers (zeros without), in one program
        moe = any(l.ffn.kind == "moe" for l in cfg.layers)

        def step_aux(p, *args):
            aux = (transformer.train_logits(p, cfg, args[-1])[1] if moe
                   else dict.fromkeys(("lb_loss", "z_loss"), 0.0))
            return step(p, *args) + ({k: aux[k] for k in
                                      ("lb_loss", "z_loss")},)
        jstep = jax.jit(step_aux)
        res = {"metrics": [], "aux": []}
        with sharding_lib.set_mesh(mesh):
            for toks in inp["batches"][case]:
                b = shard_batch({"tokens": toks}, mesh)
                params, state, m, aux = jstep(params, state, *extra, b)
                res["aux"].append({k: float(v) for k, v in aux.items()})
                # put back where the inputs were: one compile a case
                params, state = put(params, pspecs, mesh), put(state, ospecs,
                                                               mesh)
                res["metrics"].append({k: float(v) for k, v in m.items()})
        res["params"] = jax.tree.map(np.asarray, params)
        res["state"] = jax.tree.map(np.asarray, state)
        out["cases"][case] = res

    if part:
        pickle.dump(out, open(sys.argv[1] + "/out1.pkl", "wb"))
        sys.exit(0)
    # shard_batch's rows on 2x4: row r holds the id r everywhere
    mesh = mesh_of((2, 4))
    ids = np.repeat(np.arange(8, dtype=np.int32)[:, None], 4, 1)
    arr = shard_batch({"tokens": ids}, mesh)["tokens"]
    pos = {dev.id: idx for idx, dev in np.ndenumerate(mesh.devices)}
    out["rows"] = {"%d,%d" % pos[sh.device.id]: np.asarray(sh.data)[:, 0]
                   .tolist() for sh in arr.addressable_shards}
    # opt_state_shapes' per-device shapes on 2x4, published widths
    shapes = {}
    for name in ASSIGNED:
        cfg = get_config(name, "")
        for opt_name in (None, "sgd", "adamw"):
            opt = (steps_lib.make_optimizer(cfg) if opt_name is None else
                   steps_lib.make_optimizer(dataclasses.replace(
                       cfg, optimizer=opt_name)))
            sds = steps_lib.opt_state_shapes(opt, cfg, mesh)
            shapes["%s/%s" % (name, opt.name)] = [
                (jax.tree_util.keystr(k), tuple(
                    v.sharding.shard_shape(v.shape)), str(v.dtype))
                for k, v in jax.tree_util.tree_flatten_with_path(sds)[0]]
    out["shapes"] = shapes
    pickle.dump(out, open(sys.argv[1] + "/out0.pkl", "wb"))
"""

# the JAX cases in two subprocesses of about equal time (each compiles
# one step program a case), the first also taking the rows and shapes
JAX_PARTS = (("granite-2x4", "granite-2x1-micro2", "ltc-2x1",
              "gemma3-fsdp-2x1"), ("ltc-1x2", "rwkv6-1x2", "jamba-2x2"))


@pytest.fixture(autouse=True, scope="module")
def _jax_process(weights):
    """The JAX steps' subprocesses (:data:`JAX_PARTS`), started with the
    module's first test so that they run beside the port's;
    :func:`jax_runs` waits for them."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    code = (textwrap.dedent(_JAX_STEPS)
            .replace("JAX_PARTS", repr(JAX_PARTS)))
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, weights[1], str(part)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for part in range(len(JAX_PARTS))]
    yield procs
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def jax_runs(_jax_process, weights):
    runs = {"cases": {}}
    for part, proc in enumerate(_jax_process):
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, f"STDOUT:\n{out}\nSTDERR:\n{err}"
        with open(os.path.join(weights[1], f"out{part}.pkl"), "rb") as f:
            got = pickle.load(f)
        runs["cases"].update(got.pop("cases"))
        runs.update(got)
    return runs


def _cpu_mesh(shape):
    return mesh_lib.make_tier_mesh(*shape, ["cpu"] * (shape[0] * shape[1]))


def _assert_close(got: dict, want: dict, tol, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=f"{what} {k}", **tol)


def _count_routes(monkeypatch):
    calls = []
    orig = ops.moe_route

    def counted(logits, k, cap):
        calls.append(tuple(logits.shape))
        return orig(logits, k, cap)
    monkeypatch.setattr(ops, "moe_route", counted)
    return calls


def _moe_layers(cfg) -> int:
    return sum(layer.ffn.kind == "moe" for layer in cfg.layers)


def _replica_mismatches(placed, specs) -> list:
    """The leaves (by index) some device of which holds other bits than
    the first device holding the same slice: the replicas of a leaf
    must step alike."""
    def differs(s, grid):
        return any(not torch.equal(t, grid[d if "data" in s else 0][
            j if "model" in s else 0])
            for d, row in enumerate(grid) for j, t in enumerate(row))
    return [i for i, bad in enumerate(mesh_lib.map_leaves(
        differs, specs, placed)) if bad]


def _moe_experts(cfg):
    """The experts of ``cfg``'s MoE layers (0 without)."""
    return max((layer.ffn.num_experts for layer in cfg.layers
                if layer.ffn.kind == "moe"), default=0)


def _port_case(case, tp, monkeypatch) -> dict:
    """The port's two steps of ``case`` on its mesh: each step's metrics
    and the train forward's aux losses before it, the ``moe_route``
    launches of each step and the shape of the last, the replicas that
    differ, the gathered params and optimizer state, and whether the
    frozen model's placed weights are untouched."""
    model, shape, _, micro, exp = CASES[case]
    cfg = configs(model)[1]
    mesh = _cpu_mesh(shape)
    specs = params.param_specs(cfg, mesh)
    if exp:
        ecfg = configs(exp)[1]
        step, opt = steps.make_ltc_train_step(cfg, ecfg, lr=LR, mesh=mesh)
        frozen = steps.place(tp[exp], params.param_specs(ecfg, mesh), mesh)
        before = [t.clone() for t in tree_leaves(frozen)]
        extra = (frozen,)
    else:
        step, opt = steps.make_train_step(cfg, lr=LR, microbatches=micro,
                                          mesh=mesh)
        extra = ()
    ospecs = steps.opt_state_specs(opt.name, cfg, mesh)
    placed = steps.place(tp[model], specs, mesh)
    state = steps.place(opt.init(tp[model]), ospecs, mesh)
    routes = _count_routes(monkeypatch)
    out = {"metrics": [], "aux": [], "launches": []}
    for toks in batches(case):
        batch = {"tokens": torch.from_numpy(toks)}
        with torch.no_grad():
            (_, aux), = steps.sharded_forward(
                placed, steps._remat(cfg, True), specs, mesh,
                shard_batch(batch, mesh))[0][:1]
        out["aux"].append({k: float(aux[k]) for k in ("lb_loss", "z_loss")})
        n = len(routes)
        placed, state, m = step(placed, state, *extra, batch)
        out["launches"].append(len(routes) - n)
        out["metrics"].append({k: float(v) for k, v in m.items()})
    monkeypatch.undo()
    out["route"] = routes[-1] if routes else None
    out["replicas"] = (_replica_mismatches(placed, specs),
                       _replica_mismatches(state, ospecs))
    out["params"] = _flat(steps.gather(placed, specs))
    out["state"] = steps.gather(state, ospecs)
    out["frozen"] = exp is None or all(
        torch.equal(a, b) for a, b in zip(tree_leaves(frozen), before))
    return out


@pytest.fixture(scope="module")
def port_runs(weights):
    """Every case's port run (:func:`_port_case`), made while the JAX
    subprocesses run."""
    mp = pytest.MonkeyPatch()
    try:
        return {case: _port_case(case, weights[0], mp) for case in CASES}
    finally:
        mp.undo()


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_steps_match_jax(port_runs, jax_runs, case):
    """Two steps on the case's mesh: per-step losses within 5e-5, the
    aux losses before each step within 5e-5, every param and adafactor
    statistic after within ``PARAM_TOL`` / ``STATE_TOL`` (``DEEP`` for
    rwkv6-3b), replicas equal; a MoE layer routes once a forward over
    the global batch (its group of ``min(1024, B·S)`` slots spans the
    data shards), twice under remat, whatever the mesh."""
    model, _, (B, S), micro, _ = CASES[case]
    cfg = configs(model)[1]
    got, want = port_runs[case], jax_runs["cases"][case]
    for g, w in zip(got["aux"] + got["metrics"],
                    want["aux"] + want["metrics"]):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], err_msg=k, **LOSS_TOL)
    assert got["launches"] == [2 * micro * _moe_layers(cfg)] * STEPS
    if _moe_layers(cfg):
        N = B * S // micro
        assert got["route"] == (N // min(1024, N), min(1024, N),
                                _moe_experts(cfg))
        assert want["aux"][0]["lb_loss"] > 0
    assert got["replicas"] == ([], [])
    ptol, stol = DEEP.get(model, (PARAM_TOL, STATE_TOL))
    _assert_close(got["params"], _flat(want["params"]), ptol, "param")
    got_s, want_s = got["state"], want["state"]
    assert int(got_s["step"]) == int(want_s["step"]) == STEPS
    _assert_close(_flat(got_s["v"]), _flat(want_s["v"]), stol, "state")
    assert got["frozen"]


def test_shard_batch_rows_match_jax(jax_runs):
    """``shard_batch`` on ``2x4``: data shard ``d`` holds rows ``4d ..
    4d+3`` on its device, as JAX's addressable shards of every device in
    mesh row ``d``; ``batch_pspec`` is JAX's; a batch the data axis does
    not divide raises."""
    mesh = _cpu_mesh((2, 4))
    ids = np.repeat(np.arange(8, dtype=np.int32)[:, None], 4, 1)
    shards = shard_batch({"tokens": ids}, mesh)
    assert len(shards) == 2
    for key, rows in jax_runs["rows"].items():
        d, _ = map(int, key.split(","))
        assert shards[d]["tokens"][:, 0].tolist() == rows, key
    for ndim in (1, 2, 3):
        assert batch_pspec(mesh, ndim) == tuple(jax_pipeline.batch_pspec(
            StubMesh((2, 4)), ndim))
    with pytest.raises(ValueError, match="does not split over 2"):
        shard_batch({"tokens": ids[:7]}, mesh)


def _jax_tuples(tree, ndims):
    return {k: tuple(s) + (None,) * (ndims[k] - len(tuple(s)))
            for k, s in _flat(tree).items()}


@pytest.mark.parametrize("name", ASSIGNED)
def test_opt_state_specs_match_jax(name):
    """``opt_state_specs`` of each config at its published widths, for
    its own optimizer, sgd and adamw, on stub ``2x4`` and ``16x16``
    meshes (fsdp as published), leaf for leaf as the JAX package's: no
    device and no allocation."""
    jcfg, cfg = jax_get_config(name, ""), get_config(name, "")
    for shape in ((2, 4), (16, 16)):
        mesh = StubMesh(shape)
        for opt_name in ("adafactor", "sgd_momentum", "adamw"):
            got = _flat(steps.opt_state_specs(opt_name, cfg, mesh))
            ndims = {k: len(v) for k, v in got.items()}
            want = _jax_tuples(jax_steps.opt_state_specs(opt_name, jcfg,
                                                         mesh), ndims)
            assert got == want, (name, shape, opt_name)


def _path(key: str) -> str:
    """A JAX key path ``['v']['embed']['vr']`` as ``v/embed/vr``."""
    return "/".join(p.strip("'") for p in key.strip("[]").split("]["))


def test_opt_state_shapes_match_jax_shard_shapes(jax_runs):
    """``opt_state_shapes`` on ``2x4``: each leaf a ``meta`` tensor of
    the shape and dtype one device holds, as JAX's shard shapes, for all
    ten configs at their published widths and three optimizers."""
    mesh = StubMesh((2, 4))
    for key, want in jax_runs["shapes"].items():
        name, opt_name = key.split("/")
        cfg = dataclasses.replace(get_config(name, ""), optimizer=opt_name)
        got = _flat(steps.opt_state_shapes(steps.make_optimizer(cfg), cfg,
                                           mesh))
        assert sorted(got) == sorted(_path(k) for k, _, _ in want), key
        for k, shape, dtype in want:
            t = got[_path(k)]
            assert t.device.type == "meta"
            assert (tuple(t.shape), str(t.dtype)) == (
                shape, "torch." + dtype), (key, k)


def test_collectives_carry_gradients():
    """``all_reduce``'s and ``all_gather``'s outputs are differentiable
    in every part: a part's gradient is the sum of every output's (the
    all-reduce's adjoint), a gathered slice's its own columns'."""
    gen = torch.Generator().manual_seed(0)
    parts = [torch.randn(3, 4, generator=gen, requires_grad=True)
             for _ in range(3)]
    ws = [torch.randn(3, 4, generator=gen) for _ in range(3)]
    outs = mesh_lib.all_reduce(parts)
    gr = torch.autograd.grad(sum((o * w).sum() for o, w in zip(outs, ws)),
                             parts)
    for g in gr:
        torch.testing.assert_close(g, sum(ws), rtol=0, atol=1e-6)
    w = torch.randn(3, 12, generator=gen)
    gg = torch.autograd.grad((mesh_lib.all_gather(parts, -1) * w).sum(),
                             parts)
    for j, g in enumerate(gg):
        assert torch.equal(g, w[:, 4 * j:4 * (j + 1)])


def test_meshes_the_layers_refuse_raise():
    """A model axis no layout admits raises ValueError when the step is
    built (gemma3-1b's 4 query heads over 3 model shards), for both
    steps."""
    cfg = get_config(FAST, "smoke")
    mesh = _cpu_mesh((1, 3))
    with pytest.raises(ValueError, match="head-parallel layout"):
        steps.make_train_step(cfg, mesh=mesh)
    with pytest.raises(ValueError, match="head-parallel layout"):
        steps.make_ltc_train_step(cfg, get_config(EXP, "smoke"), mesh=mesh)


def test_forward_train_over_a_group_matches_unsharded():
    """``transformer.forward(mode="train", group=)`` on two model shards
    (gemma3-1b smoke in two periods with an exit head after the first,
    its vocabulary split): every position's logits, each exit head's
    (their columns gathered like the LM head's), the hidden states of
    ``return_hidden`` and the aux losses within atol 1e-5 of the
    unsharded forward, whose parity with JAX the train tests hold."""
    cfg = dataclasses.replace(get_config(FAST, "smoke"), num_periods=2,
                              early_exit_periods=(0,))
    p = init_params(cfg, 5, device="cpu")
    mesh = _cpu_mesh((1, 2))
    specs = params.param_specs(cfg, mesh)
    weights = sharding.train_shard_params(steps.place(p, specs, mesh), cfg,
                                          specs, mesh)[0]
    group = sharding.ModelShards(mesh.model_devices(0))
    batch = {"tokens": torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32))}
    with torch.no_grad():
        want, want_aux = transformer.forward(p, cfg, batch,
                                                   mode="train")
        got, aux = transformer.forward(weights, cfg, batch,
                                             mode="train", group=group)
        hid, _ = transformer.forward(weights, cfg, batch,
                                           mode="train", group=group,
                                           return_hidden=True)
        want_hid, _ = transformer.forward(p, cfg, batch, mode="train",
                                                return_hidden=True)
    assert weights[0]["embed"].shape[0] == cfg.vocab_size // 2
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    torch.testing.assert_close(hid, want_hid, atol=1e-5, rtol=0)
    (e,), (we,) = aux.pop("exit_logits"), want_aux.pop("exit_logits")
    assert e.shape == we.shape == (2, 24, cfg.vocab_size)
    torch.testing.assert_close(e, we, atol=1e-5, rtol=0)
    for k, v in want_aux.items():
        torch.testing.assert_close(aux[k], v, atol=1e-6, rtol=0)


def test_chunked_ce_over_a_mesh_matches_unsharded():
    """``make_train_step(chunked_ce=16, mesh=)`` on ``2x2`` (fsdp leaves,
    the vocabulary split, so the LM head's columns are gathered for
    ``chunked_lm_loss``): two steps' losses within 5e-5 and the params
    within 1e-5 of the unsharded chunked step, which
    ``tests/test_torch_train.py`` holds to JAX's."""
    cfg = dataclasses.replace(get_config(FAST, "smoke"), fsdp=True)
    p = init_params(cfg, 6, device="cpu")
    mesh = _cpu_mesh((2, 2))
    specs = params.param_specs(cfg, mesh)
    step, opt = steps.make_train_step(cfg, lr=LR, chunked_ce=16)
    mstep, _ = steps.make_train_step(cfg, lr=LR, chunked_ce=16, mesh=mesh)
    want, s = p, opt.init(p)
    got = steps.place(p, specs, mesh)
    gs = steps.place(opt.init(p), steps.opt_state_specs(opt.name, cfg, mesh),
                     mesh)
    rng = np.random.default_rng(8)
    for _ in range(STEPS):
        batch = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (4, 40)).astype(np.int32))}
        want, s, wm = step(want, s, batch)
        got, gs, m = mstep(got, gs, batch)
        np.testing.assert_allclose(float(m["loss"]), float(wm["loss"]),
                                   **LOSS_TOL)
    _assert_close(_flat(steps.gather(got, specs)),
                  {k: v.numpy() for k, v in _flat(want).items()},
                  dict(atol=1e-5, rtol=0), "param")


# (leaf shape, spec) on a 2x2 mesh: the last dim split, the second-to-last
# split, both (model and fsdp data), a rank-1 leaf split, and an expert
# stack with its experts over model and its d_model over data
ADAFACTOR_LEAVES = {"last": ((6, 8), (None, "model")),
                    "second-to-last": ((8, 6), ("model", None)),
                    "both": ((8, 6), ("data", "model")),
                    "rank-1": ((8,), ("model",)),
                    "experts": ((4, 6, 8), ("model", None, "data"))}


@pytest.mark.parametrize("leaf", sorted(ADAFACTOR_LEAVES))
def test_adafactor_sharded_update_steps_the_whole_leaf(leaf):
    """Adafactor's ``update_sharded`` on one leaf placed on ``2x2`` by
    its spec: two steps gathered equal the unsharded ``update`` of the
    whole leaf within 1e-6 (its row and column means, ``denom`` and RMS
    clip summed over the shards that split them), while stepping each
    slice with its own means would differ."""
    shape, spec = ADAFACTOR_LEAVES[leaf]
    opt = steps.get_optimizer("adafactor")
    mesh = _cpu_mesh((2, 2))
    gen = torch.Generator().manual_seed(len(leaf))
    p = {"w": torch.randn(shape, generator=gen)}
    # the second step's gradient 100x larger on the first half of the
    # last dim: the slices' own RMS clips (and means) then differ
    scale = torch.ones(shape[-1])
    scale[:shape[-1] // 2] = 100.0
    grads = [{"w": torch.randn(shape, generator=gen) * (scale if i else 1)}
             for i in range(STEPS)]
    specs = {"w": spec}
    ospecs = {"v": {"w": {"vr": spec[:-1], "vc": spec[:-2] + spec[-1:]}
                    if len(shape) > 1 else {"v": spec}}, "step": ()}
    want, s = p, opt.init(p)
    got, gs = steps.place(p, specs, mesh), steps.place(s, ospecs, mesh)
    local = [[t for t in row] for row in got]
    ls = [[opt.init(t) for t in row] for row in local]
    for g in grads:
        want, s = opt.update(want, g, s, 0.1)
        got, gs = opt.update_sharded(got, steps.place(g, specs, mesh), gs,
                                     0.1, specs)
        pg = steps.place(g, specs, mesh)
        for d in range(2):
            for j in range(2):
                local[d][j], ls[d][j] = opt.update(local[d][j], pg[d][j],
                                                   ls[d][j], 0.1)
    torch.testing.assert_close(steps.gather(got, specs)["w"], want["w"],
                               atol=1e-6, rtol=0)
    for k, v in _flat(s["v"]).items():
        torch.testing.assert_close(_flat(steps.gather(gs, ospecs)["v"])[k],
                                   v, atol=1e-6, rtol=1e-6)
    assert (steps.gather(local, specs)["w"] - want["w"]).abs().max() > 1e-4
