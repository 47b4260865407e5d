"""The sequence-split decode of the torch port, on the CPU, against the
JAX package.

A batch the data axes do not divide (``long_500k``'s batch of 1) splits
the dense cache's sequence over them (``cache_specs(shard_seq=True)``),
and ``seq_over_model`` over ``model`` too where no KV-head dim divides
it; ``make_serve_step(mesh=)`` attends each device's keys and merges the
partials (``launch.mesh.lse_merge``).

* One JAX subprocess on 8 host devices, started with the module's first
  test so that it runs beside the port's: the jitted
  ``repro.launch.steps.make_serve_step`` under ``set_mesh``, its cache
  placed by ``cache_specs(..., shard_seq=True, seq_over_model=...)``,
  batch 1, smoke widths, a random dense cache of ``T`` = 64 positions,
  two consecutive decode steps (each written row read back by the next)
  from two positions: one inside the first key shard (later shards see
  nothing) and one just past the middle shard boundary, whose window
  crosses it.  Against it the port's split step on the same mesh of CPU
  devices: logits, ``conf`` and each device's cache against JAX's
  addressable shard, within atol = rtol = 1e-5 (the int8 case at
  :data:`INT8_TOL`), and against the port's unsharded step.
* The port alone: the merge against one softmax over the concatenated
  keys; a gathered KV head under ``seq_over_model``; a cache placed for
  another split refused; the ``meta`` trace of a split decode against a
  run on 8 CPU devices, one merge an attention layer a group; the
  dry-run CLI on a tiny ``long_500k``-kind pair.

Torch runs on one intra-op thread.
"""
import dataclasses
import inspect
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

from repro_torch.configs import (Layer, get_config,  # noqa: E402
                                 long_context_variant)
from repro_torch.kernels import counting  # noqa: E402
from repro_torch.launch import dryrun, shapes, steps  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.models import cache as cache_lib  # noqa: E402
from repro_torch.models import init_params, params  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.params import tree_leaves, tree_map  # noqa: E402
from tests.test_torch_dryrun import _counts, _cpu_args  # noqa: E402
from tests.torch_one_thread import one_torch_thread  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE_LEN = T = 64                # the dense cache's positions
POSITIONS = (10, 33)              # each case's first decode positions
POD = ("pod", "data", "model")
# label: (model, mesh shape, seq_over_model); a mesh of three dims is
# over POD, of two over ("data", "model")
CASES = {
    "gemma3-1b 2x1": ("gemma3-1b", (2, 1), False),
    "gemma3-1b 4x1": ("gemma3-1b", (4, 1), False),
    "gemma3-1b 2x2x2": ("gemma3-1b", (2, 2, 2), False),
    "gemma3-1b 1x2 seq_over_model": ("gemma3-1b", (1, 2), True),
    "gemma3-1b 2x2 seq_over_model": ("gemma3-1b", (2, 2), True),
    "phi4-swa 2x1": ("phi4-swa", (2, 1), False),
    "phi4-swa 2x2": ("phi4-swa", (2, 2), False),
    "rwkv6-3b 2x1": ("rwkv6-3b", (2, 1), False),
    "jamba-narrow 2x1": ("jamba-narrow", (2, 1), False),
    "gemma3-1b int8 2x1": ("gemma3-1b int8", (2, 1), False),
}
MODELS = sorted({c[0] for c in CASES.values()})
TOL = dict(atol=1e-5, rtol=1e-5)
# the int8 cache's split against the unsharded step, in both packages:
# the probabilities meet the values in bf16, and each device's part of
# the output is a bf16 product that the merge sums (GSPMD's order, which
# the port follows: its split step sits within 1e-6 of JAX's), so the
# parts and the whole round differently by a bf16 step (2^-8 relative)
# of an attention output; JAX's own split program sits 5.8e-3 and
# 6.8e-3 from its unsharded one on these logits (of magnitude ~1)
INT8_SELF_TOL = dict(atol=1e-2, rtol=1e-2)
SELF_TOL = dict(atol=1e-5, rtol=1e-5)


def _config(get, long_variant, layer_cls, name):
    """The smoke config of a case's model, in either package: gemma3-1b
    (its one KV head, window 16), with an int8 cache; phi4-mini-3.8b's
    sliding-window variant at window 16 (so that the window bites at 64
    positions); rwkv6-3b (no ``kv_seq`` leaf); jamba-v0.1-52b's period
    (attention at layer 4 among 7 Mamba layers, MoE FFNs on the odd
    layers) at d_model 64 with the smoke Mamba, experts and FFN widths,
    once."""
    if name == "gemma3-1b int8":
        return dataclasses.replace(get("gemma3-1b", "smoke"),
                                   kv_quant="int8")
    if name == "phi4-swa":
        return long_variant(dataclasses.replace(
            get("phi4-mini-3.8b", "smoke"), long_variant_window=16))
    if name == "jamba-narrow":
        smoke = get("jamba-v0.1-52b", "smoke")
        mamba, dense, moe = (smoke.period[0].mixer, smoke.period[0].ffn,
                             smoke.period[1].ffn)
        period = tuple(layer_cls(
            l.mixer if l.mixer.kind == "attn" else mamba,
            moe if l.ffn.kind == "moe" else dense)
            for l in get("jamba-v0.1-52b", "").period)
        return dataclasses.replace(smoke, name="jamba-narrow-period",
                                   d_model=64, num_heads=2, num_kv_heads=1,
                                   head_dim=32, period=period)
    return get(name, "smoke")


def config(name):
    return _config(get_config, long_context_variant, Layer, name)


def _inputs(cfg, seed: int) -> dict:
    """A model's numpy inputs: the two steps' tokens and a random dense
    cache of ``T`` positions (int8 keys and values with positive scales
    under ``kv_quant="int8"``)."""
    rng = np.random.default_rng(seed)

    def leaf(c):
        if c.dtype == torch.int8:
            return rng.integers(-127, 128, c.shape).astype(np.int8)
        if c.axes[-1] == "kv_heads":                  # int8 scales
            return rng.uniform(0.002, 0.02, c.shape).astype(np.float32)
        return (rng.standard_normal(c.shape) * 0.5).astype(np.float32)
    return {"tokens": rng.integers(0, cfg.vocab_size, 2).astype(np.int32),
            "cache": tree_map(leaf, cache_lib.declare_cache(cfg, 1, T))}


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Each model's smoke weights (the port's ``init_params``, seed its
    place in ``MODELS``) and inputs, and the subprocess's pickle of
    them."""
    tp, ins = {}, {}
    for i, name in enumerate(MODELS):
        cfg = config(name)
        tp[name] = init_params(cfg, i, device="cpu")
        ins[name] = _inputs(cfg, i)
    path = tmp_path_factory.mktemp("seq_split")
    with open(path / "in.pkl", "wb") as f:
        pickle.dump({"weights": {m: tree_map(lambda t: t.numpy(), p)
                                 for m, p in tp.items()},
                     "inputs": ins}, f)
    return tp, ins, str(path)


_JAX = """
    import dataclasses, pickle, sys
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding
    from repro.configs import get_config, long_context_variant
    from repro.configs.base import Layer
    from repro.launch import steps as steps_lib
    from repro.models import cache as cache_lib
    from repro.models import params as params_lib
    from repro.models import sharding as sharding_lib

    assert jax.device_count() == 8, jax.device_count()
    inp = pickle.load(open(sys.argv[1] + "/in.pkl", "rb"))
    CONFIG_SOURCE

    def put(tree, specs, mesh):
        return jax.tree.map(lambda a, s: jax.device_put(
            jnp.asarray(a), NamedSharding(mesh, s)), tree, specs)

    def per_device(tree, mesh):
        # grid device (e, j) of the port is the row-major place of its
        # JAX device in the mesh, the model axis last
        flat = list(mesh.devices.flat)
        M = mesh.devices.shape[-1]
        grid = [[None] * M for _ in range(len(flat) // M)]
        for i, d in enumerate(flat):
            grid[i // M][i % M] = jax.tree.map(lambda a: np.asarray(next(
                s.data for s in a.addressable_shards if s.device == d)),
                tree)
        return grid

    serves, out = {}, {}
    for label, (name, shape, som) in CASES.items():
        cfg = _config(get_config, long_context_variant, Layer, name)
        if name not in serves:
            serves[name] = jax.jit(steps_lib.make_serve_step(cfg))
        x = inp["inputs"][name]
        n = int(np.prod(shape))
        mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape),
                    POD if len(shape) == 3 else ("data", "model"))
        p = put(inp["weights"][name], params_lib.param_specs(cfg, mesh),
                mesh)
        cspecs = cache_lib.cache_specs(cfg, 1, CACHE_LEN, mesh,
                                       shard_seq=True, seq_over_model=som)
        for pos0 in POSITIONS:
            cache = put(x["cache"], cspecs, mesh)
            logits, confs = [], []
            with sharding_lib.set_mesh(mesh):
                for i in range(2):
                    tok = np.full((1, 1), x["tokens"][i], np.int32)
                    pos = np.full((1, 1), pos0 + i, np.int32)
                    lg, conf, cache = serves[name](p, tok, pos, cache)
                    cache = put(cache, cspecs, mesh)
                    logits.append(np.asarray(lg))
                    confs.append(np.asarray(conf))
            out[label, pos0] = {"logits": logits, "conf": confs,
                                "cache": per_device(cache, mesh)}
    pickle.dump(out, open(sys.argv[1] + "/out.pkl", "wb"))
"""


@pytest.fixture(autouse=True, scope="module")
def _jax_process(weights):
    """The JAX subprocess, started with the module's first test so that
    it runs beside the port's; :func:`jax_out` waits for it."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    code = textwrap.dedent(_JAX).replace("CONFIG_SOURCE",
                                         inspect.getsource(_config))
    for k in ("CASES", "POSITIONS", "POD", "CACHE_LEN"):
        code = code.replace(k, repr(globals()[k]))
    proc = subprocess.Popen([sys.executable, "-c", code, weights[2]],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)
    yield proc
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def jax_out(_jax_process, weights):
    out, err = _jax_process.communicate(timeout=600)
    assert _jax_process.returncode == 0, f"STDOUT:\n{out}\nSTDERR:\n{err}"
    with open(os.path.join(weights[2], "out.pkl"), "rb") as f:
        return pickle.load(f)


def _mesh(shape, over="cpu"):
    n = int(np.prod(shape))
    grid = np.empty(n, dtype=object)
    grid[:] = [torch.device(over)] * n
    return mesh_lib.TierMesh(grid.reshape(shape),
                             POD if len(shape) == 3 else mesh_lib.AXES)


def _split_run(cfg, shape, som, pos0, tp, x):
    """The port's split step (two steps from ``pos0``) on a mesh of CPU
    devices, and its unsharded one on the same inputs: (logits, conf)
    of each step, the placed cache, the unsharded cache, the cache's
    specs and the mesh."""
    tmesh = _mesh(shape)
    placed = steps.place(tp, params.param_specs(cfg, tmesh), tmesh)
    host = tree_map(torch.from_numpy, x["cache"])
    cspecs = cache_lib.cache_specs(cfg, 1, T, tmesh, shard_seq=True,
                                   seq_over_model=som)
    cache = tree_map(lambda t: t.clone(), steps.place(host, cspecs, tmesh))
    one = tree_map(lambda t: t.clone(), host)
    step = steps.make_serve_step(cfg, mesh=tmesh, seq_over_model=som,
                                 seq_len=T)
    whole = steps.make_serve_step(cfg)
    got, want = [], []
    for i in range(2):
        tok = torch.full((1, 1), int(x["tokens"][i]), dtype=torch.int32)
        pos = torch.full((1, 1), pos0 + i, dtype=torch.int32)
        lg, conf, out = step(placed, tok, pos, cache)
        assert out is cache
        got.append((lg, conf))
        want.append(whole(tp, tok, pos, one)[:2])
    return got, want, cache, one, cspecs, tmesh


# ---- the port alone ----


def _attend(q, k, v, visible):
    """Softmax attention of one query row ``q`` [H, d] over keys and
    values [t, d] where ``visible`` [t], as the dense decode masks it
    (-1e30)."""
    s = (q @ k.T) / np.sqrt(q.shape[-1])
    s = torch.where(visible, s, torch.full_like(s, -1e30))
    return torch.softmax(s, -1) @ v


@pytest.mark.parametrize("cuts,seen", [
    ((0, 5, 12, 20), (True, True, True)),
    ((0, 7, 16), (True, False)),          # the later part sees nothing
    ((0, 6, 11, 16), (False, True, False)),
])
def test_lse_merge_matches_one_softmax(cuts, seen):
    """``lse_merge`` of each part's ``(o, m, l)`` (its own softmax's
    output, -inf max where it sees no key) equals one softmax over the
    concatenated keys, a part that sees nothing weighted 0 (uniform over
    its masked scores, it would otherwise pull the output toward its
    values' mean); a group of one returns its part as it is."""
    g = torch.Generator().manual_seed(len(cuts))
    H, d, t = 3, 8, cuts[-1]
    q = torch.randn(H, d, generator=g, dtype=torch.float64)
    k = torch.randn(t, d, generator=g, dtype=torch.float64)
    v = torch.randn(t, d, generator=g, dtype=torch.float64)
    visible = torch.zeros(t, dtype=torch.bool)
    for a, b, on in zip(cuts, cuts[1:], seen):
        if on:
            visible[a + 1:b] = True       # a part may hide some keys too
    parts = []
    for a, b in zip(cuts, cuts[1:]):
        s = (q @ k[a:b].T) / np.sqrt(d)
        s = torch.where(visible[a:b], s, torch.full_like(s, -1e30))
        m = s.amax(-1, keepdim=True)
        l = torch.exp(s - m).sum(-1, keepdim=True)
        m = m if visible[a:b].any() else torch.full_like(m, float("-inf"))
        parts.append((torch.softmax(s, -1) @ v[a:b], m, l))
    with counting.Count() as c:
        merged = mesh_lib.lse_merge(parts)
    want = _attend(q, k, v, visible)
    assert len(merged) == len(parts)
    for o, m, l in merged:
        torch.testing.assert_close(o, want, atol=1e-12, rtol=1e-12)
        torch.testing.assert_close(
            m + torch.log(l), torch.logsumexp(torch.where(
                visible, (q @ k.T) / np.sqrt(d), torch.tensor(
                    float("-inf"), dtype=torch.float64)), -1, keepdim=True),
            atol=1e-12, rtol=1e-12)
    assert [e[0] for e in c.collectives] == ["all-reduce"]
    assert c.collectives[0][2] == len(parts)
    # a group of one: its part, exactly, and no collective
    with counting.Count() as c:
        (one,) = mesh_lib.lse_merge(parts[:1])
    assert all(a is b for a, b in zip(one, parts[0]))
    assert not c.collectives


def test_seq_over_model_gathers_kv_heads():
    """``seq_over_model`` where the model axis is a multiple of the KV
    heads (gemma3-1b's smoke stack at 2 KV heads on ``1x4``): each model
    shard computes one KV head, the cache holds both over its keys, so
    the heads are gathered for the write; the split step equals the
    unsharded one."""
    cfg = dataclasses.replace(get_config("gemma3-1b", "smoke"),
                              num_kv_heads=2)
    tp = init_params(cfg, 5, device="cpu")
    x = _inputs(cfg, 5)
    for pos0 in POSITIONS:
        got, want, cache, one, cspecs, tmesh = _split_run(
            cfg, (1, 4), True, pos0, tp, x)
        for (lg, conf), (lg1, conf1) in zip(got, want):
            torch.testing.assert_close(lg, lg1, **SELF_TOL)
            torch.testing.assert_close(conf, conf1, **SELF_TOL)
        for g, w in zip(tree_leaves(steps.gather(
                cache, cspecs, sizes=mesh_lib.axis_sizes(tmesh))),
                tree_leaves(one)):
            torch.testing.assert_close(g, w, **SELF_TOL)


def test_cache_placed_for_another_split_raises():
    """A cache whose leaves are not those of its placement raises: one
    placed without ``seq_over_model`` given to a step built with it
    (gemma3-1b on ``1x2``: every model shard holds the whole sequence,
    the step expects half), and a batch of 2 rows placed over ``2x1``
    given to a step of 1 row (each device holds one row of 64
    positions, the split 32 of one row: only ``seq_len`` tells them
    apart, so a mesh's step requires it)."""
    cfg = get_config("gemma3-1b", "smoke")
    tp = init_params(cfg, 0, device="cpu")
    tmesh = _mesh((1, 2))
    placed = steps.place(tp, params.param_specs(cfg, tmesh), tmesh)
    host = cache_lib.init_cache(cfg, 1, T, device="cpu")
    cache = steps.place(host, cache_lib.cache_specs(cfg, 1, T, tmesh),
                        tmesh)
    tok = torch.zeros(1, 1, dtype=torch.int32)
    step = steps.make_serve_step(cfg, mesh=tmesh, seq_over_model=True,
                                 seq_len=T)
    with pytest.raises(ValueError, match="seq_over_model=True"):
        step(placed, tok, tok, cache)
    tmesh = _mesh((2, 1))
    placed = steps.place(tp, params.param_specs(cfg, tmesh), tmesh)
    host = cache_lib.init_cache(cfg, 2, T, device="cpu")
    cache = steps.place(host, cache_lib.cache_specs(cfg, 2, T, tmesh),
                        tmesh)
    with pytest.raises(ValueError, match="shard_seq=True"):
        steps.make_serve_step(cfg, mesh=tmesh, seq_len=T)(placed, tok, tok,
                                                          cache)
    with pytest.raises(ValueError, match="needs seq_len"):
        steps.make_serve_step(cfg, mesh=tmesh)


def _merges(count, n_devices: int) -> list:
    """The ``all-reduce`` events of a count that deliver to
    ``n_devices`` devices (one a merge group, or a model group)."""
    return [e for e in count.collectives if e[0] == "all-reduce"
            and e[2] == n_devices]


def test_meta_trace_of_split_decode_equals_cpu_run(monkeypatch):
    """The dry-run's trace of a batch-1 decode on 8 ``meta`` devices
    (``2x4``: the keys split over the 2 data shards of each model column)
    and the same step on 8 CPU devices count alike, and the trace records
    one merge an attention layer a group: 4 groups of 2 devices."""
    monkeypatch.setitem(shapes.SHAPES, "tiny_long",
                        shapes.InputShape("tiny_long", T, 1, "decode"))
    cfg = get_config("gemma3-1b", "smoke")
    calls = []
    merge = mesh_lib.lse_merge
    monkeypatch.setattr(transformer, "lse_merge",
                        lambda parts: calls.append(len(parts))
                        or merge(parts))
    meta = dryrun.trace_cfg(cfg, "tiny_long", mesh_lib.make_test_mesh(8),
                            dtype=torch.float32)
    layers = sum(l.mixer.kind == "attn" for l in cfg.layers)
    assert calls == [2] * (4 * layers)
    step, args = _cpu_args(cfg, "tiny_long",
                           mesh_lib.make_test_mesh(8, over=["cpu"] * 8))
    cpu = dryrun.run_counted(step, args, 8, 0)
    assert _counts(cpu.count) == _counts(meta.count)
    assert len(_merges(meta.count, 2)) == 4 * layers


def test_cli_traces_long_pair(capsys, monkeypatch):
    """``--shape`` of a ``long_500k``-kind pair (batch 1, here at 64
    positions) traces on ``make_test_mesh(8)`` and exits 0: the split
    is no longer listed as a failure."""
    monkeypatch.setitem(shapes.SHAPES, "tiny_long",
                        shapes.InputShape("tiny_long", T, 1, "decode"))
    monkeypatch.setattr(dryrun, "make_production_mesh",
                        lambda multi_pod=False: mesh_lib.make_test_mesh(8))
    monkeypatch.setattr(sys, "argv", [
        "dryrun", "--arch", "gemma3-1b", "--shape", "tiny_long",
        "--keep-going", "--out", ""])
    dryrun.main()
    out = capsys.readouterr().out
    assert "[gemma3-1b x tiny_long @ 2x4]" in out
    assert "All dry-runs passed." in out


# ---- against the JAX subprocess (last: it runs beside the tests above) ----


@pytest.mark.parametrize("pos0", POSITIONS)
@pytest.mark.parametrize("label", list(CASES))
def test_split_decode_matches_jax(label, pos0, weights, jax_out):
    """Two split decode steps on the case's mesh against JAX's jitted
    step on the same placed cache (logits, ``conf``, each device's
    cache leaves) and against the port's unsharded step (logits,
    ``conf``, the gathered cache)."""
    name, shape, som = CASES[label]
    tp, x = weights[0][name], weights[1][name]
    got, want, cache, one, cspecs, tmesh = _split_run(
        config(name), shape, som, pos0, tp, x)
    ref = jax_out[label, pos0]
    self_tol = INT8_SELF_TOL if name.endswith("int8") else SELF_TOL
    for i, ((lg, conf), (lg1, conf1)) in enumerate(zip(got, want)):
        np.testing.assert_allclose(lg.numpy(), ref["logits"][i],
                                   err_msg=f"step {i} logits", **TOL)
        np.testing.assert_allclose(conf.numpy(), ref["conf"][i],
                                   err_msg=f"step {i} conf", **TOL)
        torch.testing.assert_close(lg, lg1, **self_tol)
        torch.testing.assert_close(conf, conf1, **self_tol)
    decl = cache_lib.declare_cache(config(name), 1, T)
    for e, row in enumerate(cache):
        for j, tree in enumerate(row):
            tree_map(lambda c, g, w, e=e, j=j: np.testing.assert_allclose(
                g.numpy(), w, err_msg=f"device ({e}, {j})", **TOL),
                decl, tree, ref["cache"][e][j])
    sizes = mesh_lib.axis_sizes(tmesh)
    for g, w in zip(tree_leaves(steps.gather(cache, cspecs, sizes=sizes)),
                    tree_leaves(one)):
        # an int8 entry may round one step apart where its row's keys
        # differ within self_tol
        torch.testing.assert_close(g.float(), w.float(), **(
            dict(atol=1, rtol=0) if g.dtype == torch.int8 else self_tol))
