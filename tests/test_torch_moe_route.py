"""MoE routing with expert-queue ranks (``kernels/router_gate.py::
moe_route_ref``, the plain version of the ``moe_route`` kernel) on the
CPU: against a sequential numpy counter of (slot, pick) order, against
the JAX package's own rank formula (``repro/models/blocks.py::moe_ffn``:
a cumsum of the one-hot picks) on the JAX router's picks, and a model of
the kernel's split of a group across blocks (block-local ranks from
per-expert row masks, then the last block's offsets in block order)
against the plain version.  The kernel itself runs in the ``cuda``-marked
route tests of ``test_torch_kernels_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jax_ref  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import router_gate as router_mod  # noqa: E402
from tests.test_torch_kernels_cuda import (ROUTE_CASES,  # noqa: E402
                                           _route_cap, _route_logits)

CASES = [(c, False) for c in sorted(ROUTE_CASES)] + [
    ("granite-bucket", True), ("granite-decode", True),
    ("jamba-prefill", True)]


def _case(case, ties):
    G, gs, k, E, cf = ROUTE_CASES[case]
    x = _route_logits(case, seed=len(case) + 7 * ties, ties=ties)
    return x, k, E, _route_cap(gs, k, E, cf)


def _sequential(idx, E, cap):
    """dest of every (slot, pick) pair from one counter per expert,
    walked in (slot, pick) order over each group."""
    G, gs, k = idx.shape
    dest = np.empty(idx.shape, np.int64)
    for g in range(G):
        count = np.zeros(E, np.int64)
        for s in range(gs):
            for j in range(k):
                e = int(idx[g, s, j])
                r = count[e]
                count[e] += 1
                dest[g, s, j] = (e * G + g) * cap + r if r < cap \
                    else E * G * cap
    return dest


def _popcount(v):
    return bin(int(v)).count("1")


def _kernel_model(idx, E, cap, rows_per_block):
    """The kernel's dest: a group's slots cut into blocks of
    ``route_blocks`` rows; in block b, row w ORs bit w into a mask per
    expert it picked, a pair's block-local rank is the count of the
    mask's bits below w and the block's count of e the mask's bits; the
    last block adds to each pair the counts of its expert over the blocks
    before its own, in block order."""
    G, gs, k = idx.shape
    rows, nb = router_mod.route_blocks(gs, rows_per_block)
    dest = np.empty(idx.shape, np.int64)
    for g in range(G):
        local = np.empty((gs, k), np.int64)
        hist = np.zeros((nb, E), np.int64)
        for b in range(nb):
            rows_of = np.zeros(E, np.uint32)
            slots = range(b * rows, min(gs, (b + 1) * rows))
            for w, s in enumerate(slots):
                for e in idx[g, s]:
                    rows_of[e] |= np.uint32(1 << w)
            for w, s in enumerate(slots):
                for j, e in enumerate(idx[g, s]):
                    local[s, j] = _popcount(rows_of[e] & ((1 << w) - 1))
            hist[b] = [_popcount(m) for m in rows_of]
        offset = np.cumsum(hist, axis=0) - hist            # exclusive
        for s in range(gs):
            for j, e in enumerate(idx[g, s]):
                r = local[s, j] + offset[s // rows, e]
                dest[g, s, j] = (e * G + g) * cap + r if r < cap \
                    else E * G * cap
    return dest


@pytest.mark.parametrize("case,ties", CASES)
def test_route_ref_matches_sequential_counter_and_jax_ranks(case, ties):
    """Picks equal the JAX router's (ties to the lower index), gates
    within rtol 1e-5; dest equals the sequential counter's and the one
    built from JAX's ranks (``cumsum(one_hot) - one_hot``) exactly; the
    weight is the gate where kept and 0 where dropped."""
    x, k, E, cap = _case(case, ties)
    G = x.shape[0]
    gates, idx, dest, weight = router_mod.moe_route_ref(
        torch.from_numpy(x), k, cap)
    assert gates.dtype == weight.dtype == torch.float32
    assert idx.dtype == torch.int32 and dest.dtype == torch.int64
    assert gates.shape == idx.shape == dest.shape == weight.shape \
        == x.shape[:2] + (k,)
    want_g, want_i = jax_ref.router_gate_ref(jnp.asarray(x), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(gates.numpy(), np.asarray(want_g),
                               rtol=1e-5, atol=0)
    idx_h = idx.numpy()
    # a row's picks are distinct experts (the kernel's ranks rest on it)
    assert all(len(set(r)) == k for r in idx_h.reshape(-1, k))
    np.testing.assert_array_equal(dest.numpy(), _sequential(idx_h, E, cap))
    # the JAX package's ranks: one-hot picks in (slot, pick) order
    flat = jax.nn.one_hot(jnp.asarray(want_i), E).reshape(G, -1, E)
    ranks = ((jnp.cumsum(flat, axis=1) - flat) * flat).sum(-1)
    rank = np.asarray(ranks).astype(np.int64).reshape(idx_h.shape)
    keep = rank < cap
    grp = np.arange(G)[:, None, None]
    np.testing.assert_array_equal(
        dest.numpy(),
        np.where(keep, (idx_h * G + grp) * cap + rank, E * G * cap))
    np.testing.assert_array_equal(weight.numpy(),
                                  np.where(keep, gates.numpy(), 0.0))
    if case == "cap-gs":
        assert keep.all()
    if case in ("cf0.5", "granite-decode", "E1024"):
        assert (~keep).any()
    if case == "cf0.5":
        assert (~keep).mean() > 0.4


@pytest.mark.parametrize("rows_per_block", [1, 4, 7, 16, 32])
@pytest.mark.parametrize("case,ties", [
    ("granite-bucket", True), ("jamba-prefill", True), ("cf0.5", False),
    ("granite-decode", True), ("E1024", False)])
def test_block_split_model_matches_plain(case, ties, rows_per_block):
    """The kernel's block-local ranks plus the last block's offsets give
    the plain version's dest, for block sizes that split the group's
    slots evenly and not (7), with a run of equal rows, whose experts
    straddle block boundaries, and ties on the k-th pick."""
    x, k, E, cap = _case(case, ties)
    _, idx, dest, _ = router_mod.moe_route_ref(torch.from_numpy(x), k, cap)
    rows, nb = router_mod.route_blocks(x.shape[1], rows_per_block)
    assert rows == min(rows_per_block, x.shape[1])
    assert (nb - 1) * rows < x.shape[1] <= nb * rows
    np.testing.assert_array_equal(
        _kernel_model(idx.numpy(), E, cap, rows_per_block), dest.numpy())


@pytest.mark.parametrize("case,want", [("granite-bucket", (16, 32)),
                                       ("granite-decode", (8, 1)),
                                       ("jamba-prefill", (16, 64)),
                                       ("E1024", (16, 4))])
def test_route_blocks_at_the_served_shapes(case, want):
    """The default cut: granite's full bucket into 32 blocks of 16 rows,
    its decode width into one block (no merge), a jamba group into 64."""
    assert router_mod.route_blocks(ROUTE_CASES[case][1]) == want


def test_ops_moe_route_takes_the_plain_version_on_cpu():
    """The wrapper returns the plain version's tensors for a CPU tensor
    and counts no launch; the launcher refuses a CPU tensor before
    building anything."""
    x, k, E, cap = _case("cf0.5", False)
    t = torch.from_numpy(x)
    before = ops.router_gate.launches
    for got, want in zip(ops.moe_route(t, k, cap),
                         router_mod.moe_route_ref(t, k, cap)):
        assert torch.equal(got, want)
    assert ops.router_gate.launches == before == 0
    with pytest.raises(ValueError, match="CUDA"):
        router_mod.moe_route(t, k, cap)


def test_moe_ffn_routes_through_one_moe_route_call(monkeypatch):
    """Per MoE layer call, ``moe_ffn`` routes once, through
    ``ops.moe_route`` (one kernel launch on the card), and never calls
    ``router_gate`` itself."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import blocks

    calls = []
    real = ops.moe_route

    def counting(logits, k, cap):
        calls.append((tuple(logits.shape), k, cap))
        return real(logits, k, cap)

    def refuse(*a, **kw):
        raise AssertionError("moe_ffn called router_gate")

    monkeypatch.setattr(ops, "moe_route", counting)
    monkeypatch.setattr(ops, "router_gate", refuse)
    spec = dataclasses.replace(
        get_config("granite-moe-3b-a800m", "smoke").period[0].ffn,
        num_experts=8, top_k=2, capacity_factor=1.0, d_ff=16)
    rng = np.random.default_rng(0)
    p = {"router": rng.standard_normal((32, 8)).astype(np.float32)}
    for n in ("wi0", "wi1", "wo"):
        shape = (8, 16, 32) if n == "wo" else (8, 32, 16)
        p[n] = (rng.standard_normal(shape) * 0.2).astype(np.float32)
    x = torch.from_numpy(rng.standard_normal((2, 12, 32)).astype(
        np.float32))
    out = blocks.moe_ffn({k: torch.from_numpy(v) for k, v in p.items()},
                         None, spec, x)
    assert out.shape == x.shape and torch.isfinite(out).all()
    assert calls == [((1, 24, 8), 2, 6)]
