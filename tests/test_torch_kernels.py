"""The torch port's kernel modules against the JAX package.

On the CPU the port's plain versions (``confidence_gate_ref``,
``ragged_attention_ref``, ``paged_attention_ref``,
``mixed_attention_ref``, ``paged_prefill_attention_ref``,
``router_gate_ref``, ``flash_attention_ref``, ``rwkv6_scan_ref`` and
``mamba_scan_ref``) are held to
the JAX Pallas kernels run in interpret mode and to the JAX oracles in
``repro/kernels/ref.py``, on the same numpy inputs; the ``ops`` wrappers
route CPU tensors to the plain versions without counting a launch.  The
CUDA kernels themselves are checked against the plain versions by the
``cuda``-marked tests of ``test_torch_kernels_cuda.py``, which skip
without a card (``chip_smoke.py`` runs the same comparison at the main
path's full shapes).
"""
import os

import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import confidence as jax_confidence  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.router_gate import router_gate as jax_router_gate  # noqa: E402,E501
from repro_torch.core import confidence  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels import confidence_gate as gate_mod  # noqa: E402
from repro_torch.kernels import flash_attention as flash_mod  # noqa: E402
from repro_torch.kernels import mamba_scan as mamba_mod  # noqa: E402
from repro_torch.kernels import mixed_attention as mixed_mod  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as paged_mod  # noqa: E402
from repro_torch.kernels import prefill_attention as prefill_mod  # noqa: E402
from repro_torch.kernels import ragged_attention as ragged_mod  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import router_gate as router_mod  # noqa: E402
from repro_torch.kernels import rwkv6_scan as rwkv_mod  # noqa: E402
from tests.test_torch_kernels_cuda import (FLASH_CASES,  # noqa: E402
                                           MAMBA_CASES, MIXED_CASES,
                                           PAGED_CASES, RAGGED_CASES,
                                           RWKV_CASES, _flash_inputs,
                                           _logits, _mamba_inputs,
                                           _mixed_inputs, _paged_inputs,
                                           _ragged_inputs, _router_logits,
                                           _rwkv_inputs, _torch)


# --------------------------------------------------------------------------
# confidence gate
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape,tie", [
    ((4, 512), False),          # smoke vocab
    ((3, 1000), False),         # V not a multiple of the 1024 tile
    ((2, 3, 700), False),       # leading dims
    ((5, 4099), False),
    ((3, 1000), True),          # exact tie
])
def test_confidence_gate_matches_jax(shape, tie):
    x = _logits(shape, seed=shape[-1], tie=tie)
    got = {k: v.numpy() for k, v in
           ref.confidence_gate_ref(torch.from_numpy(x)).items()}
    for want in (jax_ops.confidence_gate(jnp.asarray(x), interpret=True),
                 jax_ref.confidence_gate_ref(jnp.asarray(x))):
        for k in ("conf", "entropy", "logz"):
            np.testing.assert_allclose(got[k], np.asarray(want[k]),
                                       rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(got["argmax"],
                                      np.asarray(want["argmax"]))
    if tie:
        assert (got["argmax"] == 3).all()


@pytest.mark.parametrize("fn", ["max_prob", "entropy_confidence",
                                "margin"])
@pytest.mark.parametrize("temperature", [1.0, 2.5])
def test_confidence_scores_match_jax(fn, temperature):
    x = _logits((4, 300), seed=7)
    got = getattr(confidence, fn)(torch.from_numpy(x), temperature)
    want = getattr(jax_confidence, fn)(jnp.asarray(x), temperature)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("reduce", ["mean", "min", "prod"])
def test_sequence_confidence_matches_jax(reduce):
    rng = np.random.default_rng(3)
    c = rng.uniform(0.01, 1.0, (5, 7)).astype(np.float32)
    m = (rng.random((5, 7)) < 0.7).astype(np.float32)
    m[:, 0] = 1.0
    got = confidence.sequence_confidence(torch.from_numpy(c),
                                         torch.from_numpy(m), reduce)
    want = jax_confidence.sequence_confidence(jnp.asarray(c),
                                              jnp.asarray(m), reduce)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


# --------------------------------------------------------------------------
# MoE router gate
# --------------------------------------------------------------------------


@pytest.mark.parametrize("E,k", [(4, 2), (40, 8), (64, 6), (384, 8)])
def test_router_gate_matches_jax(E, k):
    """Against the TPU kernel in interpret mode and the JAX oracle, over
    batch dims, with rows of exact ties (the lower index first): indices
    exact, gates within rtol 1e-6 (the same f32 softmax)."""
    x = _router_logits((2, 3, E), k, seed=E, ties=True)
    gates, idx = ref.router_gate_ref(torch.from_numpy(x), k)
    assert gates.shape == idx.shape == (2, 3, k)
    assert idx.dtype == torch.int32 and gates.dtype == torch.float32
    for want_g, want_i in (jax_router_gate(jnp.asarray(x), k, interpret=True),
                           jax_ref.router_gate_ref(jnp.asarray(x), k)):
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
        np.testing.assert_allclose(gates.numpy(), np.asarray(want_g),
                                   rtol=1e-6, atol=1e-7)
    t = idx.numpy().reshape(-1, k)
    assert (t[0] == np.arange(k)).all()             # all equal: 0..k-1
    top = sorted({1, E // 2, E - 1})[:k]            # the three-way tie
    assert list(t[1, :len(top)]) == top
    assert t[2, k - 1] == 1 and E - k not in t[2]   # the k-th tie: index 1
    np.testing.assert_allclose(gates.numpy().sum(-1), 1.0, rtol=1e-6)


# --------------------------------------------------------------------------
# ragged attention
# --------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(RAGGED_CASES))
def test_ragged_attention_matches_jax(case):
    qlens, KV, G, hd, quant, window = RAGGED_CASES[case]
    args, kw = _ragged_inputs(len(case), qlens=qlens, KV=KV, G=G, hd=hd,
                              quant=quant, window=window)
    targs, tkw = _torch(args, kw)
    got = ref.ragged_attention_ref(*targs, **tkw).numpy()
    jargs = tuple(jnp.asarray(a) for a in args)
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    total = int(np.sum(qlens))
    for want in (jax_ops.ragged_attention(*jargs, interpret=True, **jkw),
                 jax_ref.ragged_attention_ref(*jargs, **jkw)):
        np.testing.assert_allclose(got[:total], np.asarray(want)[:total],
                                   atol=1e-5, rtol=1e-5)
    assert not got[total:].any()        # padding slots are zero


# --------------------------------------------------------------------------
# paged decode and mixed (padded) attention
# --------------------------------------------------------------------------


def _jax(args, kw):
    return (tuple(jnp.asarray(a) for a in args),
            {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
             for k, v in kw.items()})


@pytest.mark.parametrize("case", sorted(PAGED_CASES))
def test_paged_attention_matches_jax(case):
    B, KV, G, hd, quant, window, masked = PAGED_CASES[case]
    args, kw = _paged_inputs(len(case), B=B, KV=KV, G=G, hd=hd, quant=quant,
                             window=window, masked=masked)
    targs, tkw = _torch(args, kw)
    got = ref.paged_attention_ref(*targs, **tkw).numpy()
    jargs, jkw = _jax(args, kw)
    for want in (jax_ops.paged_attention(*jargs, interpret=True, **jkw),
                 jax_ref.paged_attention_ref(*jargs, **jkw)):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("case", sorted(MIXED_CASES))
def test_mixed_attention_matches_jax(case):
    qlens, KV, G, hd, quant, window, masked = MIXED_CASES[case]
    args, kw = _mixed_inputs(len(case), qlens=qlens, KV=KV, G=G, hd=hd,
                             quant=quant, window=window, masked=masked)
    targs, tkw = _torch(args, kw)
    got = ref.mixed_attention_ref(*targs, **tkw).numpy()
    np.testing.assert_array_equal(
        ref.paged_prefill_attention_ref(*targs, **tkw).numpy(), got)
    jargs, jkw = _jax(args, kw)
    live = np.arange(got.shape[1])[None, :] < np.asarray(qlens)[:, None]
    for want in (jax_ops.mixed_attention(*jargs, interpret=True, **jkw),
                 jax_ops.paged_prefill_attention(*jargs, interpret=True,
                                                 **jkw),
                 jax_ref.mixed_attention_ref(*jargs, **jkw),
                 jax_ref.paged_prefill_attention_ref(*jargs, **jkw)):
        np.testing.assert_allclose(got[live], np.asarray(want)[live],
                                   atol=1e-5, rtol=1e-5)
    assert not got[~live].any()         # dead slots are zero


def test_mixed_decode_rows_match_paged_decode():
    """A ``q_len == 1`` row of the padded batch is a paged decode step at
    ``q_start``, as the JAX tests pin it."""
    args, kw = _mixed_inputs(9, qlens=[1, 1, 1, 1], KV=2, G=3, hd=32, C=3,
                             window=7)
    targs, tkw = _torch(args, kw)
    q, kp, vp, pt, q_start, _ = targs
    got = ref.mixed_attention_ref(*targs, **tkw)[:, 0]
    want = ref.paged_attention_ref(q[:, 0].contiguous(), kp, vp, pt,
                                   q_start, **tkw)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


# --------------------------------------------------------------------------
# dense flash attention and the RWKV-6 scan
# --------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(c for c in FLASH_CASES
                                        if FLASH_CASES[c][5] <= 64))
def test_flash_attention_matches_jax(case):
    """Against the TPU kernel in interpret mode (128-row tiles, so S = 45,
    100 and 130 leave partial tiles) and the JAX oracle: causal and
    windowed, GQA, d 32 and 64, more keys than queries; atol = rtol =
    1e-5 (the same f32 softmax, summed in another order)."""
    B, H, KV, S, T, d, causal, window = FLASH_CASES[case]
    q, k, v = _flash_inputs(len(case), B, H, KV, S, T, d)
    got = ref.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=causal,
                                  window=window).numpy()
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    for want in (jax_ops.flash_attention(jq, jk, jv, causal=causal,
                                         window=window, interpret=True),
                 jax_ref.flash_attention_ref(jq, jk, jv, causal=causal,
                                             window=window)):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("case", sorted(c for c in RWKV_CASES
                                        if RWKV_CASES[c][3] == 32))
def test_rwkv6_scan_matches_jax(case):
    """``y`` against the TPU kernel in interpret mode (its 128-step
    chunks: T = 130 carries the state across two) and the JAX oracle,
    atol = rtol = 1e-5; the final state has the oracle's shape."""
    B, H, T, hd = RWKV_CASES[case]
    args = _rwkv_inputs(len(case), B, H, T, hd)
    y, s_T = ref.rwkv6_scan_ref(*(torch.from_numpy(a) for a in args))
    assert y.dtype == s_T.dtype == torch.float32
    assert tuple(s_T.shape) == (B, H, hd, hd)
    jargs = tuple(jnp.asarray(a) for a in args)
    for want in (jax_ops.rwkv6_scan(*jargs, interpret=True),
                 jax_ref.rwkv6_scan_ref(*jargs)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)


def test_rwkv6_scan_state_is_the_recurrence_carried_on():
    """Splitting the sequence: the state after the first part, carried
    through the second part's steps by hand, is the state after the
    whole (and the second part's outputs follow from it)."""
    r, k, v, w, u = (torch.from_numpy(a) for a in _rwkv_inputs(
        5, 1, 2, 40, 32))
    y, s_T = ref.rwkv6_scan_ref(r, k, v, w, u)
    y1, s1 = ref.rwkv6_scan_ref(*(a[:, :, :25] for a in (r, k, v, w)), u)
    torch.testing.assert_close(y1, y[:, :, :25], atol=0, rtol=0)
    S = s1
    for t in range(25, 40):
        kv = k[:, :, t, :, None] * v[:, :, t, None, :]
        y_t = torch.einsum("bhk,bhkv->bhv", r[:, :, t], S + u[..., None] * kv)
        torch.testing.assert_close(y_t, y[:, :, t], atol=1e-5, rtol=1e-5)
        S = w[:, :, t, :, None] * S + kv
    torch.testing.assert_close(S, s_T, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("case", sorted(MAMBA_CASES))
def test_mamba_scan_matches_jax(case):
    """``y`` against the TPU kernel in interpret mode (its 128-step time
    chunks and 512-channel tiles: T = 150 and d = 600 cross both) and
    the JAX oracle, atol = rtol = 1e-5; T = 0, where the TPU kernel's
    grid is empty, against the oracle alone.  The final state against a
    ``lax.scan`` of the JAX block's step carried to the end, atol = rtol
    = 1e-5."""
    import jax
    B, T, d, n = MAMBA_CASES[case]
    args = _mamba_inputs(len(case), B, T, d, n)
    y, h_T = ref.mamba_scan_ref(*(torch.from_numpy(a) for a in args))
    assert y.dtype == h_T.dtype == torch.float32
    assert tuple(y.shape) == (B, T, d) and tuple(h_T.shape) == (B, d, n)
    jargs = tuple(jnp.asarray(a) for a in args)
    wants = [jax_ref.mamba_scan_ref(*jargs)]
    if T:
        wants.append(jax_ops.mamba_scan(*jargs, interpret=True))
    for want in wants:
        np.testing.assert_allclose(y.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)
    x, dt, Bt, Ct, A = jargs

    def step(h, inp):                  # repro/models/blocks.py::mamba
        dt_t, B_t, x_t = inp
        return (jnp.exp(dt_t[..., None] * A) * h
                + (dt_t * x_t)[..., None] * B_t[:, None, :]), None
    h_want, _ = jax.lax.scan(step, jnp.zeros((B, d, n), jnp.float32),
                             (dt.transpose(1, 0, 2), Bt.transpose(1, 0, 2),
                              x.transpose(1, 0, 2)))
    np.testing.assert_allclose(h_T.numpy(), np.asarray(h_want), atol=1e-5,
                               rtol=1e-5)


def test_mamba_scan_state_is_the_recurrence_carried_on():
    """Splitting the sequence: the state after the first part, carried
    through the second part's steps by hand, is the state after the
    whole (and the second part's outputs follow from it)."""
    x, dt, Bt, Ct, A = (torch.from_numpy(a)
                        for a in _mamba_inputs(7, 2, 40, 24, 8))
    y, h_T = ref.mamba_scan_ref(x, dt, Bt, Ct, A)
    y1, h = ref.mamba_scan_ref(x[:, :25], dt[:, :25], Bt[:, :25],
                               Ct[:, :25], A)
    torch.testing.assert_close(y1, y[:, :25], atol=0, rtol=0)
    for t in range(25, 40):
        h = torch.exp(dt[:, t, :, None] * A) * h \
            + (dt[:, t] * x[:, t])[..., None] * Bt[:, t, None, :]
        torch.testing.assert_close(torch.einsum("bdn,bn->bd", h, Ct[:, t]),
                                   y[:, t], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(h, h_T, atol=1e-5, rtol=1e-5)


# --------------------------------------------------------------------------
# wrappers: CPU tensors take the plain version; CUDA tensors the kernel
# --------------------------------------------------------------------------


LAUNCHED = ("confidence_gate", "ragged_attention", "paged_attention",
            "mixed_attention", "router_gate", "flash_attention",
            "rwkv6_scan", "mamba_scan")


def test_ops_wrappers_route_cpu_to_plain_and_count_nothing():
    before = tuple(getattr(ops, n).launches for n in LAUNCHED)
    x = torch.from_numpy(_logits((3, 700), seed=5))
    g = ops.confidence_gate(x)
    want = ref.confidence_gate_ref(x)
    for k in want:
        assert torch.equal(g[k], want[k])
    args, kw = _ragged_inputs(3, qlens=[2, 0, 3], KV=1, G=4, hd=32)
    targs, tkw = _torch(args, kw)
    assert torch.equal(ops.ragged_attention(*targs, **tkw),
                       ref.ragged_attention_ref(*targs, **tkw))
    args, kw = _paged_inputs(3, B=3, KV=1, G=4, hd=32)
    targs, tkw = _torch(args, kw)
    assert torch.equal(ops.paged_attention(*targs, **tkw),
                       ref.paged_attention_ref(*targs, **tkw))
    args, kw = _mixed_inputs(3, qlens=[2, 0, 4, 1], KV=1, G=4, hd=32)
    targs, tkw = _torch(args, kw)
    want = ref.mixed_attention_ref(*targs, **tkw)
    assert torch.equal(ops.mixed_attention(*targs, **tkw), want)
    assert torch.equal(ops.paged_prefill_attention(*targs, **tkw), want)
    assert torch.equal(ref.paged_prefill_attention_ref(*targs, **tkw), want)
    x = torch.from_numpy(_router_logits((5, 40), 8, seed=5))
    for got, want in zip(ops.router_gate(x, 8), ref.router_gate_ref(x, 8)):
        assert torch.equal(got, want)
    q, k, v = (torch.from_numpy(a) for a in _flash_inputs(3, 1, 4, 2, 9, 9,
                                                          32))
    assert torch.equal(ops.flash_attention(q, k, v, window=4),
                       ref.flash_attention_ref(q, k, v, window=4))
    args = [torch.from_numpy(a) for a in _rwkv_inputs(3, 1, 2, 5, 32)]
    for got, want in zip(ops.rwkv6_scan(*args), ref.rwkv6_scan_ref(*args)):
        assert torch.equal(got, want)
    args = [torch.from_numpy(a) for a in _mamba_inputs(3, 2, 5, 24, 8)]
    for got, want in zip(ops.mamba_scan(*args), ref.mamba_scan_ref(*args)):
        assert torch.equal(got, want)
    after = tuple(getattr(ops, n).launches for n in LAUNCHED)
    assert after == before == (0,) * len(LAUNCHED)


def test_kernel_launchers_refuse_cpu_tensors():
    """The CUDA launchers never compute on the CPU: a CPU tensor raises
    before anything is built or launched."""
    x = torch.zeros(2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        gate_mod.confidence_gate(x)
    args, kw = _ragged_inputs(1, qlens=[1, 2], KV=1, G=1, hd=32)
    targs, tkw = _torch(args, kw)
    with pytest.raises(ValueError, match="CUDA"):
        ragged_mod.ragged_attention(*targs, **tkw)
    targs, tkw = _torch(*_paged_inputs(1, B=2, KV=1, G=1, hd=32))
    with pytest.raises(ValueError, match="CUDA"):
        paged_mod.paged_attention(*targs, **tkw)
    targs, tkw = _torch(*_mixed_inputs(1, qlens=[1, 2], KV=1, G=1, hd=32))
    with pytest.raises(ValueError, match="CUDA"):
        mixed_mod.mixed_attention(*targs, **tkw)
    with pytest.raises(ValueError, match="CUDA"):
        prefill_mod.paged_prefill_attention(*targs, **tkw)
    with pytest.raises(ValueError, match="CUDA"):
        router_mod.router_gate(torch.zeros(4, 40), 8)
    with pytest.raises(ValueError, match="CUDA"):
        flash_mod.flash_attention(torch.zeros(1, 2, 4, 32),
                                  torch.zeros(1, 1, 4, 32),
                                  torch.zeros(1, 1, 4, 32))
    with pytest.raises(ValueError, match="CUDA"):
        rwkv_mod.rwkv6_scan(*(torch.from_numpy(a) for a in _rwkv_inputs(
            1, 1, 1, 3, 32)))
    with pytest.raises(ValueError, match="CUDA"):
        mamba_mod.mamba_scan(*(torch.from_numpy(a) for a in _mamba_inputs(
            1, 1, 3, 24, 8)))


def test_kernel_library_hash_covers_shared_headers(tmp_path, monkeypatch):
    """An edited shared header (``csrc/*.cuh``) must rebuild every kernel
    that includes it: the library name hashes the headers too."""
    for f in kernels.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    before = {n: kernels.library_path(n) for n in kernels.KERNELS}
    header = tmp_path / "paged_tile.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: kernels.library_path(n) for n in kernels.KERNELS}
    assert all(before[n] != after[n] for n in kernels.KERNELS)
