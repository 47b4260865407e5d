"""The torch port's kernel modules against the JAX package.

On the CPU the port's plain versions (``confidence_gate_ref``,
``ragged_attention_ref``) are held to the JAX Pallas kernels run in
interpret mode and to the JAX oracles in ``repro/kernels/ref.py``, on the
same numpy inputs; the ``ops`` wrappers route CPU tensors to the plain
versions without counting a launch.  The CUDA kernels themselves are
checked against the plain versions by the ``cuda``-marked tests, which
skip without a card (``chip_smoke.py`` runs the same comparison at the
main path's full shapes).
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
from repro_torch.core import confidence  # noqa: E402
from repro_torch.kernels import confidence_gate as gate_mod  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ragged_attention as ragged_mod  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run `python3 chip_smoke.py` or "
                    "`pytest -m cuda` on the H100")
    return torch.device("cuda")


# --------------------------------------------------------------------------
# confidence gate
# --------------------------------------------------------------------------


def _logits(shape, seed, tie=False):
    x = (np.random.default_rng(seed).standard_normal(shape) * 4).astype(
        np.float32)
    if tie:
        # an exact tie: the first index must win
        x[..., 3] = 99.0
        x[..., shape[-1] - 2] = 99.0
    return x


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
# ragged attention
# --------------------------------------------------------------------------


def _ragged_inputs(seed, *, qlens, KV, G, hd, bs=4, P=6, quant=False,
                   window=None):
    """A flat-packed batch over a random page pool, as numpy arrays."""
    rng = np.random.default_rng(seed)
    B = len(qlens)
    N = B * P + 1
    if quant:
        kp = rng.integers(-127, 128, (N, bs, KV, hd)).astype(np.int8)
        vp = rng.integers(-127, 128, (N, bs, KV, hd)).astype(np.int8)
        ks = rng.uniform(0.01, 0.05, (N, bs, KV)).astype(np.float32)
        vs = rng.uniform(0.01, 0.05, (N, bs, KV)).astype(np.float32)
    else:
        kp = rng.standard_normal((N, bs, KV, hd)).astype(np.float32)
        vp = rng.standard_normal((N, bs, KV, hd)).astype(np.float32)
        ks = vs = None
    pt = rng.permutation(np.arange(1, N))[:B * P].reshape(B, P).astype(
        np.int32)
    q_len = np.asarray(qlens, np.int32)
    C = max(max(qlens), 1)
    q_start = np.asarray([int(rng.integers(0, P * bs - C + 1))
                          for _ in range(B)], np.int32)
    total = int(q_len.sum())
    W = max(8, 1 << (max(total, 1) - 1).bit_length())
    q = np.zeros((W, KV, G, hd), np.float32)
    q[:total] = rng.standard_normal((total, KV, G, hd))
    return (q, kp, vp, pt, q_start, q_len), dict(k_scale=ks, v_scale=vs,
                                                  window=window)


def _torch(args, kw):
    t = tuple(torch.from_numpy(a) for a in args)
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    return t, tkw


# (q_len per row, KV, G, hd, quant, window): the smoke shapes (gemma:
# KV=1 G=4; phi4: KV=4 G=1), phi4's full G=3, arbitrary q_len in [0, C],
# all-idle, a padded flat tail, sliding windows and int8 pools
RAGGED_CASES = {
    "gemma-smoke-mixed": ([3, 0, 16, 1, 1, 7, 0, 5], 1, 4, 32, False, None),
    "gemma-smoke-window": ([5, 1, 0, 9], 1, 4, 32, False, 6),
    "phi4-smoke-decode": ([1] * 6, 4, 1, 32, False, None),
    "phi4-G3-padded-tail": ([7, 2, 0, 4], 2, 3, 32, False, None),
    "all-idle": ([0] * 5, 1, 4, 32, False, None),
    "single-full-row": ([16, 0, 0, 0], 2, 3, 32, False, 11),
    "int8-scales": ([3, 0, 8, 1], 2, 3, 32, True, None),
    "int8-scales-window": ([6, 2, 1], 1, 4, 32, True, 5),
}


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
# wrappers: CPU tensors take the plain version; CUDA tensors the kernel
# --------------------------------------------------------------------------


def test_ops_wrappers_route_cpu_to_plain_and_count_nothing():
    before = (ops.confidence_gate.launches, ops.ragged_attention.launches)
    x = torch.from_numpy(_logits((3, 700), seed=5))
    g = ops.confidence_gate(x)
    want = ref.confidence_gate_ref(x)
    for k in want:
        assert torch.equal(g[k], want[k])
    args, kw = _ragged_inputs(3, qlens=[2, 0, 3], KV=1, G=4, hd=32)
    targs, tkw = _torch(args, kw)
    assert torch.equal(ops.ragged_attention(*targs, **tkw),
                       ref.ragged_attention_ref(*targs, **tkw))
    assert (ops.confidence_gate.launches,
            ops.ragged_attention.launches) == before == (0, 0)


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


# --------------------------------------------------------------------------
# the CUDA kernels against the plain versions (card only)
# --------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(RAGGED_CASES))
def test_cuda_ragged_attention_matches_plain(case, cuda_device):
    qlens, KV, G, hd, quant, window = RAGGED_CASES[case]
    args, kw = _ragged_inputs(len(case), qlens=qlens, KV=KV, G=G, hd=hd,
                              quant=quant, window=window)
    targs, tkw = _torch(args, kw)
    dargs = tuple(a.to(cuda_device) for a in targs)
    dkw = {k: (v.to(cuda_device) if torch.is_tensor(v) else v)
           for k, v in tkw.items()}
    got = ragged_mod.ragged_attention(*dargs, **dkw).cpu()
    want = ref.ragged_attention_ref(*targs, **tkw)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,tie", [((8, 262144), False),
                                       ((8, 200064), False),
                                       ((3, 1000), True)])
def test_cuda_confidence_gate_matches_plain(shape, tie, cuda_device):
    x = torch.from_numpy(_logits(shape, seed=1, tie=tie))
    got = gate_mod.confidence_gate(x.to(cuda_device))
    want = ref.confidence_gate_ref(x)
    for k in ("conf", "logz"):
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=1e-5, atol=0)
    torch.testing.assert_close(got["entropy"].cpu(), want["entropy"],
                               atol=1e-4, rtol=0)
    assert torch.equal(got["argmax"].cpu(), want["argmax"])
