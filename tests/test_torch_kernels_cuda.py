"""The torch port's CUDA kernels against their plain versions, on the
card (the ``cuda``-marked tests skip themselves without one), and the
numpy-seeded inputs the CPU tests of ``test_torch_kernels.py`` share.

This file imports neither JAX nor the JAX package, so it runs on a
machine with a card and no JAX:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_kernels_cuda.py``.
``chip_smoke.py`` runs the same comparisons at the main path's shapes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import confidence_gate as gate_mod  # noqa: E402
from repro_torch.kernels import flash_attention as flash_mod  # noqa: E402
from repro_torch.kernels import mamba_scan as mamba_mod  # noqa: E402
from repro_torch.kernels import mixed_attention as mixed_mod  # noqa: E402
from repro_torch.kernels import paged_attention as paged_mod  # noqa: E402
from repro_torch.kernels import ragged_attention as ragged_mod  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import router_gate as router_mod  # noqa: E402
from repro_torch.kernels import rwkv6_scan as rwkv_mod  # noqa: E402


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run `python3 chip_smoke.py` or "
                    "`pytest -m cuda` on the H100")
    return torch.device("cuda")


def _logits(shape, seed, tie=False):
    x = (np.random.default_rng(seed).standard_normal(shape) * 4).astype(
        np.float32)
    if tie:
        # an exact tie: the first index must win
        x[..., 3] = 99.0
        x[..., shape[-1] - 2] = 99.0
    return x


def _router_logits(shape, k, seed, ties=False):
    """Router logits [..., E] whose k+1 largest values per row are at
    least 1e-4 apart, so the kernel (which ranks logits) and the plain
    version (which ranks f32 probabilities) cannot order a near-tie
    differently.  ``ties`` overwrites rows of the first leading index
    with exact ties: all equal, a tie on the max, and a tie across the
    k-th/(k+1)-th boundary — the lower index must come first."""
    rng = np.random.default_rng(seed)
    E = shape[-1]
    x = (rng.standard_normal(shape) * 2).astype(np.float32).reshape(-1, E)
    n = min(k + 1, E)
    for r in range(x.shape[0]):
        while (-np.diff(np.sort(x[r])[::-1][:n])).min() < 1e-4:
            x[r] = (rng.standard_normal(E) * 2).astype(np.float32)
    if ties:
        x[0] = 0.5                                  # every expert equal
        x[1, [E - 1, E // 2, 1]] = 30.0             # three-way tie on top
        # k-1 distinct leaders, then a tie for the k-th pick: index 1
        # wins it, index E-k is left out
        x[2, E - k + 1:] = 20.0 + np.arange(k - 1)
        x[2, [1, E - k]] = 15.0
    return x.reshape(shape)


# (shape, k): the smoke MoE, granite's 40 experts at the ragged decode,
# padded and split widths, and E up to the kernel's 1024 limit
ROUTER_CASES = {
    "smoke-E4": ((2, 5, 4), 2),
    "granite-decode": ((8, 40), 8),
    "granite-bucket": ((512, 40), 8),
    "granite-batched": ((1, 24, 40), 8),
    "E64-k6": ((3, 7, 64), 6),
    "E384": ((64, 384), 8),
    "E1024": ((16, 1024), 8),
}


def _ragged_inputs(seed, *, qlens, KV, G, hd, bs=4, P=6, quant=False,
                   window=None, q_start=None):
    """A flat-packed batch over a random page pool, as numpy arrays (each
    row's first position drawn, or ``q_start``)."""
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
    draws = np.asarray([int(rng.integers(0, P * bs - C + 1))
                        for _ in range(B)], np.int32)
    q_start = draws if q_start is None else np.asarray(q_start, np.int32)
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


def _pool(rng, N, bs, KV, hd, quant):
    if quant:
        kp = rng.integers(-127, 128, (N, bs, KV, hd)).astype(np.int8)
        vp = rng.integers(-127, 128, (N, bs, KV, hd)).astype(np.int8)
        ks = rng.uniform(0.01, 0.05, (N, bs, KV)).astype(np.float32)
        vs = rng.uniform(0.01, 0.05, (N, bs, KV)).astype(np.float32)
        return kp, vp, ks, vs
    return (rng.standard_normal((N, bs, KV, hd)).astype(np.float32),
            rng.standard_normal((N, bs, KV, hd)).astype(np.float32),
            None, None)


def _paged_inputs(seed, *, B, KV, G, hd, bs=4, P=6, quant=False,
                  window=None, masked=(), pos=None):
    """One decode query per row at a random depth (or at ``pos``) over a
    shuffled pool; rows in ``masked`` get an all-zero page-table row (the
    split decode step's mask), as numpy arrays."""
    rng = np.random.default_rng(seed)
    N = B * P + 1
    kp, vp, ks, vs = _pool(rng, N, bs, KV, hd, quant)
    pt = rng.permutation(np.arange(1, N))[:B * P].reshape(B, P).astype(
        np.int32)
    pt[list(masked)] = 0
    draws = rng.integers(0, P * bs, B).astype(np.int32)
    pos = draws if pos is None else np.asarray(pos, np.int32)
    q = rng.standard_normal((B, KV, G, hd)).astype(np.float32)
    return (q, kp, vp, pt, pos), dict(k_scale=ks, v_scale=vs, window=window)


def _mixed_inputs(seed, *, qlens, KV, G, hd, C=None, bs=4, P=6,
                  quant=False, window=None, masked=()):
    """A padded [B, C] batch: row b's q_len[b] live slots start at a
    random position that keeps them inside the row's pages."""
    rng = np.random.default_rng(seed)
    B = len(qlens)
    C = C or max(max(qlens), 1)
    N = B * P + 1
    kp, vp, ks, vs = _pool(rng, N, bs, KV, hd, quant)
    pt = rng.permutation(np.arange(1, N))[:B * P].reshape(B, P).astype(
        np.int32)
    pt[list(masked)] = 0
    q_start = rng.integers(0, P * bs - C + 1, B).astype(np.int32)
    q = rng.standard_normal((B, C, KV, G, hd)).astype(np.float32)
    return (q, kp, vp, pt, q_start, np.asarray(qlens, np.int32)), dict(
        k_scale=ks, v_scale=vs, window=window)


# (rows, KV, G, hd, quant, window, masked rows): the smoke shapes (gemma
# KV=1 G=4, phi4 KV=4 G=1), phi4's full G=3, windows, int8 pools and a
# row masked to the null block
PAGED_CASES = {
    "gemma-smoke": (5, 1, 4, 32, False, None, ()),
    "gemma-smoke-window": (4, 1, 4, 32, False, 6, ()),
    "phi4-smoke": (6, 4, 1, 32, False, None, ()),
    "G3-masked-row": (4, 2, 3, 32, False, None, (1,)),
    "int8-scales": (4, 2, 3, 32, True, None, ()),
    "int8-scales-window-masked": (3, 1, 4, 64, True, 5, (2,)),
}


# The tensor-core tile body of csrc/paged_tile.cuh, on the card only
# (RAGGED_CASES and PAGED_CASES also feed the CPU parity tests).  Pools at
# the served page shape, bs 16 and P 41 (640 + 8 tokens); the served head
# widths (granite 64, phi4 128, gemma3 256) with their G; q_len 64, 37,
# 21, 63, 1 and 0 side by side, so token tiles of 64 // G straddle rows;
# gemma3's window of 512 at positions past 512; q and k scaled x4 (scores
# of std ~16, which one TF32 product per f32 product misses at 1e-4 and
# 3xTF32 holds); int8 pools with scales and bf16; a W = 8 bucket of idle
# rows.  Ragged: (q_len per row, q_start or None, KV, G, hd, kind,
# window, qk_scale).
TILE_QLENS = [64, 37, 21, 63, 1, 0]
TILE_LATE = [580, 600, 530, 560, 640, 0]
RAGGED_TILE_CASES = {
    "hd64-straddle": (TILE_QLENS, None, 2, 3, 64, "f32", None, 1.0),
    "hd128-straddle": (TILE_QLENS, None, 2, 3, 128, "f32", None, 1.0),
    "hd256-straddle": (TILE_QLENS, None, 1, 4, 256, "f32", None, 1.0),
    "hd256-window512-late": (TILE_QLENS, TILE_LATE, 1, 4, 256, "f32", 512,
                             1.0),
    "hd128-x4": (TILE_QLENS, None, 2, 3, 128, "f32", None, 4.0),
    "hd256-x4-window512-late": (TILE_QLENS, TILE_LATE, 1, 4, 256, "f32",
                                512, 4.0),
    "hd128-int8-scales": (TILE_QLENS, TILE_LATE, 2, 3, 128, "int8+scales",
                          None, 1.0),
    "hd64-bf16": (TILE_QLENS, None, 2, 3, 64, "bf16", None, 1.0),
    "hd256-bf16-window512-late": (TILE_QLENS, TILE_LATE, 1, 4, 256, "bf16",
                                  512, 1.0),
    "all-idle-W8": ([0] * 8, None, 2, 3, 128, "f32", None, 1.0),
}
# Paged: (rows, KV, G, hd, kind, window, masked rows, qk_scale); rows at
# positions 590-625 (the decode tick chip_smoke.py times), a ninth row
# masked to the null block at 300
TILE_POS = [590, 595, 600, 605, 610, 615, 620, 625, 300]
PAGED_TILE_CASES = {
    "hd64": (8, 2, 3, 64, "f32", None, (), 1.0),
    "hd128-masked": (9, 2, 3, 128, "f32", None, (8,), 1.0),
    "hd256-global": (8, 1, 4, 256, "f32", None, (), 1.0),
    "hd256-window512-masked": (9, 1, 4, 256, "f32", 512, (8,), 1.0),
    "hd128-x4": (8, 2, 3, 128, "f32", None, (), 4.0),
    "hd256-x4-window512": (8, 1, 4, 256, "f32", 512, (), 4.0),
    "hd128-int8-scales-masked": (9, 2, 3, 128, "int8+scales", None, (8,),
                                 1.0),
    "hd256-bf16-window512": (8, 1, 4, 256, "bf16", 512, (), 1.0),
}
TILE_TOLS = {"f32": (1e-4, 1e-4), "int8+scales": (1e-4, 1e-4),
             "bf16": (1e-3, 1e-2)}
# splits: the launcher's plan, forced to 1, and forced to many (more than
# some items have K/V tiles, so some splits are empty)
TILE_SPLITS = (None, 1, 16)


def _ragged_tile_inputs(case):
    """numpy (q, kp, vp, pt, q_start, q_len) and kwargs of a
    RAGGED_TILE_CASES case, q and k scaled."""
    qlens, q_start, KV, G, hd, kind, window, qk = RAGGED_TILE_CASES[case]
    args, kw = _ragged_inputs(len(case), qlens=qlens, KV=KV, G=G, hd=hd,
                              bs=16, P=41, quant=kind == "int8+scales",
                              window=window, q_start=q_start)
    if qk != 1.0:
        args = (args[0] * np.float32(qk), args[1] * np.float32(qk)) + args[2:]
    return args, kw


def _paged_tile_inputs(case):
    """numpy (q, kp, vp, pt, pos) and kwargs of a PAGED_TILE_CASES case,
    q and k scaled."""
    B, KV, G, hd, kind, window, masked, qk = PAGED_TILE_CASES[case]
    args, kw = _paged_inputs(len(case), B=B, KV=KV, G=G, hd=hd, bs=16, P=41,
                             quant=kind == "int8+scales", window=window,
                             masked=masked, pos=TILE_POS[:B])
    if qk != 1.0:
        args = (args[0] * np.float32(qk), args[1] * np.float32(qk)) + args[2:]
    return args, kw


def _tile_on(dev, args, kw, kind):
    """The case's tensors on ``dev``: q (and float pools) in bf16 for the
    bf16 kind; the plain version's copies, on the CPU, in f32 on the same
    values."""
    targs, tkw = _torch(args, kw)
    if kind == "bf16":
        targs = tuple(a.to(torch.bfloat16) if a.is_floating_point() else a
                      for a in targs)
    dargs = tuple(a.to(dev) for a in targs)
    dkw = {k: (v.to(dev) if torch.is_tensor(v) else v)
           for k, v in tkw.items()}
    fargs = tuple(a.float() if a.dtype == torch.bfloat16 else a
                  for a in targs)
    return dargs, dkw, fargs, tkw


# (q_len per row, KV, G, hd, quant, window, masked rows): chunk, tail,
# decode and idle rows side by side, the gemma smoke window, G in
# {1, 3, 4}, int8 pools and a masked row
MIXED_CASES = {
    "gemma-smoke-mixed": ([8, 3, 1, 0], 1, 4, 32, False, None, ()),
    "gemma-smoke-window": ([8, 1, 5, 8], 1, 4, 32, False, 6, ()),
    "phi4-smoke-decode": ([1] * 5, 4, 1, 32, False, None, ()),
    "G3-tail-masked": ([6, 0, 2, 1], 2, 3, 32, False, None, (1,)),
    "all-idle": ([0] * 3, 1, 4, 32, False, None, ()),
    "int8-scales": ([4, 1, 2], 2, 3, 32, True, None, ()),
    "int8-scales-window": ([7, 1, 0, 3], 1, 4, 64, True, 5, ()),
}


# (B, H, KV, S, T, d, causal, window): the smoke widths (d 32; gemma3's
# window 16 and its global layers), S and T off every tile size, granite
# (d 64), phi4 (d 128) and gemma3 (d 256) head widths, GQA, a sliding
# window without causality, and more keys than queries
FLASH_CASES = {
    "gemma-smoke-window": (2, 4, 1, 45, 45, 32, True, 16),
    "phi4-smoke-global": (2, 4, 4, 45, 45, 32, True, None),
    "granite-d64-130": (1, 6, 2, 130, 130, 64, True, None),
    "phi4-d128-gqa": (1, 6, 2, 70, 70, 128, True, None),
    "gemma-d256-window": (1, 4, 1, 100, 100, 256, True, 33),
    "noncausal-more-keys": (2, 2, 1, 37, 50, 64, False, None),
    "noncausal-window": (1, 2, 2, 40, 40, 32, False, 7),
}


# (B, H, KV, S, T, d, causal, window, qk_scale, kind): the tensor-core
# tiling's own cases, on the card only (FLASH_CASES also feeds the CPU
# parity tests).  q and k scaled x4 give scores of std ~16, which a single
# TF32 product per f32 product misses at 1e-4 and 3xTF32 holds; one
# token; S = T = 65 and 97, off the 64-row query and 32-key tiles; more
# keys than queries without causality at d = 256; bf16 at d = 64 (64-key
# tiles)
FLASH_TC_CASES = {
    "f32-d256-x4": (1, 4, 1, 100, 100, 256, True, None, 4.0, "f32"),
    "f32-d128-x4": (1, 6, 2, 130, 130, 128, True, None, 4.0, "f32"),
    "one-token-d256": (1, 2, 1, 1, 1, 256, True, None, 1.0, "f32"),
    "edge-65-window-d256": (2, 4, 1, 65, 65, 256, True, 40, 1.0, "f32"),
    "edge-97-d128": (1, 4, 2, 97, 97, 128, True, None, 1.0, "f32"),
    "noncausal-more-keys-d256": (1, 4, 1, 50, 97, 256, False, None, 1.0,
                                 "f32"),
    "bf16-d64": (2, 4, 2, 97, 97, 64, True, None, 1.0, "bf16"),
}


def _flash_tc_inputs(case):
    """q (scaled), k (scaled), v of a FLASH_TC_CASES case, f32 numpy."""
    B, H, KV, S, T, d, _, _, qk, _ = FLASH_TC_CASES[case]
    q, k, v = _flash_inputs(len(case), B, H, KV, S, T, d)
    return q * np.float32(qk), k * np.float32(qk), v


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits, to nearest, ties away), as a
    tensor-core operand sees an f32 value it takes in one piece."""
    bits = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    return ((bits + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def _flash_inputs(seed, B, H, KV, S, T, d):
    """q [B, H, S, d], k/v [B, KV, T, d] f32 from a seed."""
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((B, H, S, d), (B, KV, T, d), (B, KV, T, d)))


# (B, H, T, hd): rwkv6-3b-smoke's heads (hd 32) over T off the 32-step
# chunk and the TPU kernel's 128-step one, two batch rows, hd 64 (rwkv6-3b)
# and 128, and a single step
RWKV_CASES = {
    "smoke-T130": (1, 2, 130, 32),
    "two-rows": (2, 3, 33, 32),
    "hd64": (1, 2, 70, 64),
    "hd128": (1, 1, 40, 128),
    "one-step": (1, 2, 1, 32),
}


def _rwkv_inputs(seed, B, H, T, hd):
    """r, k, v [B, H, T, hd], w = exp(-exp(.)) in (0, 1) and u [H, hd],
    f32, at the spreads the model gives them."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, H, T, hd)).astype(np.float32) * 0.5
               for _ in range(3))
    w = np.exp(-np.exp(rng.standard_normal((B, H, T, hd)) * 0.5 - 0.5))
    u = rng.standard_normal((H, hd)) * 0.5
    return r, k, v, w.astype(np.float32), u.astype(np.float32)


# (B, T, d, n): the JAX suite's sweep (T off the TPU kernel's 128-step
# chunk, d past its 512-channel tile and off it), T off the kernel's
# 64-step chunk and 8-step register group, a ragged last group of 128
# channels, n 8 (smoke) and 16 (published), a single step and T = 0
MAMBA_CASES = {
    "smoke-n8": (1, 64, 32, 8),
    "two-rows-T150": (2, 150, 96, 16),
    "d600": (1, 130, 600, 16),
    "ragged-T70": (2, 70, 200, 8),
    "one-step": (1, 1, 40, 8),
    "empty": (2, 0, 24, 16),
}


def _mamba_inputs(seed, B, T, d, n):
    """x [B, T, d], dt = 0.1·softplus(.) > 0, B_t and C_t [B, T, n], A =
    -exp(.) [d, n] < 0, f32, as the JAX suite draws them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, d))
    dt = np.log1p(np.exp(rng.standard_normal((B, T, d)))) * 0.1
    Bt = rng.standard_normal((B, T, n))
    Ct = rng.standard_normal((B, T, n))
    A = -np.exp(rng.standard_normal((d, n)) * 0.3)
    return tuple(a.astype(np.float32) for a in (x, dt, Bt, Ct, A))


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
    """Against the plain version in f64 on the CPU, rounded to f32: an
    exact enough reference that agreement does not hang on the order of
    the sums."""
    x = torch.from_numpy(_logits(shape, seed=1, tie=tie))
    got = gate_mod.confidence_gate(x.to(cuda_device))
    want = ref.confidence_gate_ref(x.double())
    for k in ("conf", "logz"):
        torch.testing.assert_close(got[k].cpu(), want[k].float(), rtol=1e-5,
                                   atol=0)
    torch.testing.assert_close(got["entropy"].cpu(), want["entropy"].float(),
                               atol=1e-4, rtol=0)
    assert torch.equal(got["argmax"].cpu(), want["argmax"])


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(PAGED_CASES))
def test_cuda_paged_attention_matches_plain(case, cuda_device):
    B, KV, G, hd, quant, window, masked = PAGED_CASES[case]
    args, kw = _paged_inputs(len(case), B=B, KV=KV, G=G, hd=hd, quant=quant,
                             window=window, masked=masked)
    targs, tkw = _torch(args, kw)
    dargs = tuple(a.to(cuda_device) for a in targs)
    dkw = {k: (v.to(cuda_device) if torch.is_tensor(v) else v)
           for k, v in tkw.items()}
    got = paged_mod.paged_attention(*dargs, **dkw).cpu()
    want = ref.paged_attention_ref(*targs, **tkw)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("splits", TILE_SPLITS)
@pytest.mark.parametrize("case", sorted(RAGGED_TILE_CASES))
def test_cuda_ragged_attention_tile_cases(case, splits, cuda_device):
    """The tile body at the served widths and page shape, under the
    launcher's split plan, one split and many: f32 and int8 + scales
    within atol = rtol = 1e-4 (the x4 cases hold only with 3xTF32), bf16
    against the plain version in f32 on the same values within atol 1e-3,
    rtol 1e-2; slots past sum(q_len) exactly zero."""
    kind = RAGGED_TILE_CASES[case][5]
    dargs, dkw, fargs, tkw = _tile_on(cuda_device, *_ragged_tile_inputs(case),
                                      kind)
    got = ragged_mod.ragged_attention(*dargs, **dkw, splits=splits).cpu()
    want = ref.ragged_attention_ref(*fargs, **tkw)
    assert got.dtype == dargs[0].dtype
    atol, rtol = TILE_TOLS[kind]
    torch.testing.assert_close(got.float(), want, atol=atol, rtol=rtol)
    total = int(fargs[5].sum())
    assert torch.equal(got[total:], torch.zeros_like(got[total:]))


@pytest.mark.cuda
@pytest.mark.parametrize("splits", TILE_SPLITS)
@pytest.mark.parametrize("case", sorted(PAGED_TILE_CASES))
def test_cuda_paged_attention_tile_cases(case, splits, cuda_device):
    """The tile body at a decode tick, under the launcher's split plan,
    one split and many: live rows within the kind's tolerance of the
    plain version (as the ragged tile cases), a row masked to the null
    block finite."""
    kind, masked = PAGED_TILE_CASES[case][4], PAGED_TILE_CASES[case][6]
    dargs, dkw, fargs, tkw = _tile_on(cuda_device, *_paged_tile_inputs(case),
                                      kind)
    got = paged_mod.paged_attention(*dargs, **dkw, splits=splits).cpu()
    want = ref.paged_attention_ref(*fargs, **tkw)
    assert got.dtype == dargs[0].dtype
    assert bool(torch.isfinite(got.float()).all())
    live = [b for b in range(got.shape[0]) if b not in masked]
    atol, rtol = TILE_TOLS[kind]
    torch.testing.assert_close(got[live].float(), want[live], atol=atol,
                               rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(MIXED_CASES))
def test_cuda_mixed_attention_matches_plain(case, cuda_device):
    qlens, KV, G, hd, quant, window, masked = MIXED_CASES[case]
    args, kw = _mixed_inputs(len(case), qlens=qlens, KV=KV, G=G, hd=hd,
                             quant=quant, window=window, masked=masked)
    targs, tkw = _torch(args, kw)
    dargs = tuple(a.to(cuda_device) for a in targs)
    dkw = {k: (v.to(cuda_device) if torch.is_tensor(v) else v)
           for k, v in tkw.items()}
    got = mixed_mod.mixed_attention(*dargs, **dkw).cpu()
    want = ref.mixed_attention_ref(*targs, **tkw)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("case,ties", [(c, False) for c in sorted(
    ROUTER_CASES)] + [("granite-decode", True), ("E1024", True)])
def test_cuda_router_gate_matches_plain(case, ties, cuda_device):
    """Gates at rtol 1e-5, indices exact — ties included (lower index
    first)."""
    shape, k = ROUTER_CASES[case]
    x = torch.from_numpy(_router_logits(shape, k, seed=len(case),
                                        ties=ties))
    gates, idx = router_mod.router_gate(x.to(cuda_device), k)
    want_g, want_i = ref.router_gate_ref(x, k)
    assert gates.shape == idx.shape == shape[:-1] + (k,)
    assert idx.dtype == torch.int32 and gates.dtype == torch.float32
    assert torch.equal(idx.cpu(), want_i)
    torch.testing.assert_close(gates.cpu(), want_g, rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("case,dtype", [(c, torch.float32) for c in sorted(
    FLASH_CASES)] + [("phi4-d128-gqa", torch.bfloat16),
                     ("gemma-d256-window", torch.bfloat16)])
def test_cuda_flash_attention_matches_plain(case, dtype, cuda_device):
    """f32 within atol = rtol = 1e-4; bf16 inputs against the plain
    version in f32 on the same values, within the output's rounding
    (atol 1e-3, rtol 1e-2)."""
    B, H, KV, S, T, d, causal, window = FLASH_CASES[case]
    q, k, v = (torch.from_numpy(a).to(dtype)
               for a in _flash_inputs(len(case), B, H, KV, S, T, d))
    got = flash_mod.flash_attention(q.to(cuda_device), k.to(cuda_device),
                                    v.to(cuda_device), causal=causal,
                                    window=window)
    assert got.dtype == dtype and got.shape == q.shape
    want = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                   causal=causal, window=window)
    tol = 1e-4 if dtype == torch.float32 else 1e-3
    torch.testing.assert_close(got.cpu().float(), want, atol=tol,
                               rtol=1e-4 if dtype == torch.float32 else 1e-2)


@pytest.mark.cuda
def test_cuda_flash_attention_refuses_unaligned_views(cuda_device):
    """Inputs whose storage starts one element off the 16-byte alignment
    the kernel's vector loads need are refused, not copied."""
    q, k, v = (torch.from_numpy(a).to(cuda_device)
               for a in _flash_inputs(3, 1, 4, 2, 33, 33, 64))
    buf = torch.empty(q.numel() + 1, device=cuda_device)
    shifted = buf[1:].view(q.shape)
    shifted.copy_(q)
    with pytest.raises(ValueError, match="16-byte"):
        flash_mod.flash_attention(shifted, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FLASH_TC_CASES))
def test_cuda_flash_attention_tensor_core_tiles(case, cuda_device):
    """The tensor-core tiling at its edges: f32 within atol = rtol = 1e-4
    (the x4 cases hold only with 3xTF32), bf16 inputs against the plain
    version in f32 on the same values within atol 1e-3, rtol 1e-2."""
    B, H, KV, S, T, d, causal, window, _, kind = FLASH_TC_CASES[case]
    dtype = torch.float32 if kind == "f32" else torch.bfloat16
    q, k, v = (torch.from_numpy(a).to(dtype) for a in _flash_tc_inputs(case))
    got = flash_mod.flash_attention(q.to(cuda_device), k.to(cuda_device),
                                    v.to(cuda_device), causal=causal,
                                    window=window)
    assert got.dtype == dtype and got.shape == q.shape
    want = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                   causal=causal, window=window)
    atol, rtol = (1e-4, 1e-4) if kind == "f32" else (1e-3, 1e-2)
    torch.testing.assert_close(got.cpu().float(), want, atol=atol, rtol=rtol)


@pytest.mark.parametrize("case", sorted(c for c in FLASH_TC_CASES
                                        if FLASH_TC_CASES[c][8] > 1))
def test_flash_x4_cases_defeat_one_tf32_product(case):
    """The x4 cases prove the split: the plain version on q and k rounded
    to TF32 (what one TF32 product per f32 product computes) misses
    atol = rtol = 1e-4, which the card test holds the kernel to."""
    _, _, _, _, _, _, causal, window, _, _ = FLASH_TC_CASES[case]
    q, k, v = _flash_tc_inputs(case)
    want = ref.flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                                   causal=causal, window=window)
    one = ref.flash_attention_ref(torch.from_numpy(_tf32(q)),
                                  torch.from_numpy(_tf32(k)),
                                  torch.from_numpy(v), causal=causal,
                                  window=window)
    assert not torch.allclose(one, want, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(RWKV_CASES))
def test_cuda_rwkv6_scan_matches_plain(case, cuda_device):
    """y and the final state within atol = rtol = 1e-4 (the kernel sums
    the u term apart from the state's)."""
    args = [torch.from_numpy(a) for a in _rwkv_inputs(len(case),
                                                     *RWKV_CASES[case])]
    y, s_T = rwkv_mod.rwkv6_scan(*(a.to(cuda_device) for a in args))
    want_y, want_s = ref.rwkv6_scan_ref(*args)
    torch.testing.assert_close(y.cpu(), want_y, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(s_T.cpu(), want_s, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(MAMBA_CASES) + ["jamba"])
def test_cuda_mamba_scan_matches_plain(case, cuda_device):
    """y and the final state within atol = rtol = 1e-4, at small ragged
    shapes and at jamba's uniform prefill, x [8, 640, 8192], n 16 (the
    plain version on the card there: 640 steps on the CPU would take
    minutes)."""
    shape = (8, 640, 8192, 16) if case == "jamba" else MAMBA_CASES[case]
    args = [torch.from_numpy(a).to(cuda_device)
            for a in _mamba_inputs(len(case), *shape)]
    y, h_T = mamba_mod.mamba_scan(*args)
    want_y, want_h = ref.mamba_scan_ref(*args)
    assert y.shape == args[0].shape and h_T.shape == want_h.shape
    torch.testing.assert_close(y, want_y, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(h_T, want_h, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_cuda_mamba_scan_refuses_what_it_cannot_take(cuda_device):
    """Non-contiguous, non-f32 or unsupported-n inputs are refused, not
    copied or cast."""
    x, dt, Bt, Ct, A = (torch.from_numpy(a).to(cuda_device)
                        for a in _mamba_inputs(2, 2, 9, 24, 8))
    proj = torch.cat([Bt, Ct], dim=-1)
    with pytest.raises(ValueError, match="contiguous"):
        mamba_mod.mamba_scan(x, dt, proj[..., :8], Ct, A)
    with pytest.raises(TypeError, match="float32"):
        mamba_mod.mamba_scan(x.double(), dt.double(), Bt.double(),
                             Ct.double(), A.double())
    with pytest.raises(ValueError, match="d_state"):
        mamba_mod.mamba_scan(x, dt, torch.cat([Bt, Bt[..., :4]], -1),
                             torch.cat([Ct, Ct[..., :4]], -1),
                             torch.cat([A, A[:, :4]], -1))
