"""The torch port's CUDA kernels against their plain versions, on the
card (the ``cuda``-marked tests skip themselves without one), and the
numpy-seeded inputs the CPU tests of ``test_torch_kernels.py`` share.

This file imports neither JAX nor the JAX package, so it runs on a
machine with a card and no JAX:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_kernels_cuda.py``.
``chip_smoke.py`` runs the same comparisons at the main path's shapes.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import confidence_gate as gate_mod  # noqa: E402
from repro_torch.kernels import flash_attention as flash_mod  # noqa: E402
from repro_torch.kernels import mamba_scan as mamba_mod  # noqa: E402
from repro_torch.kernels import mixed_attention as mixed_mod  # noqa: E402
from repro_torch.kernels import paged_attention as paged_mod  # noqa: E402
from repro_torch.kernels import ragged_attention as ragged_mod  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import router_gate as router_mod  # noqa: E402
from repro_torch.kernels import rwkv6_scan as rwkv_mod  # noqa: E402
from repro_torch.models.sharding import shard_config  # noqa: E402


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

# (G, gs, k, E, capacity factor) of moe_route: granite's full ragged
# bucket and its decode width, jamba's uniform prefill (5120 tokens in 5
# groups of 1024), E at the kernel's 1024 limit, a capacity of the whole
# group (nothing dropped) and capacity factor 0.5 (about half the pairs
# dropped); moonshot's 64 experts top-6 and kimi's 384 top-8 over the
# full ragged bucket; granite's train route over a sharded step's global
# batch of 4 x 256 tokens (one group of 1024)
ROUTE_CASES = {
    "granite-bucket": (1, 512, 8, 40, 1.25),
    "granite-train": (1, 1024, 8, 40, 1.25),
    "moonshot-bucket": (1, 512, 6, 64, 1.25),
    "kimi-bucket": (1, 512, 8, 384, 1.25),
    "granite-decode": (1, 8, 8, 40, 1.25),
    "jamba-prefill": (5, 1024, 2, 16, 1.25),
    "E1024": (1, 64, 8, 1024, 1.25),
    "cap-gs": (2, 64, 2, 8, 4.0),
    "cf0.5": (2, 256, 8, 40, 0.5),
}


def _route_cap(gs, k, E, cf):
    """``moe_ffn``'s capacity: min(gs, max(1, ceil(gs * k * cf / E)))."""
    return min(gs, max(1, math.ceil(gs * k * cf / E)))


def _route_logits(case, seed, ties=False):
    """Router logits [G, gs, E] of a ``ROUTE_CASES`` case (near-ties kept
    1e-4 apart, as ``_router_logits``).  ``ties`` adds, beside that
    function's rows of exact ties, a run of 8 equal rows of group 0
    around slot gs / 2 — a block boundary for every block size that
    divides it: each row picks experts 0..k-1, so those experts' queues
    run on across the boundary."""
    G, gs, k, E, _ = ROUTE_CASES[case]
    x = _router_logits((G, gs, E), k, seed, ties=ties)
    if ties:
        x[0, max(0, gs // 2 - 4):gs // 2 + 4] = 0.25
    return x


def _ragged_inputs(seed, *, qlens, KV, G, hd, bs=4, P=6, quant=False,
                   window=None, q_start=None, W=None):
    """A flat-packed batch over a random page pool, as numpy arrays (each
    row's first position drawn, or ``q_start``), ``W`` flat slots (by
    default the power of two from 8 that holds the live tokens)."""
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
    if W is None:
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
                  quant=False, window=None, masked=(), q_start=None):
    """A padded [B, C] batch: row b's q_len[b] live slots start at a
    random position that keeps them inside the row's pages (or at
    ``q_start``)."""
    rng = np.random.default_rng(seed)
    B = len(qlens)
    C = C or max(max(qlens), 1)
    N = B * P + 1
    kp, vp, ks, vs = _pool(rng, N, bs, KV, hd, quant)
    pt = rng.permutation(np.arange(1, N))[:B * P].reshape(B, P).astype(
        np.int32)
    pt[list(masked)] = 0
    draws = rng.integers(0, P * bs - C + 1, B).astype(np.int32)
    q_start = draws if q_start is None else np.asarray(q_start, np.int32)
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
VERIFY_QLENS = [5, 1, 3, 5, 2, 4, 5, 1]
VERIFY_POS = [590, 595, 600, 605, 610, 615, 620, 625]


def _shard_heads(name, m):
    """(KV, G, hd) of one of ``m`` model shards of config ``name``, by
    the KV-head rule the serving engine places them with."""
    c = shard_config(get_config(name, ""), m)
    return c.num_kv_heads, c.num_heads // c.num_kv_heads, c.head_dim


# one model shard's heads under tensor parallelism: gemma3-1b on 2
# shards (its one KV head, G 2, window 512), phi4-mini-3.8b on 2 (KV 4,
# G 3), moonshot-v1-16b-a3b on 2 (KV 8, G 1), kimi-k2-1t-a32b on 8 (KV
# 1, G 8, hd 112)
GEMMA_M2 = _shard_heads("gemma3-1b", 2)
PHI4_M2 = _shard_heads("phi4-mini-3.8b", 2)
MOONSHOT_M2 = _shard_heads("moonshot-v1-16b-a3b", 2)
KIMI_M8 = _shard_heads("kimi-k2-1t-a32b", 8)
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
    # speculative verify windows: 8 rows of q_len 1-5 (a decode token and
    # up to 4 drafts) at positions 590-625, phi4's KV 8 x G 3 (15 rows of
    # 5 tokens: the decode layout) and gemma3's KV 1 x G 4 with its
    # window (20 rows: the prefill layout) in one launch each
    "verify-phi4": (VERIFY_QLENS, VERIFY_POS, 8, 3, 128, "f32", None, 1.0),
    "verify-gemma3-window512": (VERIFY_QLENS, VERIFY_POS, 1, 4, 256, "f32",
                                512, 1.0),
    # the attention layers of the rest of the registry: starcoder2 (KV 4,
    # G 9: 7 tokens an item, 63 live rows of 64), qwen2-vl (KV 8, G 8),
    # musicgen (KV 32, G 1, hd 64), moonshot (KV 16, G 1) and kimi (KV 8,
    # G 8, hd 112: 14 column n-tiles, 7 chunks of 16 bytes an int8 row)
    "starcoder2-G9": (TILE_QLENS, TILE_LATE, 4, 9, 128, "f32", None, 1.0),
    "qwen2vl-G8": (TILE_QLENS, None, 8, 8, 128, "f32", None, 1.0),
    "musicgen-hd64-G1": (TILE_QLENS, None, 32, 1, 64, "f32", None, 1.0),
    "moonshot-G1": (TILE_QLENS, TILE_LATE, 16, 1, 128, "f32", None, 1.0),
    "kimi-hd112": (TILE_QLENS, None, 8, 8, 112, "f32", None, 1.0),
    "kimi-hd112-x4-late": (TILE_QLENS, TILE_LATE, 8, 8, 112, "f32", None,
                           4.0),
    "kimi-hd112-bf16": (TILE_QLENS, TILE_LATE, 8, 8, 112, "bf16", None,
                        1.0),
    "kimi-hd112-int8-scales": (TILE_QLENS, TILE_LATE, 8, 8, 112,
                               "int8+scales", None, 1.0),
    "kimi-hd112-verify": (VERIFY_QLENS, VERIFY_POS, 8, 8, 112, "f32", None,
                          1.0),
    # one model shard's heads (GEMMA_M2 and the rest)
    "m2-gemma3-G2-window512-late": (TILE_QLENS, TILE_LATE, *GEMMA_M2, "f32",
                                    512, 1.0),
    "m2-phi4-KV4-G3": (TILE_QLENS, TILE_LATE, *PHI4_M2, "f32", None, 1.0),
    "m2-moonshot-KV8-G1": (TILE_QLENS, TILE_LATE, *MOONSHOT_M2, "f32", None,
                           1.0),
    "m8-kimi-KV1-G8-hd112": (TILE_QLENS, TILE_LATE, *KIMI_M8, "f32", None,
                             1.0),
}
# flat widths off the powers of two, as ``--flat-buckets 16 48 160 512``
# gives them: (W, q_len per row, q_start, KV, G, hd, window) — rows partly
# filled, late in their pages, for phi4-mini-3.8b (KV 8, G 3) and gemma3-1b
# (KV 1, G 4, its 512 window)
FLAT_QLENS = {48: [5, 1, 0, 12, 3, 1, 7, 2], 160: [64, 20, 1, 0, 33, 1, 9, 2]}
FLAT_POS = {48: [580, 600, 0, 560, 620, 625, 540, 610],
            160: [560, 600, 625, 0, 520, 610, 580, 590]}
FLAT_WIDTH_CASES = {
    f"{name}-W{W}": (W, FLAT_QLENS[W], FLAT_POS[W], KV, G, hd, window)
    for W in (48, 160)
    for name, KV, G, hd, window in (("phi4", 8, 3, 128, None),
                                    ("gemma3-window512", 1, 4, 256, 512))}
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
    # the rest of the registry's layers, as RAGGED_TILE_CASES
    "starcoder2-G9-masked": (9, 4, 9, 128, "f32", None, (8,), 1.0),
    "qwen2vl-G8": (8, 8, 8, 128, "f32", None, (), 1.0),
    "musicgen-hd64-G1": (8, 32, 1, 64, "f32", None, (), 1.0),
    "moonshot-G1-masked": (9, 16, 1, 128, "f32", None, (8,), 1.0),
    "kimi-hd112-masked": (9, 8, 8, 112, "f32", None, (8,), 1.0),
    "kimi-hd112-x4": (8, 8, 8, 112, "f32", None, (), 4.0),
    "kimi-hd112-bf16": (8, 8, 8, 112, "bf16", None, (), 1.0),
    "kimi-hd112-int8-scales-masked": (9, 8, 8, 112, "int8+scales", None,
                                      (8,), 1.0),
    # one model shard's heads, as RAGGED_TILE_CASES
    "m2-gemma3-G2-window512-masked": (9, *GEMMA_M2, "f32", 512, (8,), 1.0),
    "m2-phi4-KV4-G3": (8, *PHI4_M2, "f32", None, (), 1.0),
    "m2-moonshot-KV8-G1-masked": (9, *MOONSHOT_M2, "f32", None, (8,), 1.0),
    "m8-kimi-KV1-G8-hd112": (8, *KIMI_M8, "f32", None, (), 1.0),
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


# The mixed kernel on the tile body, on the card only (MIXED_CASES also
# feeds the CPU parity tests): the served widths with their G (granite
# 64 and phi4 128 at G 3, jamba 128 and gemma3 256 at G 4) at the served
# page shape, bs 16 and P 41, under TILE_SPLITS and TILE_TOLS.  C = 64
# with q_len 64, 43, 0, 21, 63, 1, 37 and 64 side by side: dead slots
# inside rows, and at G 3 (21-slot tiles) a 64- or 43-token row's last
# tile holds 1 token and takes the body's decode layout; C = 1, a decode
# batch with idle rows; an all-idle bucket; q and k scaled x4; int8 pools
# with scales; bf16; gemma3's window of 512 at positions past 512.
# (q_len per row, C, q_start or None, KV, G, hd, kind, window, qk_scale).
MIXED_QLENS = [64, 43, 0, 21, 63, 1, 37, 64]
MIXED_LATE = [580, 590, 0, 530, 590, 640, 560, 585]
MIXED_DECODE = [1, 1, 0, 1, 1, 1, 0, 1]
MIXED_TILE_CASES = {
    "hd64-G3-C64": (MIXED_QLENS, 64, None, 2, 3, 64, "f32", None, 1.0),
    "hd128-G3-C64": (MIXED_QLENS, 64, None, 2, 3, 128, "f32", None, 1.0),
    "hd128-G4-C64": (MIXED_QLENS, 64, None, 2, 4, 128, "f32", None, 1.0),
    "hd256-G4-C64": (MIXED_QLENS, 64, None, 1, 4, 256, "f32", None, 1.0),
    "hd256-G4-window512-late": (MIXED_QLENS, 64, MIXED_LATE, 1, 4, 256,
                                "f32", 512, 1.0),
    "hd128-G3-C1": (MIXED_DECODE, 1, TILE_POS[:8], 2, 3, 128, "f32", None,
                    1.0),
    "hd256-G4-C1-window512": (MIXED_DECODE, 1, TILE_POS[:8], 1, 4, 256,
                              "f32", 512, 1.0),
    "all-idle-C64": ([0] * 8, 64, None, 2, 3, 128, "f32", None, 1.0),
    "hd128-G3-x4": (MIXED_QLENS, 64, None, 2, 3, 128, "f32", None, 4.0),
    "hd256-G4-x4-window512-late": (MIXED_QLENS, 64, MIXED_LATE, 1, 4, 256,
                                   "f32", 512, 4.0),
    "hd128-G3-int8-scales-late": (MIXED_QLENS, 64, MIXED_LATE, 2, 3, 128,
                                  "int8+scales", None, 1.0),
    "hd64-G3-bf16": (MIXED_QLENS, 64, None, 2, 3, 64, "bf16", None, 1.0),
    "hd256-G4-bf16-window512-late": (MIXED_QLENS, 64, MIXED_LATE, 1, 4,
                                     256, "bf16", 512, 1.0),
    # the rest of the registry's layers, as RAGGED_TILE_CASES
    "starcoder2-G9-C64": (MIXED_QLENS, 64, MIXED_LATE, 4, 9, 128, "f32",
                          None, 1.0),
    "qwen2vl-G8-C64": (MIXED_QLENS, 64, None, 8, 8, 128, "f32", None, 1.0),
    "musicgen-hd64-G1-C64": (MIXED_QLENS, 64, None, 32, 1, 64, "f32", None,
                             1.0),
    "moonshot-G1-C64": (MIXED_QLENS, 64, MIXED_LATE, 16, 1, 128, "f32",
                        None, 1.0),
    "kimi-hd112-C64": (MIXED_QLENS, 64, None, 8, 8, 112, "f32", None, 1.0),
    "kimi-hd112-C1": (MIXED_DECODE, 1, TILE_POS[:8], 8, 8, 112, "f32", None,
                      1.0),
    "kimi-hd112-x4-late": (MIXED_QLENS, 64, MIXED_LATE, 8, 8, 112, "f32",
                           None, 4.0),
    "kimi-hd112-bf16": (MIXED_QLENS, 64, MIXED_LATE, 8, 8, 112, "bf16",
                        None, 1.0),
    "kimi-hd112-int8-scales": (MIXED_QLENS, 64, MIXED_LATE, 8, 8, 112,
                               "int8+scales", None, 1.0),
    # one model shard's heads, as RAGGED_TILE_CASES
    "m2-gemma3-G2-C64-window512-late": (MIXED_QLENS, 64, MIXED_LATE,
                                        *GEMMA_M2, "f32", 512, 1.0),
    "m2-phi4-KV4-G3-C64": (MIXED_QLENS, 64, MIXED_LATE, *PHI4_M2, "f32",
                           None, 1.0),
    "m2-moonshot-KV8-G1-C1": (MIXED_DECODE, 1, TILE_POS[:8], *MOONSHOT_M2,
                              "f32", None, 1.0),
    "m8-kimi-KV1-G8-hd112-C64": (MIXED_QLENS, 64, MIXED_LATE, *KIMI_M8,
                                 "f32", None, 1.0),
}


def _mixed_tile_inputs(case):
    """numpy (q, kp, vp, pt, q_start, q_len) and kwargs of a
    MIXED_TILE_CASES case, q and k scaled."""
    qlens, C, q_start, KV, G, hd, kind, window, qk = MIXED_TILE_CASES[case]
    args, kw = _mixed_inputs(len(case), qlens=qlens, KV=KV, G=G, hd=hd, C=C,
                             bs=16, P=41, quant=kind == "int8+scales",
                             window=window, q_start=q_start)
    if qk != 1.0:
        args = (args[0] * np.float32(qk), args[1] * np.float32(qk)) + args[2:]
    return args, kw


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
    # kimi's head width 112 (G 8; 14 column n-tiles of O, grouped by 2),
    # and qwen2-vl's 1152-token prompt (1024 patches + 128 text), one row
    "f32-d112-x4": (1, 16, 2, 130, 130, 112, True, None, 4.0, "f32"),
    "edge-97-window-d112": (2, 8, 1, 97, 97, 112, True, 40, 1.0, "f32"),
    "bf16-d112": (1, 16, 2, 97, 97, 112, True, None, 1.0, "bf16"),
    "qwen2vl-1152-d128": (1, 16, 2, 1152, 1152, 128, True, None, 1.0,
                          "f32"),
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


# (B, H, T, hd): rwkv6-3b-smoke's heads (hd 32) over T off the kernel's
# 16-step chunk and the TPU kernel's 128-step one, two batch rows, hd 64
# (rwkv6-3b) and 128, a single step, T = 0 (a zero state and an empty y),
# T = 77 at hd 128 (4 blocks a head) and one head of hd 64 (B·H = 1)
RWKV_CASES = {
    "smoke-T130": (1, 2, 130, 32),
    "two-rows": (2, 3, 33, 32),
    "hd64": (1, 2, 70, 64),
    "hd128": (1, 1, 40, 128),
    "one-step": (1, 2, 1, 32),
    "empty-T0": (2, 3, 0, 64),
    "hd128-T77": (2, 2, 77, 128),
    "one-head-hd64": (1, 1, 100, 64),
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
# chunk, d past its 512-channel tile and off it), T off the earlier
# kernel's 64-step chunk and 8-step register group, a ragged last channel
# group, n 8 (smoke) and 16 (published), a single step and T = 0; then
# T around the kernel's 32-step staged chunk (kTC - 1, kTC + 1 and
# 3 kTC + 5) and d off its 64-channel block, 4-aligned (100) and not
# (70: x and dt copied 4 bytes at a time)
MAMBA_CASES = {
    "smoke-n8": (1, 64, 32, 8),
    "two-rows-T150": (2, 150, 96, 16),
    "d600": (1, 130, 600, 16),
    "ragged-T70": (2, 70, 200, 8),
    "one-step": (1, 1, 40, 8),
    "empty": (2, 0, 24, 16),
    "chunk-less-one-T31": (2, 31, 64, 16),
    "chunk-plus-one-T33": (1, 33, 128, 8),
    "three-chunks-T101-d100": (2, 101, 100, 16),
    "d70-unaligned-rows": (1, 40, 70, 8),
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
                                       ((512, 262144), False),
                                       ((64, 200064), False),
                                       ((8, 49152), False),
                                       ((8, 2048), False),
                                       ((8, 152064), False),
                                       ((8, 163840), False),
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


def _assert_gate_close(got, x64):
    """The gate's outputs against the plain version of the same values
    in f64 on the CPU, rounded to f32: conf and logz within rtol 1e-5,
    entropy within atol 1e-4, argmax exact."""
    want = ref.confidence_gate_ref(x64)
    for k in ("conf", "logz"):
        torch.testing.assert_close(got[k].cpu(), want[k].float(), rtol=1e-5,
                                   atol=0)
    torch.testing.assert_close(got["entropy"].cpu(), want["entropy"].float(),
                               atol=1e-4, rtol=0)
    assert torch.equal(got["argmax"].cpu(), want["argmax"])


def _gate_slices(x):
    """The kernel's [lo, hi) slices of each row of x [R, V] on the card."""
    R, V = x.shape
    splits, chunk = gate_mod.plan_gate_splits(
        R, V, x.element_size(), kernels.sm_count(x.device.index))
    return [gate_mod.gate_slices(
        V, (-(x[r].data_ptr() % 16) % 16) // x.element_size(), splits,
        chunk) for r in range(R)]


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
def test_cuda_confidence_gate_unaligned_rows(offset, cuda_device):
    """granite's [8, 49155] rows each start at another offset from the
    16-byte grid (49155 * 4 bytes = 12 mod 16); ``offset`` 1 moves row 0
    off the grid too.  Every row is split, with a scalar head."""
    x = torch.from_numpy(_logits((8, 49155), seed=11))
    buf = torch.empty(x.numel() + offset, device=cuda_device)
    xd = buf[offset:].view(8, 49155)
    xd.copy_(x.to(cuda_device))
    heads = {(-(xd[r].data_ptr() % 16) % 16) // 4 for r in range(8)}
    assert len(heads) == 4 and len(_gate_slices(xd)[0]) > 1
    _assert_gate_close(gate_mod.confidence_gate(xd), x.double())


@pytest.mark.cuda
def test_cuda_confidence_gate_bf16(cuda_device):
    """bf16 logits [8, 65536] (rwkv6-3b's and jamba's vocab), 8 values a
    16-byte load.  The kernel reads the exact bf16 values and sums in
    f32, so it is held to the f32 tolerances against the f64 plain
    version of the same bf16 values."""
    x = torch.from_numpy(_logits((8, 65536), seed=12)).to(torch.bfloat16)
    got = gate_mod.confidence_gate(x.to(cuda_device))
    _assert_gate_close(got, x.double())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_confidence_gate_ties_across_split_boundaries(dtype,
                                                           cuda_device):
    """An exact tie for the maximum on the two sides of a split boundary
    (row r: the last element of split r and the first of split r + 1),
    and one tie between the first and the last split: the lower index
    wins, whichever block finishes last."""
    x = torch.from_numpy(_logits((8, 65536), seed=13)).to(dtype)
    xd = x.to(cuda_device)
    slices = _gate_slices(xd)
    assert len(slices[0]) >= 9
    want = []
    for r in range(7):
        hi = slices[r][r][1]
        xd[r, hi - 1] = xd[r, hi] = 60.0
        want.append(hi - 1)
    first, last = slices[7][0][0], slices[7][-1][1] - 1
    xd[7, last] = xd[7, first] = 60.0
    want.append(first)
    got = gate_mod.confidence_gate(xd)
    assert got["argmax"].cpu().tolist() == want
    _assert_gate_close(got, xd.cpu().double())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(5, 4095), (2, 7), (4, 1), (1, 8191)])
def test_cuda_confidence_gate_below_one_split(shape, cuda_device):
    """V below two splits' worth runs one block a row, which writes the
    outputs itself (V = 7 and 1: no 16-byte body at all)."""
    x = torch.from_numpy(_logits(shape, seed=shape[-1]))
    xd = x.to(cuda_device)
    assert all(len(s) == 1 for s in _gate_slices(xd))
    _assert_gate_close(gate_mod.confidence_gate(xd), x.double())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 262144), (1, 1 << 20)])
def test_cuda_confidence_gate_is_bit_identical_call_to_call(shape,
                                                            cuda_device):
    """Two calls on the same logits give the same bits: the splits'
    partials merge in a fixed order, not in the order blocks finish.  On
    the H100's 132 SMs, [8, 262144] takes 64 splits a row (two a lane of
    the merging warp), and one row of 2^20 the most a row can have
    (256)."""
    x = torch.from_numpy(_logits(shape, seed=14)).to(cuda_device)
    sms = kernels.sm_count(x.device.index)
    assert len(_gate_slices(x)[0]) == min(
        gate_mod.BLOCKS_PER_SM * sms // shape[0], gate_mod.GATE_THREADS,
        shape[1] // gate_mod.MIN_SPLIT)
    first = gate_mod.confidence_gate(x)
    for _ in range(3):
        again = gate_mod.confidence_gate(x)
        for k in first:
            assert torch.equal(first[k], again[k]), k
    _assert_gate_close(first, x.cpu().double())


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
@pytest.mark.parametrize("case", sorted(FLAT_WIDTH_CASES))
def test_cuda_ragged_attention_flat_widths(case, splits, cuda_device):
    """The ragged kernel at flat widths 48 and 160 (``--flat-buckets``),
    whose grids no power-of-two bucket gives: f32 within atol = rtol =
    1e-4 of the plain version, slots past sum(q_len) exactly zero."""
    W, qlens, q_start, KV, G, hd, window = FLAT_WIDTH_CASES[case]
    args, kw = _ragged_inputs(len(case), qlens=qlens, KV=KV, G=G, hd=hd,
                              bs=16, P=41, window=window, q_start=q_start,
                              W=W)
    dargs, dkw, fargs, tkw = _tile_on(cuda_device, args, kw, "f32")
    got = ragged_mod.ragged_attention(*dargs, **dkw, splits=splits).cpu()
    want = ref.ragged_attention_ref(*fargs, **tkw)
    assert got.shape[0] == W
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    total = sum(qlens)
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
@pytest.mark.parametrize("KV,G,hd,window", [(8, 3, 128, None),
                                            (1, 4, 256, 512)])
def test_cuda_paged_attention_masked_rows_leave_live_rows(KV, G, hd, window,
                                                          cuda_device):
    """The speculative draft loop's decode step: rows past their draft
    budget decode through an all-null page-table row at position 0 (the
    null block 0 holds data).  The live rows' outputs are bit-identical
    to a launch with no row masked, and within 1e-4 of the plain
    version; the masked rows' outputs are finite."""
    args, kw = _paged_inputs(hd + KV, B=8, KV=KV, G=G, hd=hd, bs=16, P=41,
                             window=window, pos=VERIFY_POS)
    targs, tkw = _torch(args, kw)
    q, kp, vp, pt, pos = (a.to(cuda_device) for a in targs)
    masked = [1, 4, 6]
    mpt, mpos = pt.clone(), pos.clone()
    mpt[masked] = 0
    mpos[masked] = 0
    live = [b for b in range(8) if b not in masked]
    full = paged_mod.paged_attention(q, kp, vp, pt, pos, window=window)
    got = paged_mod.paged_attention(q, kp, vp, mpt, mpos, window=window)
    assert torch.equal(got[live], full[live])
    assert bool(torch.isfinite(got).all())
    want = ref.paged_attention_ref(*targs, **tkw)
    torch.testing.assert_close(got[live].cpu(), want[live], atol=1e-4,
                               rtol=1e-4)


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
@pytest.mark.parametrize("splits", TILE_SPLITS)
@pytest.mark.parametrize("case", sorted(MIXED_TILE_CASES))
def test_cuda_mixed_attention_tile_cases(case, splits, cuda_device):
    """The mixed kernel on the tile body at the served widths and page
    shape, under the launcher's split plan, one split and many: live
    slots within the kind's tolerance of the plain version (as the ragged
    tile cases), every dead slot (i >= q_len[b]) exactly zero."""
    kind = MIXED_TILE_CASES[case][6]
    dargs, dkw, fargs, tkw = _tile_on(cuda_device, *_mixed_tile_inputs(case),
                                      kind)
    got = mixed_mod.mixed_attention(*dargs, **dkw, splits=splits).cpu()
    want = ref.mixed_attention_ref(*fargs, **tkw)
    assert got.dtype == dargs[0].dtype and got.shape == dargs[0].shape
    live = torch.arange(got.shape[1])[None, :] < fargs[5].long()[:, None]
    atol, rtol = TILE_TOLS[kind]
    torch.testing.assert_close(got[live].float(), want[live], atol=atol,
                               rtol=rtol)
    assert torch.equal(got[~live], torch.zeros_like(got[~live]))


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


def _check_route(got, want):
    """moe_route against its plain version: idx, dest and keep exact,
    gates and weights within rtol 1e-5 (atol 0)."""
    gates, idx, dest, weight = (t.cpu() for t in got)
    want_g, want_i, want_d, want_w = want
    assert gates.dtype == weight.dtype == torch.float32
    assert idx.dtype == torch.int32 and dest.dtype == torch.int64
    assert gates.shape == idx.shape == dest.shape == weight.shape \
        == want_g.shape
    assert torch.equal(idx, want_i)
    assert torch.equal(dest, want_d)
    assert torch.equal(weight == 0, want_w == 0)
    torch.testing.assert_close(gates, want_g, rtol=1e-5, atol=0)
    torch.testing.assert_close(weight, want_w, rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("case,ties,dtype", [
    (c, False, torch.float32) for c in sorted(ROUTE_CASES)] + [
    ("granite-bucket", True, torch.float32),
    ("granite-decode", True, torch.float32),
    ("jamba-prefill", True, torch.float32),
    ("E1024", True, torch.float32),
    ("granite-bucket", False, torch.bfloat16),
    ("jamba-prefill", False, torch.bfloat16),
    ("cf0.5", True, torch.float16)])
def test_cuda_moe_route_matches_plain(case, ties, dtype, cuda_device):
    """The fused routing and queue ranks at the main path's shapes,
    E = 1024, G > 1, rows of exact ties and bf16/f16 logits (the plain
    version on the same rounded values)."""
    G, gs, k, E, cf = ROUTE_CASES[case]
    cap = _route_cap(gs, k, E, cf)
    x = torch.from_numpy(_route_logits(case, seed=len(case),
                                       ties=ties)).to(dtype)
    got = router_mod.moe_route(x.to(cuda_device), k, cap)
    _check_route(got, router_mod.moe_route_ref(x, k, cap))


@pytest.mark.cuda
@pytest.mark.parametrize("rows_per_block", [1, 5, 32])
@pytest.mark.parametrize("case", ["granite-bucket", "jamba-prefill",
                                  "E1024"])
def test_cuda_moe_route_block_sizes(case, rows_per_block, cuda_device):
    """Other cuts of a group: 1 row a block (granite's 512 blocks a
    group keep their offsets in the workspace, past the last block's
    shared table), 5 (a ragged last block) and 32 (the most)."""
    G, gs, k, E, cf = ROUTE_CASES[case]
    cap = _route_cap(gs, k, E, cf)
    x = torch.from_numpy(_route_logits(case, seed=3, ties=True))
    got = router_mod.moe_route(x.to(cuda_device), k, cap,
                               rows_per_block=rows_per_block)
    _check_route(got, router_mod.moe_route_ref(x, k, cap))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["granite-bucket", "jamba-prefill"])
def test_cuda_moe_route_is_bit_identical_across_calls(case, cuda_device):
    """Four calls on the same logits give the same bits: every output
    (the per-group counters are left zero by each call)."""
    G, gs, k, E, cf = ROUTE_CASES[case]
    cap = _route_cap(gs, k, E, cf)
    x = torch.from_numpy(_route_logits(case, seed=11, ties=True)).to(
        cuda_device)
    first = router_mod.moe_route(x, k, cap)
    for _ in range(3):
        again = router_mod.moe_route(x, k, cap)
        for a, b in zip(first, again):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_moe_route_refuses_bad_arguments(cuda_device):
    """E > 1024, k > E, cap < 1 and a block of more than 32 rows are
    refused by the launcher and, below it, by the C entry point."""
    x = torch.zeros(1, 8, 40, device=cuda_device)
    with pytest.raises(ValueError, match="experts"):
        router_mod.moe_route(torch.zeros(1, 4, 1025, device=cuda_device),
                             8, 4)
    with pytest.raises(ValueError, match="k=41"):
        router_mod.moe_route(x, 41, 4)
    with pytest.raises(ValueError, match="cap=0"):
        router_mod.moe_route(x, 8, 0)
    with pytest.raises(ValueError, match="rows_per_block"):
        router_mod.moe_route(x, 8, 4, rows_per_block=33)
    with pytest.raises(ValueError, match="G, gs, E"):
        router_mod.moe_route(torch.zeros(8, 40, device=cuda_device), 8, 4)
    out = [torch.empty(8 * 41, device=cuda_device) for _ in range(4)]
    fn = router_mod._entry("moe_route")
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    p = kernels.ptr
    for G, gs, E, k, cap, rows in ((1, 8, 1025, 8, 4, 8),
                                   (1, 8, 40, 41, 4, 8),
                                   (1, 8, 40, 8, 0, 8),
                                   (1, 8, 40, 8, 4, 33)):
        err = fn(p(x), G, gs, E, k, cap, rows, 0, *(p(t) for t in out),
                 None, None, stream)
        assert err != 0, (G, gs, E, k, cap, rows)


@pytest.mark.cuda
@pytest.mark.parametrize("rows_per_block", [8, 32])
def test_cuda_moe_route_leaves_the_group_counters_zero(rows_per_block,
                                                       cuda_device):
    """A launch of several blocks a group leaves its counters at zero
    (each wraps back at the group's block count)."""
    G, gs, k, E, cf = ROUTE_CASES["jamba-prefill"]
    x = torch.from_numpy(_route_logits("jamba-prefill", seed=5)).to(
        cuda_device)
    router_mod.moe_route(x, k, _route_cap(gs, k, E, cf),
                         rows_per_block=rows_per_block)
    torch.cuda.synchronize()
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    cnt = kernels.zeroed_counters(x.device, stream, G)
    assert not cnt.any()


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


# (B, H, KV, S, d, window): one data shard's uniform prefill on a 2x1
# tier of 8 slots, 4 rows of 640 tokens: phi4-mini-3.8b, and gemma3-1b's
# sliding (window 512) and global layers
DATA_SHARD_PREFILL = {
    "phi4-4x640": (4, 24, 8, 640, 128, None),
    "gemma3-4x640-window512": (4, 4, 1, 640, 256, 512),
    "gemma3-4x640-global": (4, 4, 1, 640, 256, None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(DATA_SHARD_PREFILL))
def test_cuda_flash_attention_data_shard_prefill(case, cuda_device):
    """A data shard's prefill batch against the plain version, within
    atol = rtol = 1e-4."""
    B, H, KV, S, d, window = DATA_SHARD_PREFILL[case]
    q, k, v = (torch.from_numpy(a)
               for a in _flash_inputs(len(case), B, H, KV, S, S, d))
    got = flash_mod.flash_attention(q.to(cuda_device), k.to(cuda_device),
                                    v.to(cuda_device), causal=True,
                                    window=window)
    want = ref.flash_attention_ref(q, k, v, causal=True, window=window)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)


def _model_shard_prefill(name, m, S, window=None):
    """(B, H, KV, S, d, window) of one of ``m`` model shards' uniform
    prefill of 8 rows of ``S`` tokens of config ``name``."""
    KV, G, hd = _shard_heads(name, m)
    return (8, KV * G, KV, S, hd, window)


# one model shard's uniform prefill at phase 12's 1x2 meshes (8 rows):
# phi4-mini-3.8b's 12 query heads over 4 KV heads, gemma3-1b's 2 over its
# one KV head (window 512 and global), qwen2-vl-72b's 32 over 4 at 1152
# tokens
MODEL_SHARD_PREFILL = {
    "phi4-m2": _model_shard_prefill("phi4-mini-3.8b", 2, 640),
    "gemma3-m2-window512": _model_shard_prefill("gemma3-1b", 2, 640, 512),
    "gemma3-m2-global": _model_shard_prefill("gemma3-1b", 2, 640),
    "qwen2vl-m2": _model_shard_prefill("qwen2-vl-72b", 2, 1152),
}


def _inner_width(name, m):
    """One of ``m`` model shards' ``d_inner`` channels of config
    ``name``'s recurrent layers (``sharding.inner_range``)."""
    from repro_torch.models import sharding
    cfg = get_config(name, "")
    mixer = next(l.mixer for l in cfg.layers
                 if l.mixer.kind in ("rwkv6", "mamba"))
    return sharding.inner_range(cfg, mixer, 0, m)[1]


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(MODEL_SHARD_PREFILL))
def test_cuda_flash_attention_model_shard_prefill(case, cuda_device):
    """A model shard's uniform prefill, at its query and KV heads,
    against the plain version (on the card: qwen2-vl's 1152 tokens
    would take the CPU long), within atol = rtol = 1e-4."""
    B, H, KV, S, d, window = MODEL_SHARD_PREFILL[case]
    q, k, v = (torch.from_numpy(a).to(cuda_device)
               for a in _flash_inputs(len(case), B, H, KV, S, S, d))
    got = flash_mod.flash_attention(q, k, v, causal=True, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=True, window=window)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_cuda_rwkv6_scan_model_shard(cuda_device):
    """rwkv6-3b's scan at one of two model shards' heads, r/k/v/w [8, 20,
    640, 64], against the plain version on the card: y and the final
    state within atol = rtol = 1e-4."""
    H = _inner_width("rwkv6-3b", 2) // 64
    assert H == 20
    args = [torch.from_numpy(a).to(cuda_device)
            for a in _rwkv_inputs(20, 8, H, 640, 64)]
    y, s_T = rwkv_mod.rwkv6_scan(*args)
    want_y, want_s = ref.rwkv6_scan_ref(*args)
    torch.testing.assert_close(y, want_y, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(s_T, want_s, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_cuda_mamba_scan_model_shard(cuda_device):
    """jamba-v0.1-52b's scan at one of two model shards' channels, x [8,
    640, 4096], n 16, against the plain version on the card: y and the
    final state within atol = rtol = 1e-4."""
    d = _inner_width("jamba-v0.1-52b", 2)
    assert d == 4096
    args = [torch.from_numpy(a).to(cuda_device)
            for a in _mamba_inputs(21, 8, 640, d, 16)]
    y, h_T = mamba_mod.mamba_scan(*args)
    want_y, want_h = ref.mamba_scan_ref(*args)
    torch.testing.assert_close(y, want_y, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(h_T, want_h, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_cuda_moe_route_over_data_shards(cuda_device):
    """granite's published route (40 experts, top-8, capacity factor
    1.25) over a ragged launch of two data shards holding 200 and 240
    live tokens, each packed at width 256, gathered into the tier's
    bucket of 512 by ``transformer.route_data_shards``: each shard's
    ``dest`` bit-equal to the unsharded route's over the gathered logits
    (and the plain version's), its padding on the spare row at weight 0,
    its weights within 1.2e-7."""
    from repro_torch.models import transformer
    spec = next(l.ffn for l in get_config("granite-moe-3b-a800m", "").layers
                if l.ffn.kind == "moe")
    E, k, total, live = spec.num_experts, spec.top_k, 512, (200, 240)
    x = torch.from_numpy(_router_logits((sum(live), E), k, seed=31))
    logits, slots, o = [], [], 0
    for n in live:
        lg = torch.zeros(256, E)
        lg[:n] = x[o:o + n]
        logits.append(lg.to(cuda_device))
        slots.append(np.concatenate([o + np.arange(n), [total] * (256 - n)]))
        o += n
    full = torch.zeros(1, total, E)
    full[0, :o] = x
    cap = _route_cap(total, k, E, spec.capacity_factor)
    got = transformer.route_data_shards(
        spec, logits, transformer.MoeLayout(slots, total))
    _, _, dest, w = (t.cpu() for t in router_mod.moe_route(
        full.to(cuda_device), k, cap))
    _, _, ref_d, ref_w = router_mod.moe_route_ref(full, k, cap)
    assert torch.equal(dest, ref_d)
    o = 0
    for (d, ww, rows), n in zip(got, live):
        d, ww = d.cpu(), ww.cpu()
        assert rows == cap and d.shape == ww.shape == (256, k)
        assert torch.equal(d[:n], dest[0, o:o + n])
        assert bool((d[n:] == E * cap).all()) and not ww[n:].any()
        torch.testing.assert_close(ww[:n], w[0, o:o + n], atol=1.2e-7,
                                   rtol=0)
        torch.testing.assert_close(ww[:n], ref_w[0, o:o + n], atol=1.2e-7,
                                   rtol=0)
        o += n


@pytest.mark.cuda
def test_cuda_moe_train_route_matches_plain(cuda_device):
    """The route a sharded train step takes over granite's global batch
    of 4 x 256 tokens (``blocks.moe_train_route`` on the gathered [1,
    1024, 40] logits, one ``moe_route`` launch) and each of two data
    shards' picks of it (``transformer._local_dest``), on the card
    against the same on the CPU (the plain version): ``dest`` exact,
    the differentiable weights within 1.2e-7, the aux losses within rtol
    1e-6, the logits' gradient of a weighted sum of the weights within
    atol 1e-6."""
    from repro_torch.kernels import ops
    from repro_torch.models import blocks, transformer
    spec = next(l.ffn for l in get_config("granite-moe-3b-a800m", "").layers
                if l.ffn.kind == "moe")
    G, gs, k, E, cf = ROUTE_CASES["granite-train"]
    assert (k, E, cf) == (spec.top_k, spec.num_experts,
                          spec.capacity_factor)
    x = torch.from_numpy(_route_logits("granite-train", seed=41))
    cot = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (G, gs, k)).astype(np.float32))
    outs = []
    for dev in (cuda_device, torch.device("cpu")):
        lg = x.to(dev).requires_grad_(True)
        before = ops.router_gate.launches
        dest, w, rows, aux = blocks.moe_train_route(spec, lg)
        launched = ops.router_gate.launches - before
        (g,) = torch.autograd.grad((w * cot.to(dev)).sum(), lg)
        local = [transformer._local_dest(dest.reshape(-1, k)[s * 512:
                                                             (s + 1) * 512],
                                         0, 1, rows, rows, E)
                 for s in range(2)]
        outs.append((dest.cpu(), w.detach().cpu(), rows,
                     {n: float(v) for n, v in aux.items()}, g.cpu(),
                     [(d.cpu(), own) for d, own in local], launched))
    (dest, w, rows, aux, g, local, n), (ref_d, ref_w, ref_rows, ref_aux,
                                        ref_g, ref_local, _) = outs
    assert n == 1 and rows == ref_rows == _route_cap(gs, k, E, cf)
    assert torch.equal(dest, ref_d)
    torch.testing.assert_close(w, ref_w, atol=1.2e-7, rtol=0)
    for name in aux:
        assert abs(aux[name] - ref_aux[name]) <= 1e-6 * abs(ref_aux[name])
    torch.testing.assert_close(g, ref_g, atol=1e-6, rtol=0)
    for (d, own), (rd, rown) in zip(local, ref_local):
        assert own == rown == rows and torch.equal(d, rd)


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
def test_cuda_rwkv6_scan_refuses_unaligned_views(cuda_device):
    """An input whose storage starts one element off the 16-byte
    alignment the kernel's cp.async copies need is refused, not
    copied."""
    r, k, v, w, u = (torch.from_numpy(a).to(cuda_device)
                     for a in _rwkv_inputs(5, 1, 2, 9, 32))
    buf = torch.empty(r.numel() + 1, device=cuda_device)
    shifted = buf[1:].view(r.shape)
    shifted.copy_(r)
    with pytest.raises(ValueError, match="16-byte"):
        rwkv_mod.rwkv6_scan(shifted, k, v, w, u)


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
def test_cuda_mamba_scan_refuses_unaligned_views(cuda_device):
    """An input whose storage starts one element off the 16-byte
    alignment the kernel's cp.async copies need is refused, not
    copied."""
    x, dt, Bt, Ct, A = (torch.from_numpy(a).to(cuda_device)
                        for a in _mamba_inputs(3, 2, 9, 24, 8))
    for i in range(4):
        args = [x, dt, Bt, Ct, A]
        buf = torch.empty(args[i].numel() + 1, device=cuda_device)
        shifted = buf[1:].view(args[i].shape)
        shifted.copy_(args[i])
        args[i] = shifted
        with pytest.raises(ValueError, match="16-byte"):
            mamba_mod.mamba_scan(*args)


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


# the differentiable scans of the train mode at layer shapes: rwkv6-3b's
# 40 heads of 64 and jamba's Mamba (d_inner 8192, n 16), 2 rows x 64
# tokens (``chip_smoke.py`` phase 7e's train-step batch); rwkv6-3b's 20
# heads of one of two model shards over 4 x 256 tokens (phase 13c)
SCAN_GRAD_CASES = {"rwkv6-3b": ("rwkv6", (2, 40, 64, 64)),
                   "jamba": ("mamba", (2, 64, 8192, 16)),
                   "rwkv6-3b-model-shard-train": ("rwkv6",
                                                  (4, 20, 256, 64))}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SCAN_GRAD_CASES))
def test_cuda_scan_function_matches_plain_autograd(case, cuda_device):
    """``blocks._RWKV6Scan`` / ``blocks._MambaScan`` on the card: y and the
    final state (the kernel, launched once) and every input's gradient
    under cotangents on both, against plain-torch autograd through the
    same recurrence (``rwkv6_scan_ref`` / ``mamba_scan_ref``) on the
    same inputs, within atol = rtol = 1e-4."""
    from repro_torch.kernels import ops
    from repro_torch.models import blocks

    kind, shape = SCAN_GRAD_CASES[case]
    fn, plain, draw, counter = (
        (blocks._RWKV6Scan, ref.rwkv6_scan_ref, _rwkv_inputs, ops.rwkv6_scan)
        if kind == "rwkv6" else
        (blocks._MambaScan, ref.mamba_scan_ref, _mamba_inputs,
         ops.mamba_scan))
    arrays = draw(len(case), *shape)
    ins = [[torch.from_numpy(a).to(cuda_device).requires_grad_(True)
            for a in arrays] for _ in range(2)]
    before = counter.launches
    got = fn.apply(*ins[0])
    assert counter.launches == before + 1
    want = plain(*ins[1])
    rng = np.random.default_rng(1)
    cot = [torch.from_numpy(rng.standard_normal(tuple(o.shape)).astype(
        np.float32)).to(cuda_device) for o in want]
    for outs in (got, want):
        sum((o * c).sum() for o, c in zip(outs, cot)).backward()
    assert counter.launches == before + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g.detach(), w.detach(), atol=1e-4,
                                   rtol=1e-4)
    for i, (a, b) in enumerate(zip(*ins)):
        torch.testing.assert_close(a.grad, b.grad, atol=1e-4, rtol=1e-4,
                                   msg=lambda m, i=i: f"input {i}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_cuda_copy_blocks_is_bit_exact(kv, cuda_device):
    """The prefix cache's copy-on-write ``TierSlotPool._copy_blocks`` on a
    pool on the card: every paged leaf's destination blocks (int8 KV and
    its f32 scales too) equal the sources bit for bit, and no other
    block changes."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.params import tree_leaves
    from repro_torch.serving.slots import TierSlotPool

    cfg = get_config("phi4-mini-3.8b", "smoke")
    if kv == "int8":
        cfg = dataclasses.replace(cfg, kv_quant="int8")
    pool = TierSlotPool(cfg, 3, 24, block_size=4, prefix_chunk=8,
                        device=cuda_device)
    src, dst = [3, 7, 1], [9, 2, 12]
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    paged = [(leaf, ax) for leaf, (kind, ax) in
             zip(tree_leaves(pool.cache), tree_leaves(pool._meta))
             if kind == "paged"]
    for leaf, _ in paged:
        if leaf.dtype == torch.int8:
            leaf.copy_(torch.randint(-127, 128, leaf.shape, generator=gen,
                                     device=cuda_device, dtype=torch.int8))
        else:
            leaf.copy_(torch.randn(leaf.shape, generator=gen,
                                   device=cuda_device))
    before = [leaf.clone() for leaf, _ in paged]
    pool._copy_blocks(src, dst)
    keep = torch.tensor([b for b in range(pool.num_blocks) if b not in dst],
                        device=cuda_device)
    s = torch.tensor(src, device=cuda_device)
    d = torch.tensor(dst, device=cuda_device)
    for (leaf, ax), old in zip(paged, before):
        assert leaf.is_cuda
        assert torch.equal(leaf.index_select(ax, d), old.index_select(ax, s))
        assert torch.equal(leaf.index_select(ax, keep),
                           old.index_select(ax, keep))
    assert {leaf.dtype for leaf, _ in paged} == (
        {torch.int8, torch.float32} if kv == "int8" else {torch.float32})


# --------------------------------------------------------------------------
# device guards: a kernel launches on its tensors' device, whichever
# device is current (multi-device serving places tiers on other cards)
# --------------------------------------------------------------------------


def _guard_case(name):
    """(kernel on device tensors, CPU inputs, check(got, cpu inputs)) of
    one small case of each kernel entry point: the first case of its
    table above."""
    def close(tol=1e-4):
        return lambda got, want: [
            torch.testing.assert_close(g.cpu(), w, atol=tol, rtol=tol)
            for g, w in zip(got, want)]

    def paged_case(inputs, table, kernel, plain):
        def make(seed):
            c = table[sorted(table)[0]]
            args, kw = inputs(seed, c)
            return _torch(args, kw)
        targs, tkw = make(len(name))
        return (lambda *a, **k: (kernel(*a, **k),), targs, tkw,
                lambda got: close()(got, (plain(*targs, **tkw),)))
    if name == "ragged_attention":
        return paged_case(
            lambda s, c: _ragged_inputs(s, qlens=c[0], KV=c[1], G=c[2],
                                        hd=c[3], quant=c[4], window=c[5]),
            RAGGED_CASES, ragged_mod.ragged_attention,
            ref.ragged_attention_ref)
    if name == "paged_attention":
        return paged_case(
            lambda s, c: _paged_inputs(s, B=c[0], KV=c[1], G=c[2], hd=c[3],
                                       quant=c[4], window=c[5], masked=c[6]),
            PAGED_CASES, paged_mod.paged_attention, ref.paged_attention_ref)
    if name == "mixed_attention":
        return paged_case(
            lambda s, c: _mixed_inputs(s, qlens=c[0], KV=c[1], G=c[2],
                                       hd=c[3], quant=c[4], window=c[5],
                                       masked=c[6]),
            MIXED_CASES, mixed_mod.mixed_attention, ref.mixed_attention_ref)
    if name == "confidence_gate":
        x = torch.from_numpy(_logits((8, 4096), 3))
        return (lambda t: (gate_mod.confidence_gate(t),), (x,), {},
                lambda got: _assert_gate_close(got[0], x.double()))
    if name in ("router_gate", "moe_route"):
        G, gs, k, E, cf = ROUTE_CASES["granite-decode"]
        x = torch.from_numpy(_route_logits("granite-decode", 7))
        if name == "router_gate":
            return (lambda t: router_mod.router_gate(t, k), (x,), {},
                    lambda got: close(1e-5)(got, ref.router_gate_ref(x, k)))
        cap = _route_cap(gs, k, E, cf)
        return (lambda t: router_mod.moe_route(t, k, cap), (x,), {},
                lambda got: _check_route(got, router_mod.moe_route_ref(
                    x, k, cap)))
    if name == "flash_attention":
        B, H, KV, S, T, d, causal, window = FLASH_CASES["phi4-smoke-global"]
        q, k, v = (torch.from_numpy(a)
                   for a in _flash_inputs(1, B, H, KV, S, T, d))
        return (lambda *t: (flash_mod.flash_attention(
                    *t, causal=causal, window=window),), (q, k, v), {},
                lambda got: close()(got, (ref.flash_attention_ref(
                    q, k, v, causal=causal, window=window),)))
    if name == "rwkv6_scan":
        args = [torch.from_numpy(a)
                for a in _rwkv_inputs(2, *RWKV_CASES["two-rows"])]
        return (rwkv_mod.rwkv6_scan, tuple(args), {},
                lambda got: close()(got, ref.rwkv6_scan_ref(*args)))
    args = [torch.from_numpy(a)
            for a in _mamba_inputs(4, *MAMBA_CASES["smoke-n8"])]
    return (mamba_mod.mamba_scan, tuple(args), {},
            lambda got: close()(got, ref.mamba_scan_ref(*args)))


GUARDED = kernels.KERNELS + ("moe_route",)


def _launch_on(dev, current, name):
    kernel, args, kw, check = _guard_case(name)
    dargs = tuple(a.to(dev) for a in args)
    dkw = {k: (v.to(dev) if torch.is_tensor(v) else v)
           for k, v in kw.items()}
    with torch.cuda.device(current):
        got = kernel(*dargs, **dkw)
        outs = [t for g in got for t in (g.values() if isinstance(g, dict)
                                         else [g])]
        assert all(t.device == dev for t in outs)
        assert torch.cuda.current_device() == current.index
    torch.cuda.synchronize(dev)
    check(got)


@pytest.mark.cuda
@pytest.mark.parametrize("name", GUARDED)
def test_cuda_kernels_launch_on_a_second_card(name, cuda_device):
    """Tensors on ``cuda:1`` while ``cuda:0`` is current: each entry
    point launches on ``cuda:1`` (its device guard) and equals its plain
    version; the current device is left as it was."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: the launch on cuda:1 while cuda:0 is "
                    "current can only run where torch.cuda.device_count() "
                    ">= 2")
    _launch_on(torch.device("cuda", 1), torch.device("cuda", 0), name)


@pytest.mark.cuda
@pytest.mark.parametrize("name", GUARDED)
def test_cuda_kernels_launch_under_an_explicit_guard(name, cuda_device):
    """The same launches on ``cuda:0`` inside ``torch.cuda.device(0)``
    (one card is enough)."""
    _launch_on(torch.device("cuda", 0), torch.device("cuda", 0), name)


@pytest.mark.cuda
def test_cuda_model_shard_collectives_on_a_second_card(cuda_device):
    """The model axis's collectives across ``cuda:0`` and ``cuda:1``:
    ``all_reduce`` sums the two partials in shard order on ``cuda:0`` and
    leaves the sum on each part's card, bit for bit the sum of the same
    values on one card; ``all_gather`` concatenates in shard order on
    ``cuda:0``."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: the collectives between cuda:0 and "
                    "cuda:1 can only run where torch.cuda.device_count() "
                    ">= 2")
    from repro_torch.models import sharding

    devs = [torch.device("cuda", 0), torch.device("cuda", 1)]
    gen = torch.Generator().manual_seed(0)
    host = [torch.randn(64, 3072, generator=gen) for _ in devs]
    parts = [h.to(d) for h, d in zip(host, devs)]
    out = sharding.all_reduce(parts)
    want = host[0].to(devs[0]) + host[1].to(devs[0])
    assert [o.device for o in out] == devs
    for o in out:
        assert torch.equal(o.to(devs[0]), want)
    cat = sharding.all_gather(parts, -1)
    assert cat.device == devs[0]
    assert torch.equal(cat.cpu(), torch.cat(host, -1))
