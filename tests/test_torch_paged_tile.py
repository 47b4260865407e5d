"""The host side of the paged tile kernels (``csrc/paged_tile.cuh`` under
``ragged_attention``, ``paged_attention`` and ``mixed_attention``), on
the CPU: the split plan, the ragged and mixed grids' work items, the
launchers' shape checks, and the x4 card cases' proof of the 3xTF32
split.  The kernels themselves run in the ``cuda``-marked tests of
``test_torch_kernels_cuda.py``.
"""
import functools
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import mixed_attention as mixed_mod  # noqa: E402
from repro_torch.kernels import paged_attention as paged_mod  # noqa: E402
from repro_torch.kernels import ragged_attention as ragged_mod  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from tests.test_torch_kernels_cuda import (MIXED_TILE_CASES,  # noqa: E402
                                           PAGED_TILE_CASES,
                                           RAGGED_TILE_CASES, _mixed_inputs,
                                           _mixed_tile_inputs, _paged_inputs,
                                           _paged_tile_inputs,
                                           _ragged_inputs,
                                           _ragged_tile_inputs, _tf32,
                                           _torch)

H100_SMS = 132
plan = functools.partial(paged_mod.plan_page_splits, sms=H100_SMS)

# (G, KV, hd) of the served attention layers
SERVED = {"gemma3": (4, 1, 256), "phi4": (3, 8, 128),
          "granite": (3, 8, 64), "jamba": (4, 8, 128)}
P, BS = 41, 16                       # 640 + 8 tokens in pages of 16


def _tiles(P, bs, hd):
    return -(-P * bs // paged_mod.kv_tile_keys(hd))


@pytest.mark.parametrize("model", ["phi4", "granite", "jamba"])
def test_plan_one_split_at_the_full_bucket(model):
    """8 rows x 64 tokens packed in the 512-slot bucket already give the
    card 2 blocks per SM at 8 KV heads: no split, no merge kernel."""
    G, KV, hd = SERVED[model]
    items = ragged_mod.work_items(512, 8, G)
    assert items * KV >= 2 * H100_SMS
    assert plan(items, KV, P, BS, hd) == 1


@pytest.mark.parametrize("model", sorted(SERVED))
def test_plan_splits_decode(model):
    """A decode tick (8 rows, one token each) leaves the unsplit grid
    short of 2 blocks per SM, so the pages split: as many as fit in 2
    blocks per SM, at least 2 K/V tiles a split."""
    G, KV, hd = SERVED[model]
    for items in (8, ragged_mod.work_items(8, 8, G)):
        s = plan(items, KV, P, BS, hd)
        assert s > 1
        assert s <= _tiles(P, BS, hd) // 2
        assert items * KV * s <= 2 * H100_SMS
        assert items * KV * (s + 1) > 2 * H100_SMS \
            or s == _tiles(P, BS, hd) // 2
    # gemma3's one KV head: 8 blocks become a card's worth
    if model == "gemma3":
        assert plan(8, KV, P, BS, hd) * 8 >= H100_SMS / 2


def test_plan_is_bounded_and_deterministic():
    """Over a sweep of shapes and SM counts (a card with fewer SMs than
    the H100's 132 too): at least 1 split, never more than the row's
    2-tile ranges, more than 1 only below 2 blocks per SM and never past
    that, and the same answer however often and in whatever order it is
    asked."""
    grid = list(itertools.product((1, 3, 8, 9, 33, 40, 264, 300),
                                  (1, 2, 8), (1, 2, 5, 41, 512), (4, 16),
                                  paged_mod.TILE_HEAD_DIMS, (78, H100_SMS)))
    first = [paged_mod.plan_page_splits(*g) for g in grid]
    assert [paged_mod.plan_page_splits(*g)
            for g in reversed(grid)] == first[::-1]
    for (items, KV, P_, bs, hd, sms), s in zip(grid, first):
        assert 1 <= s <= max(1, _tiles(P_, bs, hd) // 2)
        if items * KV >= 2 * sms:
            assert s == 1
        else:
            assert items * KV * s <= 2 * sms
            if s < max(1, _tiles(P_, bs, hd) // 2):
                assert items * KV * (s + 1) > 2 * sms


@pytest.mark.parametrize("G", [1, 3, 4, 9, 64])
def test_work_items_bound_every_packing(G):
    """``ceil(W / BT) + R`` exceeds the items of any q_len that packs into
    W slots, so at least one block is left to zero the padding."""
    rng = np.random.default_rng(G)
    bt = paged_mod.TILE_ROWS // G
    for _ in range(200):
        R = int(rng.integers(1, 12))
        W = int(rng.choice([8, 16, 64, 512]))
        q_len = rng.multinomial(int(rng.integers(0, W + 1)),
                                np.ones(R) / R)
        items = int(sum(-(-int(n) // bt) for n in q_len))
        assert items < ragged_mod.work_items(W, R, G)


def test_tile_launchers_refuse_unsupported_head_dim_before_cuda():
    """hd = 96 (or more than 64 query heads per KV head) is refused by
    name on CPU tensors, before the CUDA check and before any build."""
    args, kw = _ragged_inputs(1, qlens=[1, 2], KV=1, G=1, hd=96)
    targs, tkw = _torch(args, kw)
    with pytest.raises(ValueError, match=r"head_dim 96 .*\(32, 64, 112, "
                                         r"128, 256\)"):
        ragged_mod.ragged_attention(*targs, **tkw)
    targs, tkw = _torch(*_paged_inputs(1, B=2, KV=1, G=1, hd=96))
    with pytest.raises(ValueError, match=r"head_dim 96 .*\(32, 64, 112, "
                                         r"128, 256\)"):
        paged_mod.paged_attention(*targs, **tkw)
    targs, tkw = _torch(*_paged_inputs(1, B=2, KV=1, G=65, hd=32))
    with pytest.raises(ValueError, match="at most 64"):
        paged_mod.paged_attention(*targs, **tkw)


@pytest.mark.parametrize("model", ["phi4", "granite", "jamba"])
def test_mixed_plan_one_split_at_the_full_bucket(model):
    """The padded [8, 64] bucket cut into tiles of 64 // G slots (4 a row
    at G 3 and 4) is 32 items; at 8 KV heads that is 256 blocks, a wave of
    2 per SM: no split, no merge kernel."""
    G, KV, hd = SERVED[model]
    items = mixed_mod.work_items(8, 64, G)
    assert items == 32
    assert plan(items, KV, P, BS, hd) == 1


@pytest.mark.parametrize("model", sorted(SERVED))
def test_mixed_plan_splits_decode(model):
    """The width-1 decode batch [8, 1] is one item a row: 8 items, so the
    pages split, within the plan's limits.  gemma3's single KV head
    leaves even the full bucket at 32 blocks, a quarter of the card, so
    it splits there too, into fewer than at decode."""
    G, KV, hd = SERVED[model]
    decode = plan(mixed_mod.work_items(8, 1, G), KV, P, BS, hd)
    assert mixed_mod.work_items(8, 1, G) == 8
    assert 1 < decode <= _tiles(P, BS, hd) // 2
    assert 8 * KV * decode <= 2 * H100_SMS
    full = plan(mixed_mod.work_items(8, 64, G), KV, P, BS, hd)
    if model == "gemma3":
        assert 1 < full < decode
    else:
        assert full == 1


@pytest.mark.parametrize("G", [1, 3, 4, 9, 64])
def test_mixed_work_items_cover_every_slot_once(G):
    """Block (b, i) of the mixed grid takes slots [i * BT, min((i + 1) * BT,
    C)) of row b: the B * ceil(C / BT) blocks cover each row's C slots
    once, and no tile reaches into the next row."""
    bt = paged_mod.TILE_ROWS // G
    for B, C in ((1, 1), (8, 1), (8, 64), (3, 17), (2, bt), (2, bt + 1)):
        tiles = mixed_mod.work_items(B, C, G) // B
        assert mixed_mod.work_items(B, C, G) == B * tiles
        covered = [s for i in range(tiles)
                   for s in range(i * bt, min((i + 1) * bt, C))]
        assert covered == list(range(C))


def test_mixed_launcher_refuses_unsupported_shapes_before_cuda():
    """hd = 96 (a multiple of 32 the tile body is not built for) and more
    than 64 query heads per KV head are refused by name on CPU tensors,
    before the CUDA check and before any build."""
    targs, tkw = _torch(*_mixed_inputs(1, qlens=[1, 2], KV=1, G=1, hd=96))
    with pytest.raises(ValueError, match=r"head_dim 96 .*\(32, 64, 112, "
                                         r"128, 256\)"):
        mixed_mod.mixed_attention(*targs, **tkw)
    targs, tkw = _torch(*_mixed_inputs(1, qlens=[1, 2], KV=1, G=65, hd=32))
    with pytest.raises(ValueError, match="at most 64"):
        mixed_mod.mixed_attention(*targs, **tkw)
    targs, tkw = _torch(*_mixed_inputs(1, qlens=[1, 2], KV=1, G=4, hd=32))
    with pytest.raises(ValueError, match="CUDA"):
        mixed_mod.mixed_attention(*targs, **tkw)


def test_split_workspace_only_for_several_splits():
    assert paged_mod.split_workspace(1, 8, 2, 3, 64, "cpu") == (None, None)
    acc, ml = paged_mod.split_workspace(3, 8, 2, 3, 64, "cpu")
    assert acc.numel() == 3 * 8 * 2 * 3 * 64
    assert ml.numel() == 3 * 8 * 2 * 3 * 2
    assert acc.dtype == ml.dtype == torch.float32


def _x4(cases):
    return sorted(c for c in cases if cases[c][-1] > 1)


@pytest.mark.parametrize("case", _x4(RAGGED_TILE_CASES))
def test_ragged_x4_tile_cases_defeat_one_tf32_product(case):
    """The x4 cases prove the split: the plain version on q and k rounded
    to TF32 (one TF32 product per f32 product) misses atol = rtol = 1e-4,
    which the card test holds the kernel to."""
    (q, kp, vp, pt, qs, ql), kw = _ragged_tile_inputs(case)
    targs, tkw = _torch((q, kp, vp, pt, qs, ql), kw)
    want = ref.ragged_attention_ref(*targs, **tkw)
    rounded, _ = _torch((_tf32(q), _tf32(kp), vp, pt, qs, ql), kw)
    one = ref.ragged_attention_ref(*rounded, **tkw)
    assert not torch.allclose(one, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("case", _x4(PAGED_TILE_CASES))
def test_paged_x4_tile_cases_defeat_one_tf32_product(case):
    """As the ragged x4 cases, for the paged decode cases."""
    (q, kp, vp, pt, pos), kw = _paged_tile_inputs(case)
    targs, tkw = _torch((q, kp, vp, pt, pos), kw)
    want = ref.paged_attention_ref(*targs, **tkw)
    rounded, _ = _torch((_tf32(q), _tf32(kp), vp, pt, pos), kw)
    one = ref.paged_attention_ref(*rounded, **tkw)
    assert not torch.allclose(one, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("case", _x4(MIXED_TILE_CASES))
def test_mixed_x4_tile_cases_defeat_one_tf32_product(case):
    """As the ragged x4 cases, for the mixed cases: on the live slots."""
    (q, kp, vp, pt, qs, ql), kw = _mixed_tile_inputs(case)
    targs, tkw = _torch((q, kp, vp, pt, qs, ql), kw)
    want = ref.mixed_attention_ref(*targs, **tkw)
    rounded, _ = _torch((_tf32(q), _tf32(kp), vp, pt, qs, ql), kw)
    one = ref.mixed_attention_ref(*rounded, **tkw)
    live = torch.arange(q.shape[1])[None, :] < torch.from_numpy(ql)[:, None]
    assert not torch.allclose(one[live], want[live], atol=1e-4, rtol=1e-4)
