"""The host side of the split confidence gate (``csrc/confidence_gate.cu``)
on the CPU: the split plan at the served vocabularies, the slices it
cuts, and a model of the kernel's fixed-order merge of the splits'
partials against the plain version.  The kernel itself runs in the
``cuda``-marked gate tests of ``test_torch_kernels_cuda.py``.
"""
import functools
import itertools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import confidence_gate as gate_mod  # noqa: E402
from tests.test_torch_kernels_cuda import _logits  # noqa: E402

H100_SMS = 132
plan = functools.partial(gate_mod.plan_gate_splits, sms=H100_SMS)

# vocab of each served model (its config's ``vocab``), f32 logits from
# the engine's 8 slots a tier: (splits, chunk) the plan gives each
SERVED = {"gemma3-1b": (262144, (64, 4096)),
          "phi4-mini-3.8b": (200064, (48, 4168)),
          "granite-moe-3b-a800m": (49155, (12, 4100)),
          "rwkv6-3b": (65536, (16, 4096)),
          "jamba-v0.1-52b": (65536, (16, 4096))}


def _check_slices(vocab, head, splits, chunk, dtype_bytes):
    """Every split non-empty, the splits tile [0, vocab) in order, and
    every boundary after the first split on the 16-byte grid past the
    row's head."""
    vec = 16 // dtype_bytes
    slices = gate_mod.gate_slices(vocab, head, splits, chunk)
    assert len(slices) == splits
    assert slices[0][0] == 0 and slices[-1][1] == vocab
    for (lo, hi), (nxt, _) in zip(slices, slices[1:]):
        assert hi == nxt
    for k, (lo, hi) in enumerate(slices):
        assert lo < hi, (vocab, head, splits, chunk, k)
        if k:
            assert (lo - head) % vec == 0
    return slices


@pytest.mark.parametrize("model", sorted(SERVED))
def test_plan_at_the_served_vocabularies(model):
    """8 rows (the engine's slots) fill 8 of 132 SMs, so each row splits
    into about 4 * 132 / 8 = 66 blocks, fewer where a split would read
    fewer than MIN_SPLIT logits; the slices tile the row for every head
    a row can have (granite's 49155-wide rows start at four)."""
    vocab, want = SERVED[model]
    assert plan(8, vocab, 4) == want
    splits, chunk = want
    assert 8 * splits <= gate_mod.BLOCKS_PER_SM * H100_SMS
    assert chunk % 4 == 0
    for head in range(4):
        slices = _check_slices(vocab, head, splits, chunk, 4)
        assert min(hi - lo for lo, hi in slices) >= gate_mod.MIN_SPLIT // 2


@pytest.mark.parametrize("rows,vocab,dtype_bytes,want", [
    (1, 262144, 4, (64, 4096)),        # one row: as many as MIN_SPLIT allows
    (1, 1 << 20, 4, (256, 4096)),      # the most a row can have
    (8, 65536, 2, (16, 4096)),         # bf16: 8 values a 16-byte load
    (512, 262144, 4, (1, 262144)),     # rows alone fill the card
    (528, 200064, 4, (1, 200064)),
    (264, 200064, 4, (2, 100032)),
    (8, 1, 4, (1, 1)),
    (8, 1000, 4, (1, 1000)),
    (8, 8191, 2, (1, 8191)),           # below two splits' worth
    (8, 8192, 4, (2, 4096)),
])
def test_plan_edges(rows, vocab, dtype_bytes, want):
    assert plan(rows, vocab, dtype_bytes) == want
    vec = 16 // dtype_bytes
    for head in range(min(vec, vocab)):
        _check_slices(vocab, head, *want, dtype_bytes)


def test_plan_sweep_is_bounded_and_deterministic():
    """Over a sweep of shapes, both dtypes and SM counts (a card with
    fewer SMs than the H100 too): at least 1 split and at most
    GATE_THREADS, more than 1 only when the rows leave the card short of
    BLOCKS_PER_SM blocks an SM and never past that, whole 16-byte vectors
    a chunk,
    every slice non-empty and at least MIN_SPLIT / 2 long for any head,
    and the same answer however often it is asked."""
    grid = list(itertools.product((1, 2, 3, 8, 33, 132, 300),
                                  (1, 7, 4096, 8192, 12345, 49155, 65536,
                                   200064, 262144, 1 << 20, 3 << 20),
                                  (2, 4), (78, H100_SMS)))
    first = [gate_mod.plan_gate_splits(*g) for g in grid]
    assert first == [gate_mod.plan_gate_splits(*g) for g in grid]
    for (rows, vocab, nb, sms), (splits, chunk) in zip(grid, first):
        assert 1 <= splits <= gate_mod.GATE_THREADS
        if splits == 1:
            continue
        assert rows * splits <= gate_mod.BLOCKS_PER_SM * sms
        assert chunk * nb % 16 == 0
        for head in range(16 // nb):
            slices = _check_slices(vocab, head, splits, chunk, nb)
            assert min(hi - lo for lo, hi in slices) \
                >= gate_mod.MIN_SPLIT // 2


# ---------------------------------------------------------------------------
# a model of the kernel's merge
# ---------------------------------------------------------------------------

EMPTY = (-1e30, 0.0, 0.0, -1e30, 0)          # the kernel's empty state


def _partial(x, lo, hi):
    """One split's state (m, S, T, amax, aidx) over x[lo:hi], exact in
    f64: the first index of the split's maximum."""
    seg = x[lo:hi]
    m = float(seg.max())
    e = np.exp(seg - m)
    i = int(np.argmax(seg))
    return (m, float(e.sum()), float(((seg - m) * e).sum()), float(seg[i]),
            lo + i)


def _merge(a, b):
    """The kernel's ``merge``: rescale both sums onto the larger max;
    the argmax keeps the smaller index on a tie."""
    m = max(a[0], b[0])
    ca, cb = math.exp(a[0] - m), math.exp(b[0] - m)
    s = a[1] * ca + b[1] * cb
    t = ca * (a[2] + (a[0] - m) * a[1]) + cb * (b[2] + (b[0] - m) * b[1])
    if b[3] > a[3] or (b[3] == a[3] and b[4] < a[4]):
        return (m, s, t, b[3], b[4])
    return (m, s, t, a[3], a[4])


def _warp_tree(v):
    """A warp's shuffle-down tree into lane 0: at offset ``off`` lane i
    merges lane i + off's state on its right."""
    v = list(v)
    for off in (16, 8, 4, 2, 1):
        v = [_merge(v[i], v[i + off]) if i + off < 32 else v[i]
             for i in range(32)]
    return v[0]


def _last_block_merge(states):
    """The kernel's merge of the splits' partials in the row's last block:
    lane l of one warp folds splits l, l + 32, ... in turn, from the empty
    state, then the warp's tree."""
    lanes = [EMPTY] * 32
    for j, st in enumerate(states):
        lanes[j % 32] = _merge(lanes[j % 32], st)
    return _warp_tree(lanes)


def _model_gate(x, splits, chunk, head):
    m, s, t, amax, aidx = _last_block_merge(
        [_partial(x, lo, hi)
         for lo, hi in gate_mod.gate_slices(len(x), head, splits, chunk)])
    lz = m + math.log(s)
    return {"conf": math.exp(amax - lz), "entropy": math.log(s) - t / s,
            "argmax": aidx, "logz": lz}


@pytest.mark.parametrize("vocab,rows", [(49155, 8), (65536, 8),
                                        (262144, 1)])
def test_split_merge_model_matches_plain(vocab, rows):
    """Each split's partial, merged in the kernel's fixed order, gives
    the plain version's outputs (f64, rtol 1e-12, argmax exact); one row
    of 262144 takes 64 splits, two a lane.  Rows 1 to 3 put an exact tie for the maximum on the two
    sides of a split boundary, between the first and the last split,
    and at both ends of one split: the lower index wins."""
    splits, chunk = plan(rows, vocab, 4)
    assert splits > 1
    x = _logits((4, vocab), seed=vocab).astype(np.float64)
    for r, head in enumerate((0, 1, 2, 3)):
        slices = gate_mod.gate_slices(vocab, head, splits, chunk)
        if r == 1:
            hi = slices[splits // 2][1]
            x[r, [hi - 1, hi]] = 40.0
        elif r == 2:
            x[r, [slices[-1][1] - 1, 0]] = 40.0
        elif r == 3:
            lo, hi = slices[1]
            x[r, [hi - 1, lo]] = 40.0
        got = _model_gate(x[r], splits, chunk, head)
        want = gate_mod.confidence_gate_ref(torch.from_numpy(x[r]))
        for k in ("conf", "entropy", "logz"):
            assert got[k] == pytest.approx(float(want[k]), rel=1e-12,
                                           abs=1e-12)
        assert got["argmax"] == int(want["argmax"])
        if r:
            assert got["argmax"] == int(np.flatnonzero(x[r] == 40.0)[0])
