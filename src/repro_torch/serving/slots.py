"""KV-cache slot pools (the torch twin of the JAX package's
``repro/serving/slots.py``; the allocators are host-side Python and
numpy).

Each cascade tier owns

  * ``capacity`` request rows — the tier's token batch rows.
  * a shared pool of ``num_blocks`` fixed-size KV blocks
    (``[num_blocks, block_size, kv_heads, head_dim]`` per attention
    layer, from :func:`repro_torch.models.cache.init_paged_cache`, on the
    tier's device).  Each row maps its live tokens through a page table
    ``[capacity, pages_per_row]`` of block ids; entries default to the
    reserved **null block 0**, which is never allocated — unmapped pages
    (and rows stalled waiting for a block) read/write block 0 and are
    masked or discarded.  Recurrent state (RWKV-6) has no sequence dim
    and keeps one ``[capacity, ...]`` row per request.

:meth:`TierSlotPool.write_prefill` scatters a uniform prefill's part
cache into the arena; :class:`DenseTierSlotPool` is the one-row-per-
request ``[capacity, max_seq, ...]`` arena of ``--dense-kv``.

Freeing returns blocks to the free list without touching device memory.
Reuse is safe because a block only becomes reachable through a row's page
table when that row's position enters the page, and attention masks key
positions ``> pos`` per row — by the time any position of a reused block
is attended, the new occupant has overwritten it.

Deadlock freedom under over-subscription (``num_blocks`` smaller than
``capacity * pages_per_row + 1``) follows an oldest-first discipline:
the oldest bound row may always take a free block, while younger rows
and new admissions must leave ``worst_remaining(oldest)`` blocks free.
Since every row releases all its blocks when it finishes, the oldest row
always completes, then the next-oldest inherits the guarantee.

Blocks are refcounted as in the JAX package (a row's page-table entry
holds one reference).  The prefix index, copy-on-write, arena shrinkage
and meshes are not ported; their private fields (``_index``,
``_index_refs``, ``_row_shared``) stay, empty, so the JAX package's
invariant checker audits this pool unchanged.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.models import cache as cache_lib
from repro_torch.models.params import tree_leaves, tree_map

NULL_BLOCK = 0


class SlotAllocator:
    """Fixed-capacity free-list allocator over request rows (LIFO free
    list, ascending on the first pass)."""

    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self._free: List[int] = list(range(capacity - 1, -1, -1))
        self._used = set()

    def alloc(self) -> Optional[int]:
        if not self._free:
            return None
        slot = self._free.pop()
        self._used.add(slot)
        return slot

    def free(self, slot: int) -> None:
        # double-free guard: a slot id outside the used set (already
        # freed, or never allocated) must raise — silently re-appending
        # it would hand the same row to two requests
        if slot not in self._used:
            raise ValueError(
                f"slot {slot} is not allocated (double free?)")
        self._used.remove(slot)
        self._free.append(slot)

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_used(self) -> int:
        return len(self._used)

    @property
    def utilization(self) -> float:
        return self.num_used / self.capacity


class BlockAllocator:
    """Free-list over KV blocks ``1..num_blocks-1`` (0 = null block).

    Blocks are **refcounted** as in the JAX package: ``alloc`` hands out
    a block at refcount 1, :meth:`ref` adds a reference (an extra row
    page-table mapping), and :meth:`free` decrements — the block rejoins
    the free list only when the count reaches 0.  A block is therefore
    either free or live (refcount >= 1).

    The JAX allocator's per-shard free lists and withheld (fault
    injection) blocks are not ported; their fields stay, fixed at one
    shard (``shards``, ``_span``, ``_free[0]``) and no withheld block
    (``_reserved``), so the JAX suite's invariant checker audits this
    allocator unchanged.
    """

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("need at least one block besides the null block")
        self.num_blocks = num_blocks
        self.shards = 1
        self._span = num_blocks
        # a descending list pops the lowest id first; the null block
        # (id 0) is never free
        self._free: List[List[int]] = [list(range(num_blocks - 1, 0, -1))]
        self._reserved: List[List[int]] = [[]]
        self._used = set()
        self._refcount = {}             # live block -> refs (>= 1)
        self._shared = 0                # live blocks with refcount >= 2
        self.high_water = 0
        self.shared_high_water = 0

    def alloc(self) -> Optional[int]:
        if not self._free[0]:
            return None
        b = self._free[0].pop()
        self._used.add(b)
        self._refcount[b] = 1
        self.high_water = max(self.high_water, len(self._used))
        return b

    def ref(self, block: int) -> None:
        """Add a reference to a live block (an extra page-table mapping).
        Sharing a block that is not currently allocated raises — a free
        block's contents are about to be overwritten by the next
        occupant."""
        if block not in self._used:
            raise ValueError(
                f"block {block} is not allocated (cannot share it)")
        rc = self._refcount[block] + 1
        self._refcount[block] = rc
        if rc == 2:
            self._shared += 1
            self.shared_high_water = max(self.shared_high_water,
                                         self._shared)

    def refcount(self, block: int) -> int:
        """Current reference count (0 for free and null blocks)."""
        return self._refcount.get(block, 0)

    def free(self, block: int) -> None:
        # double-free guard: a block id outside the used set (already
        # freed, the null block, or never allocated) must raise —
        # silently re-appending it would map one KV block into two rows'
        # page tables
        if block not in self._used:
            raise ValueError(
                f"block {block} is not allocated (double free?)")
        rc = self._refcount[block] - 1
        if rc > 0:
            # still shared: drop one reference, keep the block live
            self._refcount[block] = rc
            if rc == 1:
                self._shared -= 1
            return
        del self._refcount[block]
        self._used.remove(block)
        self._free[0].append(block)

    @property
    def num_shared(self) -> int:
        """Live blocks currently referenced more than once."""
        return self._shared

    # per-shard views over the one shard, read by the invariant checker
    def free_in(self, shard: int) -> int:
        return len(self._free[shard])

    def used_in(self, shard: int) -> int:
        return len(self._used)

    def reserved_in(self, shard: int) -> int:
        return len(self._reserved[shard])

    @property
    def num_free(self) -> int:
        return len(self._free[0])

    @property
    def num_used(self) -> int:
        return len(self._used)


def _write_rows(full, part, bax: int, ids):
    """Write ``part``'s rows into ``full`` at request rows ``ids`` along
    axis ``bax`` (in place), only the prefix of any dim where ``part`` is
    shorter."""
    idx = [slice(None)] * full.ndim
    idx[bax] = ids
    for d in range(full.ndim):
        if d != bax and full.shape[d] != part.shape[d]:
            idx[d] = slice(0, part.shape[d])
    full[tuple(idx)] = part.to(full.dtype)


def _write_paged(full, part, bax: int, blk, off):
    """Scatter packed prefill tokens into a block pool (in place).
    ``full`` has (kv_blocks, block) at axes (bax, bax+1); ``part`` is the
    dense prefill leaf with (batch, seq) there; ``blk``/``off`` are
    ``[n, prompt_len]`` index tensors (adjacent advanced indices keep
    their place, so they line up with part's (batch, seq) dims)."""
    idx = [slice(None)] * full.ndim
    idx[bax], idx[bax + 1] = blk, off
    pidx = [slice(None)] * part.ndim
    pidx[bax] = slice(0, blk.shape[0])
    pidx[bax + 1] = slice(0, blk.shape[1])
    full[tuple(idx)] = part[tuple(pidx)].to(full.dtype)


class TierSlotPool:
    """Request rows + block-paged KV arena for one cascade tier, on one
    device.

    ``num_blocks=None`` fully provisions the pool
    (``capacity * ceil(max_seq / block_size) + 1`` blocks): no stall can
    ever occur.  Smaller ``num_blocks`` over-subscribes the arena —
    admission and block growth then enforce the oldest-first reserve
    discipline (see module docstring).
    """

    def __init__(self, cfg, capacity: int, max_seq: int,
                 dtype=torch.float32, *, block_size: int = 16,
                 num_blocks: Optional[int] = None, device="cuda"):
        if block_size <= 0:
            raise ValueError("block_size must be positive")
        self.cfg = cfg
        self.capacity = capacity
        self.max_seq = max_seq
        self.dtype = dtype
        self.block_size = block_size
        self.pages_per_row = math.ceil(max_seq / block_size)
        full = capacity * self.pages_per_row + 1
        self.num_blocks = full if num_blocks is None else int(num_blocks)
        if self.num_blocks < self.pages_per_row + 1:
            raise ValueError(
                f"num_blocks={self.num_blocks} cannot hold one full request "
                f"({self.pages_per_row} blocks) plus the null block")
        self.oversubscribed = self.num_blocks < full
        self.blocks = BlockAllocator(self.num_blocks)
        decl = cache_lib.declare_paged_cache(cfg, capacity, self.num_blocks,
                                             block_size, dtype)
        self.cache = cache_lib.init_paged_cache(
            cfg, capacity, self.num_blocks, block_size, dtype, device)
        # per leaf: ("paged", kv_blocks axis) or ("row", request-row axis)
        self._meta = tree_map(
            lambda c: (("paged", c.axes.index("kv_blocks"))
                       if "kv_blocks" in c.axes
                       else ("row", c.axes.index("batch"))), decl)
        self._per_block = sum(
            math.prod(c.shape) // self.num_blocks
            * torch.empty((), dtype=c.dtype).element_size()
            for c in tree_leaves(decl) if "kv_blocks" in c.axes)
        self.page_table = np.zeros((capacity, self.pages_per_row), np.int32)
        self._row_blocks: List[List[int]] = [[] for _ in range(capacity)]
        self._row_demand: List[int] = [self.pages_per_row] * capacity
        self._order: List[int] = []     # bound rows, oldest first
        # prefix-cache fields of the JAX pool, inert here (see module doc)
        self._index: List[dict] = [dict()]
        self._index_refs: dict = {}
        self._row_shared: List[int] = [0] * capacity

    # -- admission-side block accounting -----------------------------------

    def _worst_remaining(self, slot: int) -> int:
        """Blocks `slot` may still need: its bound lifetime demand minus
        what it already holds."""
        return self._row_demand[slot] - len(self._row_blocks[slot])

    def _oldest_worst(self) -> int:
        """Worst-case remaining demand of the oldest bound row (the
        block-growth priority holder)."""
        return self._worst_remaining(self._order[0]) if self._order else 0

    def blocks_for(self, ntokens: int) -> int:
        return math.ceil(ntokens / self.block_size)

    def can_admit(self, prompt_len: int) -> bool:
        """True if a new request's pages for its first ``prompt_len``
        tokens fit while leaving the oldest bound row its worst-case
        remaining demand."""
        need = self.blocks_for(prompt_len)
        return self.blocks.num_free - need >= self._oldest_worst()

    def bind(self, slot: int, ntokens: int,
             row_tokens: Optional[int] = None) -> None:
        """Claim `slot` (newest) and map pages for its first ``ntokens``
        (the first chunk under chunked prefill — later chunks grow via
        :meth:`ensure_blocks`).  ``row_tokens`` bounds the row's lifetime
        demand (``prompt_len + gen_len``; default ``max_seq``) for the
        oldest-first reserve accounting.  Callers must check
        :meth:`can_admit` first."""
        if self._row_blocks[slot]:
            raise ValueError(f"slot {slot} already bound")
        need = self.blocks_for(ntokens)
        demand = self.blocks_for(self.max_seq if row_tokens is None
                                 else min(row_tokens, self.max_seq))
        if demand < need:
            raise ValueError(f"row_tokens={row_tokens} smaller than the "
                             f"{ntokens} tokens being bound")
        if self.blocks.num_free < need:
            raise RuntimeError("bind without can_admit: no free blocks")
        self._row_demand[slot] = demand
        self._order.append(slot)
        for j in range(need):
            b = self.blocks.alloc()
            self._row_blocks[slot].append(b)
            self.page_table[slot, j] = b

    def ensure_blocks(self, slot: int, pos: int) -> bool:
        """Grow `slot`'s page table to cover token index `pos`.  Returns
        False (row must stall this tick) if the reserve discipline denies
        the allocation; the oldest bound row is never denied."""
        page = pos // self.block_size
        if page >= self.pages_per_row:
            raise ValueError(f"pos {pos} beyond max_seq {self.max_seq}")
        is_oldest = self._order[0] == slot
        while len(self._row_blocks[slot]) <= page:
            if not is_oldest and \
                    self.blocks.num_free - 1 < self._oldest_worst():
                return False
            b = self.blocks.alloc()
            if b is None:
                return False
            j = len(self._row_blocks[slot])
            self._row_blocks[slot].append(b)
            self.page_table[slot, j] = b
        return True

    def bound_rows(self) -> List[int]:
        """Bound request rows, oldest first (block-growth priority)."""
        return list(self._order)

    def release(self, slot: int) -> None:
        """Drop `slot`'s block references and unmap its pages.  Releasing
        an unbound slot raises (double-release guard)."""
        if slot not in self._order:
            raise ValueError(f"slot {slot} is not bound (double release?)")
        for b in self._row_blocks[slot]:
            self.blocks.free(b)
        self._row_blocks[slot] = []
        self._row_demand[slot] = self.pages_per_row
        self.page_table[slot] = NULL_BLOCK
        self._order.remove(slot)

    # -- uniform prefill ---------------------------------------------------

    def write_prefill(self, slot_ids: Sequence[int], part_cache,
                      prompt_len: int) -> None:
        """Scatter a packed prefill cache (rows ``0..n-1`` of a
        ``[capacity, prompt_len, ...]`` tree from ``transformer.prefill``)
        into the arena, in place: attention KV through the page tables
        into the block pool, recurrent leaves into their request rows,
        each sliced to the ``n`` admitted rows.  ``bind`` must have mapped
        each slot's prompt pages already."""
        n = len(slot_ids)
        ids = np.asarray(slot_ids, np.int64)
        dev = next(iter(tree_leaves(self.cache))).device
        # token t of row i lives at (page_table[slot_i, t // bs], t % bs)
        t = np.arange(prompt_len)
        blk = torch.from_numpy(self.page_table[ids][:, t // self.block_size]
                               .astype(np.int64)).to(dev)
        off = torch.from_numpy(np.broadcast_to(
            t % self.block_size, (n, prompt_len)).astype(np.int64)).to(dev)
        rows = torch.from_numpy(ids).to(dev)

        def write(full, part, meta):
            kind, ax = meta
            if kind == "paged":
                _write_paged(full, part, ax, blk, off)
            else:
                _write_rows(full, part.narrow(ax, 0, n), ax, rows)
        tree_map(write, self.cache, part_cache, self._meta)

    # -- memory accounting -------------------------------------------------

    def memory_stats(self) -> dict:
        # the block pools' bytes per block (recurrent rows not counted)
        per_block = self._per_block
        per_token = per_block // self.block_size
        return {
            "block_size": self.block_size,
            "num_blocks": self.num_blocks,
            "kv_bytes_per_block": per_block,
            "kv_arena_bytes": per_block * self.num_blocks,
            "kv_high_water_bytes": per_block * self.blocks.high_water,
            "kv_high_water_blocks": self.blocks.high_water,
            "dense_equiv_bytes": per_token * self.capacity * self.max_seq,
        }


class DenseTierSlotPool:
    """The one-row-per-request arena (``[capacity, max_seq, ...]`` KV rows
    and recurrent state, from :func:`repro_torch.models.cache.init_cache`)
    of ``CascadeEngine(use_paged_kv=False)``: no blocks, no page tables;
    a row's KV sits at its own positions."""

    def __init__(self, cfg, capacity: int, max_seq: int,
                 dtype=torch.float32, *, device="cuda"):
        self.cfg = cfg
        self.capacity = capacity
        self.max_seq = max_seq
        self.dtype = dtype
        decl = cache_lib.declare_cache(cfg, capacity, max_seq, dtype)
        self.cache = cache_lib.init_cache(cfg, capacity, max_seq, dtype,
                                          device)
        self._bax = tree_map(lambda c: c.axes.index("batch"), decl)
        self._kv_bytes = sum(
            math.prod(c.shape) * torch.empty((), dtype=c.dtype).element_size()
            for c in tree_leaves(decl) if "kv_seq" in c.axes)

    def write_prefill(self, slot_ids: Sequence[int], part_cache) -> None:
        """Write a packed prefill cache's first ``len(slot_ids)`` rows into
        those request rows (KV at positions ``0..prompt_len-1``), in
        place."""
        n = len(slot_ids)
        dev = next(iter(tree_leaves(self.cache))).device
        rows = torch.as_tensor(np.asarray(slot_ids, np.int64), device=dev)
        tree_map(lambda full, part, bax: _write_rows(
            full, part.narrow(bax, 0, n), bax, rows),
            self.cache, part_cache, self._bax)

    def memory_stats(self) -> dict:
        total = self._kv_bytes
        return {
            "block_size": self.max_seq,
            "num_blocks": self.capacity,
            "kv_arena_bytes": total,
            "kv_high_water_bytes": total,
            "dense_equiv_bytes": total,
        }
