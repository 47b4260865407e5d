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
cache into the arena (one data shard's at a time); :class:`DenseTierSlotPool`
is the one-row-per-request ``[capacity, max_seq, ...]`` arena of
``--dense-kv``, its rows split over the data shards too.

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

**Refcounted prefix sharing** (``TierSlotPool(prefix_chunk=...)``), as in
the JAX package: every mapping of a block — a row's page-table entry or
a prefix-index entry — holds one reference; :meth:`BlockAllocator.free`
decrements and a block returns to the free list only at refcount 0.
The prefix index is a hash map keyed by the exact token bytes of
chunk-aligned prompt prefixes (boundaries are chunk multiples rounded
**down** to a block boundary, so a published block is full and never
written again).  Admission matches the longest indexed prefix, maps
those blocks read-only into the new row's page table (pinning them with
a refcount), and chunked prefill resumes at the first uncached token.
If an entry's boundary splits a block (never produced by the aligned
publisher), :meth:`TierSlotPool.bind` copies that block on write into a
private page before any scatter.  Eviction is refcount-aware LRU over
index entries: only blocks whose every reference is an index reference
return to the free list.

**Arena shrinkage** (fault injection, :meth:`TierSlotPool.shrink`)
withholds free blocks from the allocator and :meth:`TierSlotPool.unshrink`
returns them; two caps keep the oldest-first argument intact (one full
request's blocks stay usable, and the oldest row's worst-case demand
stays free).

**Data shards** (``TierSlotPool(data_shards=D)`` or a tier mesh with a
``data`` axis of ``D``), as in the JAX package: request rows and block
ids partition into ``D`` contiguous ranges, a row's blocks always come
from its own shard, and the oldest-first reserve, the prefix index and
shrinkage all run per shard.  Each shard's KV leaves live on that shard's
device and hold that shard's rows and blocks only (the JAX package places
one sharded array instead).  Shard 0's arena is indexed by global block
id, its block 0 being the null block; every other shard hands out *all*
of its global range, so its arena holds one more block, local 0, as its
own null block: global id ``g`` of shard ``s > 0`` is local ``g - s *
span + 1``, and the null entries of a page table stay 0.  Masked and
unmapped pages of a shard's rows therefore land in that shard's null
block, never on a live block of any shard.

**Model shards** (a tier mesh with a ``model`` axis of ``M > 1``): each
data shard keeps its one allocator, page tables and prefix index, and
holds ``M`` cache trees (``caches[s]`` a list), one on each of its model
devices, each with the KV heads of its model shard
(:func:`repro_torch.models.sharding.shard_config`, by the KV-head rule
of :func:`~repro_torch.models.sharding.kv_head_range`) for every block
of the data shard, and its recurrent state at its width (its RWKV-6
heads, its Mamba channels: :func:`~repro_torch.models.sharding.
inner_range`) for every row.  A block id means the same block in all
``M`` trees, so the page tables are shared, a block copy runs in each
tree, and a uniform prefill writes each model shard's part cache into
its own tree.  The dense arena (:class:`DenseTierSlotPool`) holds ``M``
trees a data shard alike.
"""
from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.models import cache as cache_lib
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.models.sharding import (data_axis_size, model_axis_size,
                                         shard_config)

NULL_BLOCK = 0


class SlotAllocator:
    """Fixed-capacity free-list allocator over request rows.

    ``shards > 1`` partitions the rows into contiguous per-shard ranges
    (``capacity`` must divide evenly); ``alloc(shard)`` then pops from
    that shard's free list only, and ``alloc(None)`` balances by picking
    the shard with the most free rows (lowest shard id on ties).  With
    the default ``shards=1``: one LIFO free list, ascending on the first
    pass.
    """

    def __init__(self, capacity: int, shards: int = 1):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        if shards <= 0 or capacity % shards:
            raise ValueError(
                f"capacity {capacity} must divide into {shards} shards")
        self.capacity = capacity
        self.shards = shards
        self._span = capacity // shards
        self._free: List[List[int]] = [
            list(range((s + 1) * self._span - 1, s * self._span - 1, -1))
            for s in range(shards)]
        self._used = set()

    def shard_of(self, slot: int) -> int:
        return slot // self._span

    def alloc(self, shard: Optional[int] = None) -> Optional[int]:
        if shard is None:
            shard = max(range(self.shards),
                        key=lambda s: (len(self._free[s]), -s))
        if not self._free[shard]:
            return None
        slot = self._free[shard].pop()
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
        self._free[self.shard_of(slot)].append(slot)

    def free_in(self, shard: Optional[int]) -> int:
        if shard is None:
            return self.num_free
        return len(self._free[shard])

    @property
    def num_free(self) -> int:
        return sum(len(f) for f in self._free)

    @property
    def num_used(self) -> int:
        return len(self._used)

    @property
    def utilization(self) -> float:
        return self.num_used / self.capacity


class BlockAllocator:
    """Free-list over KV blocks ``1..num_blocks-1`` (0 = null block).

    ``shards > 1`` partitions the block ids into contiguous per-shard
    ranges, one per data shard's arena (``num_blocks`` must divide
    evenly); shard 0's range contains the reserved null block, so it
    exposes one fewer usable block.  ``alloc(shard)`` pops from that
    shard's free list; ``high_water_by_shard`` keeps each shard's peak.

    Blocks are **refcounted** as in the JAX package: ``alloc`` hands out
    a block at refcount 1, :meth:`ref` adds a reference (an extra row
    page-table mapping or a prefix-index entry), and :meth:`free`
    decrements — the block rejoins its shard's free list only when the
    count reaches 0.  A block is therefore in exactly one of three
    states: free (on a shard free list), withheld (:meth:`reserve`), or
    live (refcount >= 1).
    """

    def __init__(self, num_blocks: int, shards: int = 1):
        if num_blocks < 2:
            raise ValueError("need at least one block besides the null block")
        if shards <= 0 or num_blocks % shards:
            raise ValueError(
                f"num_blocks {num_blocks} must divide into {shards} shards")
        self.num_blocks = num_blocks
        self.shards = shards
        self._span = num_blocks // shards
        # shard s owns ids [s*span, (s+1)*span); descending lists pop the
        # lowest id first; the null block (id 0, shard 0) is never free
        self._free: List[List[int]] = [
            list(range((s + 1) * self._span - 1,
                       max(s * self._span - 1, 0), -1))
            for s in range(shards)]
        self._used = set()
        self._used_by_shard = [0] * shards
        self._refcount = {}             # live block -> refs (>= 1)
        self._shared = 0                # live blocks with refcount >= 2
        # blocks withheld from the free lists by fault injection
        # (reserve()/restore()) — never allocated, never in _used
        self._reserved: List[List[int]] = [[] for _ in range(shards)]
        self.high_water = 0
        self.high_water_by_shard = [0] * shards
        self.shared_high_water = 0

    def shard_of(self, block: int) -> int:
        return block // self._span

    def alloc(self, shard: int = 0) -> Optional[int]:
        if not self._free[shard]:
            return None
        b = self._free[shard].pop()
        self._used.add(b)
        self._used_by_shard[shard] += 1
        self._refcount[b] = 1
        self.high_water = max(self.high_water, len(self._used))
        self.high_water_by_shard[shard] = max(
            self.high_water_by_shard[shard], self._used_by_shard[shard])
        return b

    def ref(self, block: int) -> None:
        """Add a reference to a live block (an extra page-table mapping
        or a prefix-index entry).  Sharing a block that is not currently
        allocated raises — a free block's contents are about to be
        overwritten by the next occupant (a withheld block's too)."""
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
        """Current reference count (0 for free, withheld and null
        blocks)."""
        return self._refcount.get(block, 0)

    def free(self, block: int) -> None:
        # double-free guard: a block id outside the used set (already
        # freed, withheld, the null block, or never allocated) must raise —
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
        shard = self.shard_of(block)
        self._used_by_shard[shard] -= 1
        self._free[shard].append(block)

    def used_in(self, shard: int) -> int:
        return self._used_by_shard[shard]

    @property
    def num_shared(self) -> int:
        """Live blocks currently referenced more than once."""
        return self._shared

    def reserve(self, n: int, shard: int = 0) -> int:
        """Withhold up to `n` free blocks on `shard` (fault injection:
        mid-run pool shrinkage).  Withheld blocks leave the free list but
        are not marked used; :meth:`restore` returns them.  Returns the
        number actually withheld."""
        take = min(int(n), len(self._free[shard]))
        for _ in range(take):
            self._reserved[shard].append(self._free[shard].pop())
        return take

    def restore(self, shard: Optional[int] = None) -> int:
        """Return withheld blocks to their free lists (every shard by
        default).  Returns the number restored."""
        shards = range(self.shards) if shard is None else (shard,)
        restored = 0
        for s in shards:
            restored += len(self._reserved[s])
            self._free[s].extend(self._reserved[s])
            self._reserved[s] = []
        return restored

    def reserved_in(self, shard: int) -> int:
        return len(self._reserved[shard])

    def free_in(self, shard: int) -> int:
        return len(self._free[shard])

    @property
    def num_free(self) -> int:
        return sum(len(f) for f in self._free)

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


class PrefixEntry:
    """One cached prompt prefix: ``ntokens`` block-aligned tokens whose
    KV lives in ``blocks``.  The entry holds one allocator reference per
    listed block; ``last_use`` orders LRU eviction."""

    __slots__ = ("ntokens", "blocks", "last_use")

    def __init__(self, ntokens: int, blocks: List[int], last_use: int):
        self.ntokens = ntokens
        self.blocks = blocks
        self.last_use = last_use


class _LeafMeta(NamedTuple):
    """A cache leaf's layout: ``kind`` "paged" (``ax``, its kv_blocks
    axis) or "row" (``ax``, its request-row axis).  A named tuple, so the
    tree functions take it as a leaf."""
    kind: str
    ax: int


class TierSlotPool:
    """Request rows + block-paged KV arena for one cascade tier.

    ``num_blocks=None`` fully provisions the pool
    (``capacity * ceil(max_seq / block_size) + 1`` blocks): no stall can
    ever occur.  Smaller ``num_blocks`` over-subscribes the arena —
    admission and block growth then enforce the oldest-first reserve
    discipline (see module docstring).  ``prefix_chunk`` turns on the
    prefix index, its boundaries at multiples of that many tokens
    (the engine's prefill chunk).

    ``mesh`` (a :class:`repro_torch.launch.mesh.TierMesh`) shards the
    pool over its data axis: rows and blocks partition into
    ``data_axis_size(mesh)`` contiguous shards (``capacity`` must divide;
    ``num_blocks`` is rounded up to divide), shard ``s``'s leaves
    (``caches[s]``) on the mesh's ``s``-th data device.  ``data_shards``
    sets the shard count without a mesh, every shard on ``device``.  A
    ``model`` axis of ``M > 1`` makes ``caches[s]`` a list of ``M`` trees,
    one on each of the shard's model devices (:meth:`shard_trees`).
    """

    def __init__(self, cfg, capacity: int, max_seq: int,
                 dtype=torch.float32, *, block_size: int = 16,
                 num_blocks: Optional[int] = None, device="cuda",
                 mesh=None, data_shards: Optional[int] = None,
                 prefix_chunk: Optional[int] = None):
        if block_size <= 0:
            raise ValueError("block_size must be positive")
        if prefix_chunk is not None and prefix_chunk <= 0:
            raise ValueError("prefix_chunk must be positive")
        self.cfg = cfg
        self.capacity = capacity
        self.max_seq = max_seq
        self.dtype = dtype
        self.block_size = block_size
        self.mesh = mesh
        self.data_shards = (data_axis_size(mesh) if data_shards is None
                            else int(data_shards))
        if self.data_shards <= 0 or capacity % self.data_shards:
            raise ValueError(
                f"capacity {capacity} must divide into {self.data_shards} "
                "data shards (rows are partitioned across the mesh)")
        self._row_span = capacity // self.data_shards
        self.pages_per_row = math.ceil(max_seq / block_size)
        full = capacity * self.pages_per_row + 1
        self.num_blocks = full if num_blocks is None else int(num_blocks)
        if self.data_shards > 1:
            # round up so the block pool shards evenly over the data axis
            self.num_blocks = self.data_shards * math.ceil(
                self.num_blocks / self.data_shards)
            if self.num_blocks // self.data_shards < self.pages_per_row + 1:
                raise ValueError(
                    f"num_blocks={self.num_blocks} over {self.data_shards} "
                    f"shards cannot hold one full request per shard "
                    f"({self.pages_per_row} blocks + the null block)")
        elif self.num_blocks < self.pages_per_row + 1:
            raise ValueError(
                f"num_blocks={self.num_blocks} cannot hold one full request "
                f"({self.pages_per_row} blocks) plus the null block")
        self.oversubscribed = self.num_blocks < full
        self.blocks = BlockAllocator(self.num_blocks, self.data_shards)
        decl = cache_lib.declare_paged_cache(cfg, capacity, self.num_blocks,
                                             block_size, dtype)
        self.devices = (mesh.data_devices() if mesh is not None
                        else [torch.device(device)] * self.data_shards)
        self.model_shards = model_axis_size(mesh)
        shard_cfg = shard_config(cfg, self.model_shards)
        # shard s: its rows, and its block range (plus its own null block
        # past shard 0), on its device -- or, over a model axis, one tree
        # a model shard, on that shard's device, with its KV heads
        span = self.blocks._span

        def trees(s):
            devs = (mesh.model_devices(s) if self.model_shards > 1
                    else [self.devices[s]])
            out = [cache_lib.init_paged_cache(
                shard_cfg, self._row_span, span + (s > 0), block_size,
                dtype, dev) for dev in devs]
            return out if self.model_shards > 1 else out[0]
        self.caches = [trees(s) for s in range(self.data_shards)]
        # per leaf: ("paged", kv_blocks axis) or ("row", request-row axis)
        self._meta = tree_map(
            lambda c: (_LeafMeta("paged", c.axes.index("kv_blocks"))
                       if "kv_blocks" in c.axes
                       else _LeafMeta("row", c.axes.index("batch"))), decl)
        # a block's bytes on one model device (its KV heads)
        self._per_block = sum(
            math.prod(c.shape) // self.num_blocks
            * torch.empty((), dtype=c.dtype).element_size()
            for c in tree_leaves(cache_lib.declare_paged_cache(
                shard_cfg, capacity, self.num_blocks, block_size, dtype))
            if "kv_blocks" in c.axes)
        self.page_table = np.zeros((capacity, self.pages_per_row), np.int32)
        self._row_blocks: List[List[int]] = [[] for _ in range(capacity)]
        self._row_demand: List[int] = [self.pages_per_row] * capacity
        self._order: List[int] = []     # bound rows, oldest first
        # -- prefix cache state (inert when prefix_chunk is None) -------
        self.prefix_chunk = prefix_chunk
        self._index: List[dict] = [dict() for _ in range(self.data_shards)]
        self._index_refs: dict = {}     # block -> index references held
        self._lru = 0                   # monotonic LRU clock
        self._row_shared: List[int] = [0] * capacity   # read-only pages
        self._row_published: List[int] = [0] * capacity  # chunks published
        self._released_shared: dict = {}  # slot -> live blocks at release
        self.prefix_evictions = 0
        self.prefix_cow_copies = 0

    @property
    def cache(self):
        """The KV leaves of an unsharded pool (``caches[0]``); a sharded
        pool's are per shard, in :attr:`caches`."""
        self._one_shard("cache")
        return self.caches[0]

    @cache.setter
    def cache(self, tree) -> None:
        self._one_shard("cache")
        self.caches[0] = tree

    def _one_shard(self, what: str) -> None:
        if self.data_shards != 1 or self.model_shards != 1:
            raise ValueError(
                f"{what}: the pool has {self.data_shards} data and "
                f"{self.model_shards} model shards; use the per-shard form")

    def shard_trees(self, shard: int) -> list:
        """Data shard `shard`'s cache trees, one a model shard."""
        trees = self.caches[shard]
        return trees if self.model_shards > 1 else [trees]

    def shard_rows(self, shard: int) -> slice:
        """The request rows of `shard` (a contiguous range)."""
        return slice(shard * self._row_span, (shard + 1) * self._row_span)

    def local_page_table(self, shard: int, page_table=None) -> np.ndarray:
        """`shard`'s rows of ``page_table`` (default: the pool's own) in
        its arena's local block ids: shard 0's ids are global, shard
        ``s > 0``'s global ``g`` is ``g - s * span + 1``, and null
        entries stay 0 (each shard's own null block)."""
        pt = self.page_table if page_table is None else page_table
        rows = pt[self.shard_rows(shard)]
        if shard == 0:
            return rows
        return np.where(rows == NULL_BLOCK, NULL_BLOCK,
                        rows - (shard * self.blocks._span - 1)).astype(
                            np.int32)

    # -- admission-side block accounting -----------------------------------

    def shard_of(self, slot: int) -> int:
        """The data shard owning request row `slot` (contiguous ranges)."""
        return slot // self._row_span

    def shard_of_block(self, block: int) -> int:
        """The data shard owning KV block id `block`."""
        return self.blocks.shard_of(block)

    def _worst_remaining(self, slot: int) -> int:
        """Blocks `slot` may still need: its bound lifetime demand minus
        what it already holds."""
        return self._row_demand[slot] - len(self._row_blocks[slot])

    def _oldest_in(self, shard: int) -> Optional[int]:
        """Oldest bound row on `shard` (block-growth priority holder)."""
        for s in self._order:
            if self.shard_of(s) == shard:
                return s
        return None

    def _oldest_worst(self, shard: int = 0) -> int:
        """Worst-case remaining demand of `shard`'s oldest bound row."""
        oldest = self._oldest_in(shard)
        return self._worst_remaining(oldest) if oldest is not None else 0

    def blocks_for(self, ntokens: int) -> int:
        return math.ceil(ntokens / self.block_size)

    # -- prefix index (refcounted block sharing) ----------------------------

    @property
    def prefix_enabled(self) -> bool:
        return self.prefix_chunk is not None

    def _prefix_key(self, prompt, ntokens: int) -> bytes:
        """Index key for the first `ntokens` of `prompt`: the exact token
        bytes (a map keyed by content needs no collision handling)."""
        return np.ascontiguousarray(
            np.asarray(prompt[:ntokens]), dtype=np.int32).tobytes()

    def _prefix_boundaries(self, limit: int) -> List[int]:
        """Publishable prefix boundaries <= `limit`, ascending: chunk
        multiples rounded down to a block boundary, so every block under
        a boundary is full and append-frozen by the time it is shared."""
        out = []
        k, chunk, bs = 1, self.prefix_chunk, self.block_size
        while k * chunk <= limit:
            b = (k * chunk // bs) * bs
            if b > 0 and (not out or b > out[-1]):
                out.append(b)
            k += 1
        return out

    def match_prefix(self, prompt, shard: int = 0):
        """Longest indexed prefix of `prompt`, as ``(ntokens, blocks)`` —
        ``(0, [])`` on a miss.  The match is capped at ``len(prompt) - 1``
        tokens so at least one prompt token is always prefilled (the
        final chunk computes the first-token logits).  Touches the
        entry's LRU stamp; the caller must :meth:`bind` with the match
        before anything else allocates (eviction could otherwise reclaim
        the blocks)."""
        if self.prefix_chunk is None or len(prompt) < 2:
            return 0, []
        idx = self._index[shard]
        for b in reversed(self._prefix_boundaries(len(prompt) - 1)):
            ent = idx.get(self._prefix_key(prompt, b))
            if ent is not None:
                self._lru += 1
                ent.last_use = self._lru
                return ent.ntokens, list(ent.blocks)
        return 0, []

    def publish_prefix(self, slot: int, prompt, upto: int) -> int:
        """Insert `slot`'s completed chunk boundaries (prompt KV written
        for ``[0, upto)``) into the prefix index, taking one block
        reference per listed block.  Re-publishing an existing key only
        refreshes its LRU stamp.  Returns entries added."""
        if self.prefix_chunk is None:
            return 0
        upto = min(int(upto), len(prompt))
        idx = self._index[self.shard_of(slot)]
        chunk, bs = self.prefix_chunk, self.block_size
        added, k = 0, self._row_published[slot] + 1
        while k * chunk <= upto:
            b = (k * chunk // bs) * bs
            if b > 0:
                key = self._prefix_key(prompt, b)
                self._lru += 1
                ent = idx.get(key)
                if ent is None:
                    blocks = [int(self.page_table[slot, j])
                              for j in range(b // bs)]
                    for blk in blocks:
                        self.blocks.ref(blk)
                        self._index_refs[blk] = \
                            self._index_refs.get(blk, 0) + 1
                    idx[key] = PrefixEntry(b, blocks, self._lru)
                    added += 1
                else:
                    ent.last_use = self._lru
            k += 1
        self._row_published[slot] = k - 1
        return added

    def _evict_entry(self, shard: int, key: bytes) -> None:
        ent = self._index[shard].pop(key)
        for b in ent.blocks:
            n = self._index_refs[b] - 1
            if n:
                self._index_refs[b] = n
            else:
                del self._index_refs[b]
            self.blocks.free(b)
        self.prefix_evictions += 1

    def _reclaim(self, shard: int, need_free: int) -> bool:
        """Evict LRU prefix entries until the free list holds `need_free`
        blocks.  Only blocks whose every reference is an index reference
        actually return to the free list — blocks shared with live rows
        (or longer entries) just drop one reference."""
        idx = self._index[shard]
        while idx and self.blocks.free_in(shard) < need_free:
            key = min(idx, key=lambda kk: idx[kk].last_use)
            self._evict_entry(shard, key)
        return self.blocks.free_in(shard) >= need_free

    def evictable_in(self, shard: int = 0) -> int:
        """Blocks that dropping the whole prefix index would return to
        the free list (every reference is an index reference)."""
        if self.prefix_chunk is None:
            return 0
        seen, n = set(), 0
        for ent in self._index[shard].values():
            for b in ent.blocks:
                if b not in seen:
                    seen.add(b)
                    if self.blocks.refcount(b) == self._index_refs.get(b, 0):
                        n += 1
        return n

    def prefix_index_entries(self, shard: Optional[int] = None) -> int:
        if shard is not None:
            return len(self._index[shard])
        return sum(len(i) for i in self._index)

    def _alloc_reclaiming(self, shard: int) -> Optional[int]:
        b = self.blocks.alloc(shard)
        if b is None and self._reclaim(shard, 1):
            b = self.blocks.alloc(shard)
        return b

    def can_admit(self, prompt_len: int, shard: int = 0, *,
                  cached: int = 0, prefix_blocks: Sequence[int] = ()) -> bool:
        """True if a new request's pages for its first ``prompt_len``
        tokens fit while leaving the oldest bound row its worst-case
        remaining demand.  With a prefix match, `cached` tokens are
        served by `prefix_blocks` (only the suffix pages need fresh
        blocks); LRU-evictable index blocks count toward availability,
        minus the matched blocks that admission would pin (they stop
        being evictable once a row maps them)."""
        need = self.blocks_for(prompt_len) - cached // self.block_size
        avail = self.blocks.free_in(shard) + self.evictable_in(shard)
        if cached:
            avail -= sum(
                1 for b in set(prefix_blocks[:cached // self.block_size])
                if self.blocks.refcount(b) == self._index_refs.get(b, 0) > 0)
        return avail - need >= self._oldest_worst(shard)

    def bind(self, slot: int, ntokens: int,
             row_tokens: Optional[int] = None,
             prefix: Optional[tuple] = None) -> None:
        """Claim `slot` (newest) and map pages for its first ``ntokens``
        (the cached prefix plus the first uncached chunk under chunked
        prefill — later chunks grow via :meth:`ensure_blocks`).
        ``row_tokens`` bounds the row's lifetime demand (``prompt_len +
        gen_len``; default ``max_seq``) for the oldest-first reserve
        accounting.  Callers must check :meth:`can_admit` first.

        ``prefix=(cached, blocks)`` (from :meth:`match_prefix`) maps the
        first ``cached // block_size`` blocks read-only into the page
        table, pinning each with a refcount before anything else can
        evict them.  If ``cached`` splits a block (an unaligned entry —
        the engine's publisher only emits block-aligned boundaries), the
        split block is **copied on write** into a fresh private page, so
        the row's own scatters never touch shared memory."""
        if self._row_blocks[slot]:
            raise ValueError(f"slot {slot} already bound")
        shard = self.shard_of(slot)
        cached, pblocks = (0, []) if prefix is None else prefix
        full_shared = cached // self.block_size
        need = self.blocks_for(ntokens) - full_shared
        demand = self.blocks_for(self.max_seq if row_tokens is None
                                 else min(row_tokens, self.max_seq))
        if demand < self.blocks_for(ntokens):
            raise ValueError(f"row_tokens={row_tokens} smaller than the "
                             f"{ntokens} tokens being bound")
        # pin the shared prefix first: once the row holds a reference,
        # reclaim below cannot evict the matched blocks from under us
        for j in range(full_shared):
            self.blocks.ref(pblocks[j])
            self._row_blocks[slot].append(pblocks[j])
            self.page_table[slot, j] = pblocks[j]
        self._row_shared[slot] = full_shared
        self._row_demand[slot] = demand
        self._row_published[slot] = 0
        self._order.append(slot)
        if self.blocks.free_in(shard) < need and \
                not self._reclaim(shard, need):
            # roll back the shared pins so the failed bind leaks nothing
            for b in self._row_blocks[slot]:
                self.blocks.free(b)
            self._row_blocks[slot] = []
            self._row_shared[slot] = 0
            self._row_demand[slot] = self.pages_per_row
            self.page_table[slot] = NULL_BLOCK
            self._order.remove(slot)
            raise RuntimeError("bind without can_admit: no free blocks")
        for j in range(full_shared, self.blocks_for(ntokens)):
            b = self.blocks.alloc(shard)
            self._row_blocks[slot].append(b)
            self.page_table[slot, j] = b
        if cached % self.block_size:
            # copy-on-write for the split block: the row resumes writing
            # mid-page, so it needs a private copy of the shared tokens
            self._copy_blocks([pblocks[full_shared]],
                              [int(self.page_table[slot, full_shared])])
            self.prefix_cow_copies += 1

    def shared_pages(self, slot: int) -> int:
        """Leading read-only (prefix-shared) pages mapped into `slot`."""
        return self._row_shared[slot]

    def ensure_blocks(self, slot: int, pos: int) -> bool:
        """Grow `slot`'s page table to cover token index `pos`.  Returns
        False (row must stall this tick) if the reserve discipline denies
        the allocation; the oldest bound row is never denied.  When the
        free list runs short, LRU prefix entries are evicted first —
        blocks whose only references are index references return to the
        free list."""
        page = pos // self.block_size
        if page >= self.pages_per_row:
            raise ValueError(f"pos {pos} beyond max_seq {self.max_seq}")
        shard = self.shard_of(slot)
        is_oldest = self._oldest_in(shard) == slot
        while len(self._row_blocks[slot]) <= page:
            if not is_oldest and \
                    self.blocks.free_in(shard) - 1 < self._oldest_worst(shard):
                if not self._reclaim(shard, self._oldest_worst(shard) + 1):
                    return False
            b = self._alloc_reclaiming(shard)
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
        """Drop `slot`'s block references and unmap its pages.  A block
        rejoins the free list only when its refcount hits zero — blocks
        still referenced by the prefix index (or another row sharing the
        prefix) stay live.  Stale device memory is never attended: the
        pages are unreachable once the table row is zeroed, and the next
        occupant overwrites a reused block before its positions pass the
        per-row mask.

        Releasing an unbound slot raises (double-release guard).  The
        error tells a plain double release from one whose earlier
        release left blocks live via shared references (still shared,
        not leaked)."""
        if slot not in self._order:
            still = self._released_shared.get(slot, 0)
            if still:
                raise ValueError(
                    f"slot {slot} is already released; {still} of its "
                    "blocks remain live via shared references (prefix "
                    "index or other rows) — still shared, not leaked, "
                    "so there is nothing left to release")
            raise ValueError(f"slot {slot} is not bound (double release?)")
        still_live = 0
        for b in self._row_blocks[slot]:
            self.blocks.free(b)
            if self.blocks.refcount(b) > 0:
                still_live += 1
        self._released_shared[slot] = still_live
        self._row_blocks[slot] = []
        self._row_demand[slot] = self.pages_per_row
        self._row_shared[slot] = 0
        self._row_published[slot] = 0
        self.page_table[slot] = NULL_BLOCK
        self._order.remove(slot)

    # -- fault injection: mid-run arena shrinkage ---------------------------

    def shrink(self, nblocks: int) -> int:
        """Withhold up to `nblocks` free blocks from the arena (fault
        injection: a mid-run capacity loss).  Two caps keep the run
        deadlock-free: the shard keeps at least ``pages_per_row`` usable
        blocks (the construction-time floor — one full request can always
        be served), and its free list keeps the oldest bound row's
        worst-case remaining demand (the reserve invariant the
        oldest-first discipline maintains).  Returns the number actually
        withheld; :meth:`unshrink` restores them."""
        remaining = int(nblocks)
        took = 0
        for s in range(self.data_shards):
            if remaining <= 0:
                break
            usable = self.blocks._span - (1 if s == 0 else 0)
            floor_cap = (usable - self.pages_per_row
                         - self.blocks.reserved_in(s))
            reserve_cap = self.blocks.free_in(s) - self._oldest_worst(s)
            take = min(remaining, max(min(floor_cap, reserve_cap), 0))
            got = self.blocks.reserve(take, s)
            took += got
            remaining -= got
        return took

    def unshrink(self) -> int:
        """Restore every block withheld by :meth:`shrink`."""
        return self.blocks.restore()

    # -- device-side writes ------------------------------------------------

    def _copy_blocks(self, src: Sequence[int], dst: Sequence[int]) -> None:
        """Copy whole KV blocks ``src[i] -> dst[i]`` in every paged leaf,
        int8 KV's scale leaves included (the copy-on-write primitive: a
        row taking over a partially shared block duplicates it before its
        first scatter).  In place, on the shard's device and its current
        stream: the launches that scatter into ``dst`` later run on that
        same stream, so the copy is ordered before the row's first
        write.  Both lists lie on one shard (a row's blocks and its prefix
        index's do)."""
        shard = self.shard_of_block(int(dst[0]))
        ids = np.asarray([src, dst], np.int64)
        if shard:
            ids = np.where(ids == NULL_BLOCK, NULL_BLOCK,
                           ids - (shard * self.blocks._span - 1))
        for tree in self.shard_trees(shard):
            dev = tree_leaves(tree)[0].device
            src_ids = torch.as_tensor(ids[0], device=dev)
            dst_ids = torch.as_tensor(ids[1], device=dev)
            for full, (kind, ax) in zip(tree_leaves(tree),
                                        tree_leaves(self._meta)):
                if kind == "paged":
                    full.index_copy_(ax, dst_ids,
                                     full.index_select(ax, src_ids))

    # -- uniform prefill ---------------------------------------------------

    def write_prefill(self, slot_ids: Sequence[int], part_cache,
                      prompt_len: int) -> None:
        """Scatter a packed prefill cache (rows ``0..n-1`` of a ``[rows,
        prompt_len, ...]`` tree from ``transformer.prefill``) into the
        arena, in place: attention KV through the page tables (in the
        shard's local block ids) into the block pool, recurrent leaves
        into their request rows (the shard's local rows), each sliced to
        the ``n`` admitted rows.  Every slot lies on one data shard, whose
        arena the part cache was computed beside; ``bind`` must have
        mapped each slot's prompt pages already.  Over a model axis
        ``part_cache`` holds one tree a model shard, each written into
        that shard's tree (:meth:`shard_trees`) on its device."""
        shard = _one_shard_of(self.shard_of, slot_ids)
        parts = part_cache if self.model_shards > 1 else [part_cache]
        n = len(slot_ids)
        ids = np.asarray(slot_ids, np.int64)
        # token t of row i lives at (page_table[slot_i, t // bs], t % bs)
        t = np.arange(prompt_len)
        local = ids - shard * self._row_span
        pt_blk = self.local_page_table(shard)[local][
            :, t // self.block_size].astype(np.int64)
        off = np.broadcast_to(t % self.block_size,
                              (n, prompt_len)).astype(np.int64)
        for tree, part in zip(self.shard_trees(shard), parts):
            dev = next(iter(tree_leaves(tree))).device
            blk, offs, rows = (torch.from_numpy(a).to(dev)
                               for a in (pt_blk, off, local))

            def write(full, part, meta):
                kind, ax = meta
                if kind == "paged":
                    _write_paged(full, part, ax, blk, offs)
                else:
                    _write_rows(full, part.narrow(ax, 0, n), ax, rows)
            tree_map(write, tree, part, self._meta)

    # -- memory accounting -------------------------------------------------

    def memory_stats(self) -> dict:
        # the block pools' bytes per block (recurrent rows not counted) on
        # one device: over a model axis, one model shard's KV heads; the
        # arena counts each shard past 0's own null block
        per_block = self._per_block
        per_token = per_block // self.block_size
        return {
            "block_size": self.block_size,
            "num_blocks": self.num_blocks,
            "kv_bytes_per_block": per_block,
            "kv_arena_bytes": per_block * (self.num_blocks
                                           + self.data_shards - 1),
            "kv_high_water_bytes": per_block * self.blocks.high_water,
            "kv_high_water_blocks": self.blocks.high_water,
            # per-data-shard peaks (the shard balance admission achieved)
            "data_shards": self.data_shards,
            "kv_high_water_blocks_by_shard":
                list(self.blocks.high_water_by_shard),
            # prefix cache: peak blocks mapped by >1 reference, live
            # index entries, LRU evictions, copy-on-write block copies
            "kv_shared_high_water_blocks": self.blocks.shared_high_water,
            "prefix_index_entries": self.prefix_index_entries(),
            "prefix_evictions": self.prefix_evictions,
            "prefix_cow_copies": self.prefix_cow_copies,
            "dense_equiv_bytes": per_token * self.capacity * self.max_seq,
        }


def _one_shard_of(shard_of, slot_ids: Sequence[int]) -> int:
    """The one data shard that every slot of ``slot_ids`` lies on."""
    shards = {shard_of(int(s)) for s in slot_ids}
    if len(shards) != 1:
        raise ValueError(f"slots {list(slot_ids)} lie on data shards "
                         f"{sorted(shards)}: write each shard's apart")
    return shards.pop()


class DenseTierSlotPool:
    """The one-row-per-request arena (``[capacity, max_seq, ...]`` KV rows
    and recurrent state, from :func:`repro_torch.models.cache.init_cache`)
    of ``CascadeEngine(use_paged_kv=False)``: no blocks, no page tables
    (and no ``shrink``: a fault plan's shrink skips this arena); a row's
    KV sits at its own positions.

    ``mesh`` (or ``data_shards`` without one, every shard on ``device``)
    splits the request rows into ``D`` contiguous shards, as the JAX
    package lays the arena out by ``cache_specs`` (``batch`` over the
    data axis): ``caches[s]`` holds shard ``s``'s ``[capacity / D,
    max_seq, ...]`` rows on its device.  A ``model`` axis of ``M > 1``
    makes ``caches[s]`` a list of ``M`` trees, one on each of the shard's
    model devices (:meth:`shard_trees`), each declared from
    :func:`repro_torch.models.sharding.shard_config`: its KV heads by
    :func:`~repro_torch.models.sharding.kv_head_range`, its recurrent
    leaves at its width."""

    def __init__(self, cfg, capacity: int, max_seq: int,
                 dtype=torch.float32, *, device="cuda", mesh=None,
                 data_shards: Optional[int] = None):
        self.cfg = cfg
        self.capacity = capacity
        self.max_seq = max_seq
        self.dtype = dtype
        self.data_shards = (data_axis_size(mesh) if data_shards is None
                            else int(data_shards))
        if self.data_shards <= 0 or capacity % self.data_shards:
            raise ValueError(
                f"capacity {capacity} must divide into {self.data_shards} "
                "data shards")
        self._row_span = capacity // self.data_shards
        self.model_shards = model_axis_size(mesh)
        shard_cfg = shard_config(cfg, self.model_shards)
        devices = (mesh.data_devices() if mesh is not None
                   else [torch.device(device)] * self.data_shards)

        def trees(s):
            devs = (mesh.model_devices(s) if self.model_shards > 1
                    else [devices[s]])
            out = [cache_lib.init_cache(shard_cfg, self._row_span, max_seq,
                                        dtype, dev) for dev in devs]
            return out if self.model_shards > 1 else out[0]
        self.caches = [trees(s) for s in range(self.data_shards)]
        self._bax = tree_map(lambda c: c.axes.index("batch"),
                             cache_lib.declare_cache(cfg, 1, 1, dtype))
        # the KV rows' bytes on one device: over a model axis, one model
        # shard's KV heads
        self._kv_bytes = sum(
            math.prod(c.shape) * torch.empty((), dtype=c.dtype).element_size()
            for c in tree_leaves(cache_lib.declare_cache(
                shard_cfg, capacity, max_seq, dtype)) if "kv_seq" in c.axes)

    @property
    def cache(self):
        """The one shard's rows (a sharded arena's are in :attr:`caches`)."""
        if self.data_shards != 1 or self.model_shards != 1:
            raise ValueError(f"cache: the arena has {self.data_shards} data "
                             f"and {self.model_shards} model shards; use "
                             "caches[shard]")
        return self.caches[0]

    def shard_trees(self, shard: int) -> list:
        """Data shard `shard`'s cache trees, one a model shard."""
        trees = self.caches[shard]
        return trees if self.model_shards > 1 else [trees]

    def shard_of(self, slot: int) -> int:
        """The data shard owning request row `slot`."""
        return slot // self._row_span

    def write_prefill(self, slot_ids: Sequence[int], part_cache) -> None:
        """Write a packed prefill cache's first ``len(slot_ids)`` rows into
        those request rows (KV at positions ``0..prompt_len-1``), in
        place; every slot lies on one data shard, written at its local
        rows — over a model axis, ``part_cache`` one tree a model shard,
        each into that shard's tree."""
        shard = _one_shard_of(self.shard_of, slot_ids)
        parts = part_cache if self.model_shards > 1 else [part_cache]
        n = len(slot_ids)
        local = np.asarray(slot_ids, np.int64) - shard * self._row_span
        for tree, part in zip(self.shard_trees(shard), parts):
            rows = torch.as_tensor(
                local, device=next(iter(tree_leaves(tree))).device)
            tree_map(lambda full, p, bax: _write_rows(
                full, p.narrow(bax, 0, n), bax, rows), tree, part, self._bax)

    def memory_stats(self) -> dict:
        # the KV rows' bytes on one device (over a model axis, one model
        # shard's KV heads), as the paged pool counts its blocks
        total = self._kv_bytes
        return {
            "block_size": self.max_seq,
            "num_blocks": self.capacity,
            "kv_arena_bytes": total,
            "kv_high_water_bytes": total,
            "data_shards": self.data_shards,
            "dense_equiv_bytes": total,
        }
