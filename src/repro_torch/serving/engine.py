"""CascadeEngine: request-level cascade inference on one device or several
(the torch port of the main path of ``repro/serving/engine.py``).

One engine step (tick) per tier:

  1. **admit** — pop queued/escalated requests into free KV rows
     (continuous batching: admission happens while other rows are mid
     decode).  Under chunked prefill (the default) prompts of any length
     up to ``prompt_len`` are accepted; admission is bounded by a
     per-tick **token budget** (pre-charged with the tick's carried load:
     decode tokens + in-flight prefill chunks, one currency) and by free
     KV blocks for the first chunk.  Under **uniform one-shot prefill**
     (``use_chunked_prefill=False``; forced for tiers with recurrent
     state, such as RWKV-6, and by the dense arena) every prompt has
     exactly ``prompt_len`` tokens, and the admitted requests are
     prefilled right here in ONE launch over all ``capacity`` rows
     (:func:`repro_torch.models.transformer.prefill`, the flash attention
     kernel in every attention layer, the RWKV-6 scan kernel in every
     RWKV-6 layer), scattered into the arena
     (``TierSlotPool.write_prefill``) and their first tokens fetched —
     a blocking fetch of its own, at most two admission passes a tick.
  2. **plan** — a :class:`StepPlan` is built on the host: every live row
     gets its tick's work — the next ``prefill_chunk`` tokens of its
     prompt (or the shorter tail), its single decode token, or a stall
     (block exhaustion) — as a padded ``[capacity, width]`` batch and,
     for the ragged executor, the live tokens of all rows packed
     contiguously into one flat ``[1, W]`` batch, ``W`` the smallest
     power-of-two bucket that holds them.
  3. **execute** — by one of three executors, each ending in at most ONE
     blocking device->host fetch of the emitted (token, confidence) pairs
     (:attr:`CascadeEngine.host_syncs`), with the confidence gate kernel
     on each launch's last-slot logits and the KV written in place
     through the page tables:

     * **ragged** (the default): ONE ragged step per tier per tick
       (:func:`repro_torch.models.transformer.ragged_step`, the ragged
       paged attention kernel in every layer).  A row's first token is
       emitted when its last prompt chunk completes; it decodes from the
       next tick.
     * **padded unified** (``use_ragged_step=False``): ONE padded
       ``mixed_step`` per tier per tick (the mixed attention kernel),
       processing ``capacity * width`` token slots.
     * **split** (``use_unified_step=False``, and the only executor
       without chunked prefill): a chunk launch (``prefill_chunk``, the
       mixed kernel) for the prefill rows, then a decode launch
       (``decode_step``: the paged decode kernel over the block-paged
       arena, plain-torch attention over the dense one) over every row,
       mid-prefill rows masked to the null block.  Rows whose last chunk
       completed decode in the same tick, their first token fed in on the
       device; both result pairs come back in one fetch.
  4. **gate** — requests that reach ``gen_len`` aggregate their token
     confidences; at non-final tiers the scheduler's gate (fixed δ or
     escalation budget) decides DONE vs ESCALATED.  Escalated requests
     join the next tier's queue and are decoded there from scratch.

The clock is injectable: ``WallClock`` for real Poisson traffic,
``VirtualClock`` for deterministic tests (one tick per step).

The arena is block-paged (``use_paged_kv=True``, the default) or dense
(``use_paged_kv=False``: one ``[max_seq]`` row per request, uniform
prefill only).

**Speculative cascade decoding** (``speculation_k = k > 0``, ragged
executor only): a request escalated from a tier keeps its row there as
a *draft row*.  Each tick the draft row catches up on the tokens the next
tier emitted and drafts up to k tokens ahead (the ragged forward, then a
(k−1)-step paged decode loop through ``decode_step``); the next tier
scores the staged drafts in its own ragged launch (``q_len = 1 +``
drafts, :func:`repro_torch.models.transformer.ragged_verify`, the gate
kernel over every flat slot, :func:`repro_torch.kernels.ops.spec_accept`)
and emits every accepted token plus its own next one.  Emitted tokens are
always the verifier's argmaxes, so streams equal k = 0's.  Still one
fetch per tier per tick.

The gate's calibration streams into ``metrics.calibration``: every gate
decision, every escalated request's outcome (did the next tier agree?)
and every verified draft.

**Prefix caching** (``prefix_cache=True``, the chunked executors only):
each tier's pool indexes the block-aligned chunk boundaries of the
prompts it has prefilled; admission maps a prompt's longest indexed
prefix read-only into the new row's page table and starts chunked
prefill at the first uncached token (the cached tokens cost no prefill
work and no admission budget), and every completed chunk publishes its
boundaries.  Shared blocks hold exactly the KV a fresh prefill of the
same tokens writes, so the cache changes where prompt KV comes from and
how many prefill tokens are computed, never a token.

**Overload and failure**, as in the JAX engine: when an over-subscribed
KV arena runs dry, a ``preemption_policy`` (``youngest`` /
``fewest-tokens``, chunked executors only) evicts a victim row instead of
stalling it — the victim re-queues at the head of its tier's queue and
replays prefill and decode from scratch through the chunk machinery
(greedy decode is deterministic, so the replayed stream is the same).
``submit(deadline=)`` plus a shedding pass before each tier's admission
reject queued requests that cannot meet their deadline (``SHED``).
Every launch and every fetch runs under a bounded retry with backoff
that catches :class:`repro_torch.serving.faults.TransientError` only;
when a launch's retries run out the engine fails one request
(``FAILED``) and relaunches for the rest, and when a fetch's run out the
engine stops.  Any other error — a refused launch from
``kernels.check_launch``, a CUDA error — propagates at once.  A
:class:`repro_torch.serving.faults.FaultPlan` injects pool shrinkage,
escalation storms, transient launch failures and slow ticks
deterministically; with ``faults=None`` no hook does anything.

**Observability**, as in the JAX engine: with a ``tracer``
(:class:`repro_torch.serving.observability.Tracer`) the engine records
each request's lifecycle (QUEUED, PREFILL, DECODE, PREEMPTED, ESCALATED;
DONE, FAILED, SHED) and each tick's phases (admit, plan, launch,
device_get, finish, and the whole tick) with the same events, names and
arguments, so ``scripts/check_trace.py`` reads either engine's trace.  A
``launch`` phase times the host's asynchronous dispatch only; device time
the host waits for shows under ``device_get``.  With
``profile_annotations`` each launch runs inside a named profiler range
(``run_ragged/<tier>`` and so on) and each tick inside ``tick/<id>``.
Neither adds a synchronisation or a transfer: ``host_syncs`` and the
launch counts are the same with both on and off.  ``run(metrics_interval=)``
hands a metrics snapshot to ``on_snapshot`` once per window.

**Multi-device serving**, as in the JAX engine: ``TierSpec.mesh`` (a
:class:`repro_torch.launch.mesh.TierMesh`) places a tier on its own
devices.  A ``1x1`` mesh moves the tier to one device of its own, under
every executor: the fast tier on one card and the expensive one on
another.  A ``Dx1`` mesh splits the tier's rows and KV arena into ``D``
data shards (:class:`repro_torch.serving.slots.TierSlotPool`, or the
dense :class:`~repro_torch.serving.slots.DenseTierSlotPool`), under every
executor and for every tier family: admission picks a shard per request
(:meth:`CascadeEngine._pick_shard_prefix`; the uniform path
:meth:`CascadeEngine._pick_shard`; the dense arena the row allocator's
balance), each shard's rows keep their blocks, prefix index and
oldest-first reserve on their own shard, and every launch runs once per
shard on that shard's device, over its rows and with its weights: the
ragged one at the bucket of the shard's own live tokens, a speculative
one the same with the shard's own draft loop of ``max(its draft_len) -
1`` decode steps, a uniform prefill over the shard's ``[capacity / D,
prompt_len]`` (its admitted rows, then zero rows; a shard that admitted
nothing does not launch).  So each attention kernel, scan and the gate
launch exactly ``D`` times a tier launch where the unsharded tier
launches once — a uniform prefill once per shard holding an admitted
row, a draft loop once per step of each shard — and the tier still pays
one blocking fetch a tick: the shards' results come back by one
asynchronous copy each, then one wait.  A tier with MoE layers runs each
launch over all its shards at once, layer by layer
(:func:`repro_torch.models.transformer.forward_data_shards`), so that
every MoE layer routes once over the tier's whole batch, as the JAX
engine's GSPMD placement routes it (the ragged batch: live tokens in
row order at the bucket of the tier's total; the padded, split and
decode batches ``[capacity, width]`` row-major; the uniform prefill's
packed ``[capacity, prompt_len]``): ``moe_route`` launches once per MoE
layer a tier launch, as unsharded, not ``D`` times; each shard's
experts run over the capacity buffer of the routing groups its tokens
fall in.  Speculation refuses a draft tier with MoE layers, so no draft
step routes.  Shards on one device share one replica of the params.  A
``DxM`` mesh with ``M > 1`` adds tensor parallelism under every executor
— ragged, padded, split, uniform one-shot prefill, the dense arena and
speculation — and for every tier family: each data shard's launch runs
over its ``M`` model shards, each on its device, over its attention
heads and KV heads, its RWKV-6 heads or Mamba channels, its FFN hidden
units or experts, its frontend rows and its vocabulary range, with the
all-reduces and the logits' gather written out
(:func:`repro_torch.models.transformer.forward` with ``group=``); a
uniform prefill returns one part cache a model shard, which the pool
writes into that shard's tree (its KV heads, its recurrent widths), and
the dense arena holds one tree a model shard likewise.  The confidence
gate runs once per data shard on the gathered logits (a verify's on the
whole ``[W, V]``), so the attention kernels, the scans and ``moe_route``
launch ``M`` times as often and the gate as often as without the model
axis, with no added host sync.  The weights are each model shard's
slices by ``param_specs`` (``TierSpec.shard_params``) or views into one
full replica per distinct device (the default: the compute still
splits, as in the JAX engine).

Not ported from the JAX engine: compile statistics (an eager engine
compiles nothing; they wait for CUDA graphs).
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import cache as cache_lib
from repro_torch.models import transformer
from repro_torch.models.params import param_specs, tree_map
from repro_torch.models.sharding import (ModelShards, check_model_axis,
                                         data_axis_size, model_axis_size,
                                         model_shard_params)
from repro_torch.serving import faults as faults_lib
from repro_torch.serving import observability as obs
from repro_torch.serving.metrics import ServingMetrics, TierCost
from repro_torch.serving.request import Request, RequestState
from repro_torch.serving.scheduler import CascadeScheduler, GateSpec
from repro_torch.serving.slots import DenseTierSlotPool, TierSlotPool


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, refusing a CUDA device when there is no
    card: nothing falls back to the CPU quietly."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' (CLI: --device cpu) to run on the CPU")
    return dev


@dataclass
class TierSpec:
    """One cascade member: model config + its parameter tree, and
    optionally its own mesh.

    Without a mesh the params sit on the engine's device and the tier
    runs there.  ``mesh`` (``(data, model)`` axes, from
    :func:`repro_torch.launch.mesh.make_tier_mesh`) places the tier on the
    mesh's devices: the params are copied to each distinct one (from any
    device), and the KV arena splits its request rows and block pool into
    the data axis's shards.  Tiers may sit on disjoint devices or share
    them.

    A ``model`` axis over 1 splits each data shard's launches over that
    many model shards (tensor parallelism): ``shard_params`` places each
    model shard's slices of the params (by
    :func:`repro_torch.models.params.param_specs`) on its device;
    otherwise each distinct device holds one full replica, and the
    shards on it compute over views of their slices.  With
    ``shard_params``, ``params`` may also be one tree a model shard,
    each already its shard's slices (weights too large to draw whole).
    A model axis that the layers do not allow raises ValueError here,
    naming the shapes: attention heads it cannot split
    (:func:`repro_torch.models.sharding.kv_heads_per_shard`), RWKV-6 heads
    it would cut, Mamba channels or frontend rows it does not divide
    (:func:`repro_torch.models.sharding.check_model_axis`)."""
    name: str
    cfg: ModelConfig
    params: object
    mesh: Optional[object] = None
    shard_params: bool = False

    def __post_init__(self):
        if self.model_shards() > 1:
            check_model_axis(self.cfg, self.model_shards())

    def flops_per_request(self, gen_len: int) -> float:
        """Eq 7 cost: FLOPs/token = 2 * active params."""
        return 2.0 * self.cfg.active_param_count() * gen_len

    def data_shards(self) -> int:
        return data_axis_size(self.mesh)

    def model_shards(self) -> int:
        return model_axis_size(self.mesh)


class WallClock:
    def __init__(self):
        self._t0 = time.perf_counter()

    def reset(self) -> None:
        self._t0 = time.perf_counter()

    def now(self) -> float:
        return time.perf_counter() - self._t0

    def wait_until(self, t: float) -> None:
        time.sleep(min(max(t - self.now(), 0.0), 0.05))

    def step_done(self) -> None:
        pass


class VirtualClock:
    """Deterministic clock: one tick per engine step."""

    def __init__(self, dt: float = 1.0):
        self.t = 0.0
        self.dt = dt

    def reset(self) -> None:
        self.t = 0.0

    def now(self) -> float:
        return self.t

    def wait_until(self, t: float) -> None:
        self.t = max(self.t, t)

    def step_done(self) -> None:
        self.t += self.dt


# per-row kinds in a StepPlan (KIND_DRAFT: a retained draft row catching
# up on its target request's emitted tokens and drafting ahead)
KIND_IDLE, KIND_PREFILL, KIND_DECODE, KIND_STALL, KIND_DRAFT = 0, 1, 2, 3, 4


@dataclass
class StepPlan:
    """One tier's tick, planned on the host before anything launches:
    per-row kind (idle / prefill chunk / decode token / stalled), the
    per-row token slots, live counts, and — ragged executor only, else
    None — the flat packing the ragged launch consumes: every live row's
    tokens concatenated into ``flat_tokens [1, W]`` (``W`` the smallest
    of the tier's bucket widths that holds them).  On a data-sharded tier
    each shard packs its own rows at its own bucket, and ``flat_tokens``
    holds the shards' packings side by side (``flat_widths``)."""
    width: int                  # token slots per row (chunk; 1 decode-only)
    kind: np.ndarray            # [capacity] int8 KIND_*
    tokens: np.ndarray          # [capacity, width] int32
    pos: np.ndarray             # [capacity, width] int32 abs positions
    q_len: np.ndarray           # [capacity] int32 live tokens per row
    prefill_rows: List[int]     # live prefill rows (q_len > 0)
    decode_rows: List[int]      # decode rows (stalls excluded)
    finishing: List[int]        # prefill rows whose last chunk completes
    flat_width: Optional[int]   # bucketed W >= sum(q_len), over shards
    flat_tokens: Optional[np.ndarray]   # [1, W] int32
    flat_pos: Optional[np.ndarray]      # [1, W] int32 abs positions
    q_start: Optional[np.ndarray]       # [capacity] int32 first pos
    # speculative cascade decoding (speculation_k > 0; empty otherwise):
    # verify rows are decode rows scoring drafted tokens (q_len = 1 + n),
    # draft rows are retained rows catching up on their target request's
    # emitted tokens; draft_len[s] > 0 marks rows that draft ahead after
    # catching up
    verify_rows: List[tuple] = field(default_factory=list)  # (slot, n)
    draft_rows: List[int] = field(default_factory=list)
    draft_len: Optional[np.ndarray] = None      # [capacity] int32
    # ragged: each data shard's bucket, its packing's columns of the flat
    # batch in shard order (one entry, flat_width, for one shard)
    flat_widths: Optional[List[int]] = None

    @property
    def live_prefill_tokens(self) -> int:
        return int(self.q_len[self.prefill_rows].sum()) \
            if self.prefill_rows else 0

    @property
    def live_tokens(self) -> int:
        """Real tokens this tick computes (prefill chunks + decode)."""
        return int(self.q_len.sum())


class Sharded(tuple):
    """A per-row device value of a data-sharded tier: one tensor per data
    shard, on that shard's device, holding the shard's rows in order (the
    JAX package's row-sharded array).  :meth:`CascadeEngine._fetch` joins
    the shards on the host; nothing joins them across devices."""


def _joined(outs: list):
    """One launch's outputs per data shard, as the engine passes them on:
    the outputs themselves for one shard, a :class:`Sharded` per output
    for more."""
    if len(outs) == 1:
        return outs[0]
    return tuple(Sharded(x) for x in zip(*outs))


class _TierRuntime:
    """Per-tier model, KV arena, and host-side row state.

    A tier on a mesh (``spec.mesh``) runs on the mesh's devices: its
    params are placed there (:meth:`_place_params`) and, with ``D`` data
    shards, its rows and KV blocks split into ``D`` contiguous shards, and
    every launch runs once per shard on that shard's device over that
    shard's rows and arena — over a model axis of ``M``, on the shard's
    ``M`` model devices (``groups``), tensor-parallel."""

    def __init__(self, spec: TierSpec, capacity: int, prompt_len: int,
                 max_seq: int, device, *, block_size: int = 16,
                 kv_blocks: Optional[int] = None, prefill_chunk: int = 128,
                 use_paged_kv: bool = True, use_chunked_prefill: bool = True,
                 use_unified_step: bool = True,
                 use_ragged_step: bool = True,
                 flat_buckets: Optional[Sequence[int]] = None,
                 prefix_cache: bool = False,
                 speculation_k: int = 0, spec_draft: bool = False):
        self.spec = spec
        self.capacity = capacity
        self.mesh = spec.mesh
        self.data_shards = spec.data_shards()
        self.model_shards = spec.model_shards()
        if capacity % self.data_shards:
            raise ValueError(
                f"tier {spec.name}: {capacity} slots must divide into the "
                f"mesh's {self.data_shards} data shards")
        # each data shard's device and request rows
        self.devices = ([torch.device(d) for d in self.mesh.data_devices()]
                        if self.mesh is not None else [device])
        self.device = self.devices[0]
        span = capacity // self.data_shards
        self.rows = [slice(s * span, (s + 1) * span)
                     for s in range(self.data_shards)]
        self.paged = bool(use_paged_kv)
        self.chunked = bool(use_chunked_prefill)
        self.unified = bool(use_unified_step)
        self.ragged = bool(use_ragged_step) and self.unified
        self.chunk = min(prefill_chunk, prompt_len)
        # a data-sharded tier with MoE layers runs each launch over all
        # its shards at once, layer by layer, so that every MoE layer
        # routes over the tier's whole batch as the JAX package routes it
        # (transformer.forward_data_shards): a ragged launch's at the JAX
        # engine's bucket of the tier's total live tokens (tier_buckets)
        self.joint = self.data_shards > 1 and any(
            layer.ffn.kind == "moe" for layer in spec.cfg.layers)
        self.flat_buckets = (self._default_buckets(self.rows[0].stop)
                             if flat_buckets is None
                             else self._validate_buckets(flat_buckets))
        self.tier_buckets = (self._default_buckets(capacity)
                             if flat_buckets is None else self.flat_buckets)
        self.prefix = bool(prefix_cache) and self.paged and self.chunked
        if self.paged:
            self.pool = TierSlotPool(spec.cfg, capacity, max_seq,
                                     block_size=block_size,
                                     num_blocks=kv_blocks, device=device,
                                     mesh=self.mesh,
                                     prefix_chunk=(self.chunk if self.prefix
                                                   else None))
        else:
            self.pool = DenseTierSlotPool(spec.cfg, capacity, max_seq,
                                          device=device, mesh=self.mesh)
        # each data shard's model axis (None without one), and its
        # weights: a tree, or one tree a model shard
        self.groups = [ModelShards(self.mesh.model_devices(d))
                       if self.model_shards > 1 else None
                       for d in range(self.data_shards)]
        self.replicas, self.weights = self._place_params(spec)
        self.slot_req: List[Optional[Request]] = [None] * capacity
        self.tok = np.zeros(capacity, np.int32)
        self.pos = np.zeros(capacity, np.int32)
        self.prefill_pos = np.zeros(capacity, np.int32)   # tokens written
        # speculative cascade decoding: spec_k > 0 swaps the tier's
        # ragged launch for spec_fn; draft_req maps retained draft rows to
        # their escalated target request (slot_req stays None there, so
        # planning and finishing skip them)
        self.spec_k = int(speculation_k)
        self.spec_draft = bool(spec_draft) and self.spec_k > 0
        self.draft_req: List[Optional[Request]] = [None] * capacity

    def _place_params(self, spec: TierSpec):
        """(the placed weights by device — or, with ``shard_params``, by
        (device, model shard) —, each data shard's weights: its tree, or
        one tree a model shard).

        Without ``shard_params``: one replica per distinct device of the
        mesh (shards sharing a device share it, so a card holds the
        weights once however many shards it runs), and each model shard
        computes over views of its slices there.  With it: each model
        shard's slices by ``param_specs`` on its device, placed once per
        (device, model shard).  A tensor already on its device is not
        copied (a slice of it is a view); an unmeshed tier's params stay
        as given."""
        if self.mesh is None:
            return {self.device: spec.params}, [spec.params]
        m, cfg = self.model_shards, spec.cfg
        rows = [self.mesh.model_devices(d) for d in range(self.data_shards)]

        def to(tree, dev):
            return tree_map(
                lambda t: t.to(dev) if torch.is_tensor(t) else t, tree)
        if not (spec.shard_params and m > 1):
            placed = {}
            for dev in self.mesh.devices.flat:
                if dev not in placed:
                    placed[dev] = to(spec.params, dev)
            if m == 1:
                return placed, [placed[devs[0]] for devs in rows]
            specs = param_specs(cfg, self.mesh)
            return placed, [[model_shard_params(placed[dev], cfg, specs, j, m)
                             for j, dev in enumerate(devs)] for devs in rows]
        specs = param_specs(cfg, self.mesh)
        given = spec.params if isinstance(spec.params, (list, tuple)) \
            else None
        placed = {}
        for devs in rows:
            for j, dev in enumerate(devs):
                if (dev, j) not in placed:
                    placed[dev, j] = to(
                        given[j] if given is not None else
                        model_shard_params(spec.params, cfg, specs, j, m),
                        dev)
        return placed, [[placed[dev, j] for j, dev in enumerate(devs)]
                        for devs in rows]

    def pick(self, logits2d):
        """Each row's (argmax token, max-softmax confidence), from the
        confidence gate kernel."""
        gate = kernel_ops.confidence_gate(logits2d)
        return gate["argmax"], gate["conf"]

    def ragged_fn(self, tokens, pos, page_table, q_len, q_start, shard=0):
        """The ragged flat token-batch step of one data shard: its live
        tokens packed in ``[1, W]``; returns per-row last-position picks
        in the shard's row order."""
        pages = {"page_table": page_table, "q_len": q_len,
                 "q_start": q_start}
        caches = self.pool.caches
        logits, caches[shard] = transformer.ragged_step(
            self.weights[shard], self.spec.cfg, tokens, caches[shard], pos,
            pages, group=self.groups[shard])
        return self.pick(logits)

    def spec_fn(self, tokens, pos, page_table, q_len, q_start, draft_len,
                draft_steps: int, shard=0, logits=None) -> dict:
        """The speculative ragged step of one data shard: the ragged
        forward keeping every position's logits (``logits``: already
        computed, over every shard of a MoE tier), the gate kernel over
        all ``W`` flat slots and the
        :func:`~repro_torch.kernels.ops.spec_accept` epilogue (each row's
        pick, its window of picks and its accepted draft count); then,
        on a draft tier, ``draft_steps`` paged decode steps extend each
        drafting row's catch-up pick into ``draft_len[s]`` draft tokens.
        At step j a row with ``draft_len <= j`` decodes through an
        all-null page-table row at position 0: its write lands in the
        shard's null block and its pick is discarded.  A draft tier has
        no MoE layers (the engine refuses one: those masked rows would
        route and take expert capacity), so each shard's draft loop runs
        alone.  Over a model axis the verify and every draft step run
        over the shard's model shards (``group=``), their logits gathered
        on model shard 0's device, where the gate runs once on the whole
        ``[W, V]``.  Every pick stays on the device."""
        pages = {"page_table": page_table, "q_len": q_len,
                 "q_start": q_start}
        caches, params, cfg = self.pool.caches, self.weights[shard], \
            self.spec.cfg
        group = self.groups[shard]
        if logits is None:
            logits, caches[shard] = transformer.ragged_verify(
                params, cfg, self._clamped(tokens), caches[shard], pos,
                pages, group=group)
        out = kernel_ops.spec_accept(*self.pick(logits[0]), q_len, tokens,
                                     self.spec_k)
        if not self.spec_draft:
            return out
        dtok, dconf = [out["tok"]], [out["conf"]]
        cur = q_start + q_len       # where the first draft step writes
        for j in range(1, draft_steps + 1):
            live = draft_len > j
            logits, caches[shard] = transformer.decode_step(
                params, cfg, dtok[-1][:, None], caches[shard],
                torch.where(live, cur, 0)[:, None],
                pages={"page_table": torch.where(live[:, None], page_table,
                                                 0)}, group=group)
            t, c = self.pick(logits[:, 0])
            dtok.append(t)
            dconf.append(c)
            cur = cur + 1
        out["draft_tok"] = torch.stack(dtok, 1)
        out["draft_conf"] = torch.stack(dconf, 1)
        return out

    def _clamped(self, tokens):
        """A verify's flat tokens as this tier embeds them: a draft tier
        with a larger vocabulary can draft ids past this tier's, which are
        embedded as its last id, as the JAX package's clamping gather
        does; the accept epilogue compares the drafted ids themselves, so
        such a draft is rejected."""
        return tokens.clamp(max=self.spec.cfg.vocab_size - 1)

    def mixed_fn(self, tokens, pos, page_table, q_len, shard=0):
        """The padded unified step of one data shard: every live row's
        work — prefill chunk or decode token — in one ``[rows, width]``
        batch; returns each row's pick at its last live slot."""
        pages = {"page_table": page_table, "q_len": q_len}
        caches = self.pool.caches
        logits, caches[shard] = transformer.mixed_step(
            self.weights[shard], self.spec.cfg, tokens, caches[shard], pos,
            pages, group=self.groups[shard])
        return self.pick(logits)

    def chunk_fn(self, tokens, pos, page_table, q_len, shard=0):
        """The split executor's chunk launch on one data shard; the first
        generated token is each row's pick at its last live prompt
        position (the host keeps it for final chunks only)."""
        caches = self.pool.caches
        logits, caches[shard] = transformer.prefill_chunk(
            self.weights[shard], self.spec.cfg, tokens, caches[shard], pos,
            {"page_table": page_table, "q_len": q_len},
            group=self.groups[shard])
        return self.pick(transformer.last_slot_gather(logits, q_len,
                                                      flat=False))

    def step_fn(self, tok, pos, page_table, shard=0):
        """The split executor's decode launch on one data shard: one token
        per row, through the page tables (``page_table`` None: the dense
        arena)."""
        pages = None if page_table is None else {"page_table": page_table}
        caches = self.pool.caches
        logits, caches[shard] = transformer.decode_step(
            self.weights[shard], self.spec.cfg, tok, caches[shard], pos,
            pages=pages, group=self.groups[shard])
        return self.pick(logits[:, 0])

    def prefill_fn(self, prompts, shard=0):
        """The uniform one-shot prefill of data shard ``shard``'s
        ``prompts`` [rows, prompt_len] (rows past the admitted ones are
        zeros): returns the part cache for ``write_prefill`` and each
        row's first pick from its last-position logits.  A tier with a
        modality frontend gets zero frontend embeddings, as in the JAX
        engine.  Over a model axis the part cache is one tree a model
        shard."""
        logits, part = transformer.prefill(self.weights[shard], self.spec.cfg,
                                           self._prefill_batch(prompts),
                                           group=self.groups[shard])
        tok, conf = self.pick(logits[:, -1])
        return part, tok, conf

    def _prefill_batch(self, prompts) -> dict:
        return {"tokens": prompts, **transformer.zero_frontend(
            self.spec.cfg, prompts.shape[0], prompts.device)}

    def forward_shards(self, mode: str, ins, layout, shards=None):
        """One forward over data shards ``shards`` (default: all) of a MoE
        tier, advanced layer by layer so that every MoE layer routes over
        the tier's whole batch (:func:`repro_torch.models.transformer.
        forward_data_shards`, ``layout`` its JAX slot order): ``ins`` holds
        each shard's ``(tokens, pos, pages)`` on its device (``pos`` and
        ``pages`` None in prefill).  Returns each shard's logits, and its
        part cache in prefill; the other modes update the shards' caches
        in place."""
        shards = range(self.data_shards) if shards is None else shards
        caches = self.pool.caches
        prefill = mode == "prefill"
        res = transformer.forward_data_shards(
            [self.weights[sh] for sh in shards], self.spec.cfg,
            [self._prefill_batch(i[0]) if prefill else {"tokens": i[0]}
             for i in ins], mode=mode,
            caches=[None if prefill else caches[sh] for sh in shards],
            pos=[i[1] for i in ins], pages=[i[2] for i in ins],
            groups=[self.groups[sh] for sh in shards], layout=layout)
        if prefill:
            return res
        for sh, (_, c) in zip(shards, res):
            caches[sh] = c
        return [lg for lg, _ in res]

    def row_layout(self, width: int):
        """The JAX batch of a padded launch, ``[capacity, width]`` token
        slots in row-major order: data shard ``s``'s slots are the
        ``span * width`` after shard ``s - 1``'s (padding slots inside a
        row count, and rank ahead of later rows)."""
        n = self.rows[0].stop * width
        return transformer.MoeLayout(
            [s * n + np.arange(n) for s in range(self.data_shards)],
            self.capacity * width)

    def flat_layout(self, qlen, widths):
        """The JAX batch of a ragged launch: every row's live tokens in
        global row order, then the padding up to the bucket of the tier's
        total live tokens (over :attr:`tier_buckets`); a shard's own flat
        padding is in no JAX slot."""
        live = [int(np.asarray(qlen)[rows].sum()) for rows in self.rows]
        total = self.bucket_width(sum(live), self.tier_buckets)
        slots, o = [], 0
        for n, w in zip(live, widths):
            sl = np.full(w, total, np.int64)
            sl[:n] = o + np.arange(n)
            slots.append(sl)
            o += n
        return transformer.MoeLayout(slots, total)

    # -- ragged flat-width buckets ------------------------------------------

    def _default_buckets(self, rows: int) -> List[int]:
        """Powers of two from 8 up to the first covering the worst-case
        tick of ``rows`` rows (each prefilling a full chunk): one data
        shard's for its own packing, the whole tier's for the JAX
        engine's."""
        worst = max(rows * self.chunk, 1)
        buckets, w = [], 8
        while w < worst:
            buckets.append(w)
            w *= 2
        buckets.append(w)
        return buckets

    def _validate_buckets(self, buckets: Sequence[int]) -> List[int]:
        """An override of the bucket set, sorted and deduplicated; the
        JAX engine's checks and messages.  The rule for widths over 16
        is the TPU kernel's 16-token query tile: the port's tile body
        takes any width (:func:`repro_torch.kernels.ragged_attention.
        work_items`), but the port accepts exactly the JAX engine's
        bucket sets.  Each data shard packs its own rows, so the largest
        bucket covers one shard's worst-case tick (the whole tier's
        without a mesh, and on a MoE tier, whose route takes the JAX
        engine's width of the whole tier's tick)."""
        out = sorted({int(b) for b in buckets})
        if not out or out[0] <= 0:
            raise ValueError(f"flat_buckets must be positive: {buckets}")
        for b in out:
            if b > 16 and b % 16:
                raise ValueError(
                    f"flat bucket {b} must be a multiple of the ragged "
                    "kernel's 16-token query tile (widths <= 16 are "
                    "single-tile and exempt)")
        rows = self.capacity if self.joint else self.rows[0].stop
        worst = rows * self.chunk
        if out[-1] < worst:
            raise ValueError(
                f"largest flat bucket {out[-1]} cannot cover the "
                f"worst-case tick of {worst} live tokens "
                f"({rows} slots x {self.chunk}-token chunks)")
        return out

    def bucket_width(self, live_tokens: int, buckets=None) -> int:
        """Smallest bucket of ``buckets`` (default: the shards'
        :attr:`flat_buckets`) holding `live_tokens` (>= 1 slot)."""
        buckets = buckets or self.flat_buckets
        need = max(int(live_tokens), 1)
        for b in buckets:
            if b >= need:
                return b
        return buckets[-1]

    # -- device placement ---------------------------------------------------

    def put(self, *arrays, shard: int = 0):
        """Host int32 arrays onto data shard `shard`'s device in ONE copy
        (pinned and asynchronous on CUDA); returns device views in the
        given shapes.  Every per-tick input of a launch goes this way, an
        escalated request's tokens too: they reach this tier's device
        from the host."""
        flat = np.concatenate([np.asarray(a, np.int32).ravel()
                               for a in arrays])
        host = torch.from_numpy(flat)
        dev = self.devices[shard]
        if dev.type == "cuda":
            on = host.pin_memory().to(dev, non_blocking=True)
        else:
            on = host.to(dev)
        out, o = [], 0
        for a in arrays:
            n = int(np.prod(np.shape(a)))
            out.append(on[o:o + n].view(np.shape(a)))
            o += n
        return out

    def _shard_inputs(self, arrays, page_table=None) -> list:
        """Each data shard's rows of each host array of ``arrays`` and,
        where given, of ``page_table`` in its arena's local block ids, on
        its device in one copy."""
        ins = []
        for sh, rows in enumerate(self.rows):
            host = [np.asarray(a)[rows] for a in arrays]
            if page_table is not None:
                host.append(self.pool.local_page_table(sh, page_table))
            ins.append(self.put(*host, shard=sh))
        return ins

    def run_ragged(self, flat_tokens, flat_pos, qlen, qstart, widths=None):
        """The tick's ragged launch at a bucketed flat width, one per data
        shard: ``widths`` (one per shard, summing to the flat width;
        default: the whole width, one shard) cuts the flat batch into
        each shard's own packing.  A MoE tier's shards run as one forward
        (:meth:`forward_shards`)."""
        widths = widths or [flat_tokens.shape[1]]
        ins = self._flat_inputs(flat_tokens, flat_pos, qlen, qstart,
                                widths)
        if not self.joint:
            return _joined([self.ragged_fn(*i, shard=sh)
                            for sh, i in enumerate(ins)])
        logits = self.forward_shards(
            "ragged_step", [(t, p, {"page_table": pt, "q_len": q,
                                    "q_start": qs})
                            for t, p, pt, q, qs, *_ in ins],
            self.flat_layout(qlen, widths))
        return _joined([self.pick(transformer.last_slot_gather(
            lg, i[3], flat=True)) for lg, i in zip(logits, ins)])

    def _flat_inputs(self, flat_tokens, flat_pos, qlen, qstart, widths,
                     *extra):
        """Each data shard's cut of a flat batch, its page table, its
        rows of ``qlen``, ``qstart`` and each array of ``extra``, on its
        device in one copy."""
        ins, o = [], 0
        for sh, (rows, w) in enumerate(zip(self.rows, widths)):
            ins.append(self.put(
                flat_tokens[:, o:o + w], flat_pos[:, o:o + w],
                self.pool.local_page_table(sh), qlen[rows], qstart[rows],
                *(np.asarray(e)[rows] for e in extra), shard=sh))
            o += w
        return ins

    def run_spec(self, flat_tokens, flat_pos, qlen, qstart, draft_len,
                 widths=None) -> tuple:
        """The speculative launch, one per data shard: :meth:`run_ragged`'s
        flat batch plus each row's draft budget ``draft_len`` [capacity],
        in one copy a shard; each shard's draft loop runs ``max(its
        draft_len) - 1`` decode steps on its own (a draft tier routes no
        MoE layer, :meth:`spec_fn`).  Returns the outputs joined
        (:class:`Sharded` values for more than one shard) and the draft
        steps summed over the shards."""
        widths = widths or [flat_tokens.shape[1]]
        ins = self._flat_inputs(flat_tokens, flat_pos, qlen, qstart,
                                widths, draft_len)
        steps = [max(int(np.asarray(draft_len)[rows].max()) - 1, 0)
                 for rows in self.rows]
        logits = [None] * self.data_shards
        if self.joint:
            logits = self.forward_shards(
                "ragged_step", [(self._clamped(t), p,
                                 {"page_table": pt, "q_len": q,
                                  "q_start": qs})
                                for t, p, pt, q, qs, _ in ins],
                self.flat_layout(qlen, widths))
        outs = [self.spec_fn(*i, steps[sh], shard=sh, logits=logits[sh])
                for sh, i in enumerate(ins)]
        if len(outs) == 1:
            return outs[0], steps[0]
        # each shard's drafts to the widest shard's columns
        for o in outs:
            for k in ("draft_tok", "draft_conf"):
                if k in o:
                    o[k] = torch.nn.functional.pad(
                        o[k], (0, max(steps) + 1 - o[k].shape[1]))
        return {k: Sharded(o[k] for o in outs) for k in outs[0]}, sum(steps)

    def run_mixed(self, tokens, pos, qlen):
        """The padded unified launch, one per data shard: each row
        scatters into and attends its own pages, so no page-table masking
        is needed."""
        ins = self._shard_inputs((tokens, pos, qlen), self.pool.page_table)
        if not self.joint:
            return _joined([self.mixed_fn(t, p, pt, q, shard=sh)
                            for sh, (t, p, q, pt) in enumerate(ins)])
        logits = self.forward_shards(
            "mixed_step", [(t, p, {"page_table": pt, "q_len": q})
                           for t, p, q, pt in ins],
            self.row_layout(tokens.shape[1]))
        return _joined([self.pick(transformer.last_slot_gather(
            lg, i[2], flat=False)) for lg, i in zip(logits, ins)])

    def run_prefill(self, slot_ids, prompts):
        """The uniform prefill launch, one per data shard holding an
        admitted row (a shard with none does not launch): each shard
        prefills ``[capacity / D, prompt_len]`` on its device — its
        admitted rows in admission order, then zero rows — with its
        weights (a MoE tier's shards as one forward, routed over the JAX
        package's packed ``[capacity, prompt_len]`` batch).  Returns
        ``(parts, tok, conf, order)``: each launching shard's ``(slots,
        part cache)``, the first picks joined over the launching shards'
        rows, and where each admitted request's pick sits in them."""
        span, plen = self.rows[0].stop, np.shape(prompts)[1]
        by_shard = {}
        for i, slot in enumerate(slot_ids):
            by_shard.setdefault(slot // span, []).append(i)
        shards = sorted(by_shard)
        ins = []
        for sh in shards:
            batch = np.zeros((span, plen), np.int32)
            batch[:len(by_shard[sh])] = np.asarray(prompts)[by_shard[sh]]
            ins.append(self.put(batch, shard=sh))
        if self.joint:
            slots = []
            for sh in shards:
                sl = np.full((span, plen), self.capacity * plen, np.int64)
                for r, i in enumerate(by_shard[sh]):
                    sl[r] = i * plen + np.arange(plen)
                slots.append(sl.ravel())
            res = self.forward_shards(
                "prefill", [(b, None, None) for (b,) in ins],
                transformer.MoeLayout(slots, self.capacity * plen), shards)
            outs = [(part, *self.pick(lg[:, -1])) for lg, part in res]
        else:
            outs = [self.prefill_fn(b, shard=sh)
                    for sh, (b,) in zip(shards, ins)]
        parts = [([slot_ids[i] for i in by_shard[sh]], part)
                 for sh, (part, _, _) in zip(shards, outs)]
        order = [0] * len(slot_ids)
        for k, sh in enumerate(shards):
            for r, i in enumerate(by_shard[sh]):
                order[i] = k * span + r
        _, tok, conf = _joined(outs)
        return parts, tok, conf, order

    def run_chunk(self, tokens, pos, qlen):
        """The split executor's chunk launch over the prefill rows, one
        per data shard."""
        ins = self._shard_inputs((tokens, pos, qlen), self.pool.page_table)
        if not self.joint:
            return _joined([self.chunk_fn(t, p, pt, q, shard=sh)
                            for sh, (t, p, q, pt) in enumerate(ins)])
        logits = self.forward_shards(
            "prefill_chunk", [(t, p, {"page_table": pt, "q_len": q})
                              for t, p, q, pt in ins],
            self.row_layout(tokens.shape[1]))
        return _joined([self.pick(transformer.last_slot_gather(
            lg, i[2], flat=False)) for lg, i in zip(logits, ins)])

    def run_step(self, tok, mask_rows=(), first=None, fresh=()):
        """The split executor's decode launch, one per data shard: row s
        decodes ``tok[s]`` at ``self.pos[s]``; rows in ``fresh`` take
        their token from the device value ``first`` [capacity] instead
        (the chunk launch's pick, never fetched).  ``mask_rows`` (rows
        mid-prefill) decode through an all-null page-table row
        (:meth:`masked_page_table`); the dense arena takes no page
        table."""
        is_fresh = np.zeros(self.capacity, np.int32)
        is_fresh[list(fresh)] = 1
        pt = self.masked_page_table(mask_rows) if self.paged else None
        ins = self._shard_inputs((np.asarray(tok, np.int32)[:, None],
                                  is_fresh, self.pos[:, None]), pt)
        steps = []
        for sh, (tok_in, fr, pos, *page) in enumerate(ins):
            if first is not None:
                f = first[sh] if isinstance(first, Sharded) else first
                tok_in = torch.where(fr[:, None].bool(),
                                     f[:, None].to(torch.int32), tok_in)
            steps.append((tok_in, pos, page[0] if page else None))
        if not self.joint:
            return _joined([self.step_fn(*st, shard=sh)
                            for sh, st in enumerate(steps)])
        logits = self.forward_shards(
            "decode", [(t, p, None if pt is None else {"page_table": pt})
                       for t, p, pt in steps], self.row_layout(1))
        return _joined([self.pick(lg[:, 0]) for lg in logits])

    def masked_page_table(self, mask_rows: Sequence[int] = ()):
        """The host page tables a launch copies to the device (the JAX
        runtime's ``page_table_device``).  ``mask_rows`` (rows mid-prefill
        during a decode launch) are unmapped in a copy, so that launch's
        scatter and gather for them hit the null block instead of the
        blocks their prefill chunks are filling.  The pool's own table is
        never masked."""
        pt = self.pool.page_table
        if len(mask_rows):
            pt = pt.copy()
            pt[list(mask_rows)] = 0
        return pt

    def occupied(self) -> List[int]:
        return [s for s, r in enumerate(self.slot_req) if r is not None]

    def decoding(self) -> List[int]:
        return [s for s, r in enumerate(self.slot_req)
                if r is not None and r.state is RequestState.DECODE
                and not r.decode_finished]

    def prefilling(self) -> List[int]:
        return [s for s, r in enumerate(self.slot_req)
                if r is not None and r.state is RequestState.PREFILL]

    def draft_slots(self) -> List[int]:
        """Rows retained as draft rows for escalated requests."""
        return [s for s, r in enumerate(self.draft_req) if r is not None]


class _RetryExhausted(RuntimeError):
    """Internal: a launch's bounded retry budget ran out on persistent
    transient errors.  The engine catches this at each launch site and
    sacrifices a single victim request — never the run."""

    def __init__(self, kind: str, cause: BaseException):
        super().__init__(f"launch retries exhausted in {kind}: {cause}")
        self.kind = kind
        self.cause = cause


def _to_host(flats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Each data shard's flat result buffer in host memory.  One buffer
    (an unsharded tier): one blocking copy.  More: an asynchronous copy
    per shard into pinned memory, each on its device's current stream,
    then one wait for all of them, so the copies overlap."""
    if len(flats) == 1:
        return [flats[0].cpu()]
    hosts, done = [], []
    for f in flats:
        if f.device.type != "cuda":
            hosts.append(f.cpu())
            continue
        with torch.cuda.device(f.device):
            h = torch.empty(f.shape, dtype=f.dtype, pin_memory=True)
            h.copy_(f, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
        hosts.append(h)
        done.append(ev)
    for ev in done:
        ev.synchronize()
    return hosts


def _transient_error_types() -> tuple:
    """Exception classes the retry wrapper treats as transient: the
    injected :class:`repro_torch.serving.faults.TransientError` only.
    The JAX engine adds jax's runtime-error class (transfer hiccups,
    collective timeouts), which one card has no counterpart for; a
    ``RuntimeError`` from a refused launch (``kernels.check_launch``: a
    wrong shape) or a CUDA error (a sticky one poisons the context) is
    not transient, and a retry would only hide it."""
    return (faults_lib.TransientError,)


class CascadeEngine:
    """M-tier cascade with continuous batching and per-request gating."""

    def __init__(self, tiers: Sequence[TierSpec], *,
                 slots: int | Sequence[int] = 8,
                 prompt_len: int = 32, gen_len: int = 16,
                 deltas: Optional[Sequence[float]] = None,
                 escalation_budget: Optional[float] = None,
                 conf_reduce: str = "mean",
                 kv_block_size: int = 16,
                 kv_blocks: Optional[int | Sequence[Optional[int]]] = None,
                 prefill_chunk: int = 128,
                 prefill_token_budget: Optional[int] = None,
                 use_paged_kv: bool = True,
                 use_chunked_prefill: Optional[bool] = None,
                 use_unified_step: Optional[bool] = None,
                 use_ragged_step: Optional[bool] = None,
                 flat_buckets: Optional[Sequence[int]] = None,
                 prefix_cache: bool = False,
                 speculation_k: int = 0,
                 spec_delta: Optional[float] = None,
                 tracer: Optional[obs.Tracer] = None,
                 profile_annotations: bool = False,
                 clock=None,
                 preemption_policy: str = "none",
                 launch_retries: int = 2,
                 retry_backoff: float = 0.02,
                 faults: Optional[faults_lib.FaultPlan] = None,
                 device="cuda"):
        """``prompt_len`` is the maximum prompt length: ``submit`` takes
        any length in ``[1, prompt_len]`` under chunked prefill, exactly
        ``prompt_len`` under uniform prefill.  ``kv_blocks`` sizes each
        tier's arena in KV blocks of ``kv_block_size`` tokens — None fully
        provisions (``slots * ceil(max_seq / block_size) + 1``); fewer
        over-subscribes it (admission is then block-limited and rows may
        stall a tick waiting for a block).  ``prefill_token_budget``
        bounds admission per tier per tick (default ``slots *
        prefill_chunk``).  Tokens and confidences come from the
        confidence gate kernel.  The gate is a fixed ``deltas`` per
        non-final tier, an ``escalation_budget`` (δ = that quantile of
        recent sequence confidences), or δ = 0.5.  ``device`` must hold
        the params of every tier without a mesh (``TierSpec.mesh``: the
        module docstring); a CUDA device without a card raises.

        The executor follows the JAX engine's switches, defaults and
        errors: ``use_paged_kv`` (default on) picks the block-paged arena,
        ``False`` the dense one; ``use_chunked_prefill`` (default: on
        exactly when every tier can take it — a paged arena and no
        recurrent state) advances prompts chunk by chunk, ``False``
        prefills each admission in one uniform launch;
        ``use_unified_step`` (default: on exactly when chunked) runs one
        launch per tier per tick, ``False`` the split chunk + decode
        launches; ``use_ragged_step`` (default: on exactly when unified)
        packs that launch's live tokens flat, ``False`` keeps the padded
        ``[capacity, width]`` mixed launch.  ``flat_buckets`` overrides the
        ragged launch's bucket widths (default: powers of two from 8 up
        to the first that covers ``capacity * prefill_chunk``); as in the
        JAX engine it requires the ragged executor, each width over 16
        must be a multiple of 16 and the largest must cover ``capacity *
        prefill_chunk``.

        ``tracer`` attaches a
        :class:`repro_torch.serving.observability.Tracer` that records
        the requests' lifecycles and the ticks' phases (the module
        docstring); ``profile_annotations`` wraps each launch and each
        tick in a named profiler range (NVTX too on a CUDA device).  Both
        default off, and then no trace call does anything.

        ``prefix_cache`` turns on refcounted prefix caching (the module
        docstring); it requires chunked prefill, as in the JAX engine.

        ``speculation_k`` > 0 turns on speculative cascade decoding (the
        module docstring): it needs two tiers or more, the ragged
        executor, and draft tiers without MoE layers (a draft loop's
        masked rows would take expert capacity).  ``spec_delta`` is the
        confidence a drafted token must reach to be staged (default: the
        draft tier's gate δ).

        ``preemption_policy`` trades stalls for evictions when the KV
        block pool runs dry (the module docstring): ``youngest`` evicts
        the most recently bound row, ``fewest-tokens`` the
        least-progressed one; it requires chunked prefill, and the
        oldest bound row is never evicted, so the oldest-first
        termination argument survives.  ``launch_retries`` bounds the
        retry with backoff around every launch and fetch
        (``retry_backoff`` seconds, doubling).  ``faults`` attaches a
        :class:`repro_torch.serving.faults.FaultPlan`."""
        if not tiers:
            raise ValueError("need at least one tier")
        self.device = resolve_device(device)
        self.tiers = list(tiers)
        m = len(self.tiers)
        for t in self.tiers:
            if t.mesh is not None:
                continue        # _place_params moves them to the mesh
            dev = t.params["embed"].device
            if dev.type != self.device.type or (
                    dev.index is not None and self.device.index is not None
                    and dev.index != self.device.index):
                raise ValueError(f"tier {t.name}: params on {dev}, engine "
                                 f"on {self.device}")
        if prefill_chunk <= 0:
            raise ValueError("prefill_chunk must be positive")
        chunkable = use_paged_kv and all(
            not cache_lib.has_recurrent_state(t.cfg) and t.cfg.frontend
            is None for t in self.tiers)
        if use_chunked_prefill is None:
            use_chunked_prefill = chunkable
        elif use_chunked_prefill and not chunkable:
            raise ValueError(
                "chunked prefill requires the block-paged KV arena "
                "(use_paged_kv=True) and attention-only tiers without a "
                "modality frontend (recurrent state cannot be carried "
                "across prefill chunks)")
        self.chunked_prefill = bool(use_chunked_prefill)
        self.paged_kv = bool(use_paged_kv)
        if use_unified_step is None:
            use_unified_step = use_chunked_prefill
        elif use_unified_step and not use_chunked_prefill:
            raise ValueError(
                "unified token-batch execution requires chunked paged "
                "prefill (use_paged_kv=True, attention-only tiers); dense "
                "and recurrent-state tiers keep the legacy split "
                "chunk+decode path (use_unified_step=False)")
        if use_ragged_step is None:
            use_ragged_step = use_unified_step
        elif use_ragged_step and not use_unified_step:
            raise ValueError(
                "the ragged flat token-batch layout runs inside unified "
                "token-batch execution (use_unified_step=True); the split "
                "and dense paths have no flat batch to pack")
        self.unified_step = bool(use_unified_step)
        self.ragged_step = bool(use_ragged_step) and self.unified_step
        if flat_buckets is not None and not self.ragged_step:
            raise ValueError(
                "flat_buckets sizes the ragged flat layout's compiled "
                "widths; it requires use_ragged_step")
        if prefix_cache and not use_chunked_prefill:
            raise ValueError(
                "prefix caching requires chunked paged prefill "
                "(use_paged_kv=True, attention-only tiers): shared prefix "
                "blocks are matched and published at chunk boundaries, and "
                "the resumed prefill starts mid-prompt")
        self.prefix_cache = bool(prefix_cache)
        if speculation_k:
            if speculation_k < 0:
                raise ValueError("speculation_k must be >= 0")
            if m < 2:
                raise ValueError(
                    "speculative cascade decoding needs at least two "
                    "tiers: a cheap tier to draft and an expensive tier "
                    "to verify")
            if not self.ragged_step:
                raise ValueError(
                    "speculative cascade decoding requires the ragged "
                    "flat token-batch layout (use_ragged_step=True): the "
                    "verify pass scores k+1 positions per row through "
                    "the arbitrary-q_len work list")
            moe = [t.name for t in self.tiers[:-1]
                   if any(l.ffn.kind == "moe" for l in t.cfg.layers)]
            if moe:
                raise ValueError(
                    f"draft tier(s) {moe} have MoE layers: the draft "
                    "loop's masked rows would route and take expert "
                    "capacity")
        if spec_delta is not None and not speculation_k:
            raise ValueError(
                "spec_delta truncates staged drafts; it requires "
                "speculation_k > 0")
        self.speculation_k = int(speculation_k)
        self.spec_delta = None if spec_delta is None else float(spec_delta)
        if preemption_policy not in ("none", "youngest", "fewest-tokens"):
            raise ValueError(
                f"unknown preemption_policy {preemption_policy!r} "
                "(choose none / youngest / fewest-tokens)")
        if preemption_policy != "none" and not use_chunked_prefill:
            raise ValueError(
                "preemption requires the block-paged arena with chunked "
                "prefill: the replay path re-runs the victim's prefill "
                "through the idempotent chunk machinery")
        self.preemption_policy = preemption_policy
        if launch_retries < 0:
            raise ValueError("launch_retries must be >= 0")
        self.launch_retries = int(launch_retries)
        self.retry_backoff = float(retry_backoff)
        self.faults = faults
        self._transient = _transient_error_types()
        slots_per_tier = ([int(slots)] * m if np.isscalar(slots)
                          else [int(s) for s in slots])
        kv_blocks_per_tier = (
            [kv_blocks] * m if kv_blocks is None or np.isscalar(kv_blocks)
            else [None if b is None else int(b) for b in kv_blocks])
        if len(slots_per_tier) != m or len(kv_blocks_per_tier) != m:
            raise ValueError(
                f"per-tier sequences must match the {m} tiers: got "
                f"{len(slots_per_tier)} slots, "
                f"{len(kv_blocks_per_tier)} kv_blocks entries")
        if deltas is not None:
            gates = [GateSpec(delta=float(d)) for d in deltas]
        elif escalation_budget is not None:
            gates = [GateSpec(budget=float(escalation_budget))
                     for _ in range(m - 1)]
        else:
            gates = [GateSpec(delta=0.5) for _ in range(m - 1)]
        if len(gates) != m - 1:
            raise ValueError("one gate per non-final tier")

        self.prompt_len = prompt_len        # chunked: max prompt length
        self.gen_len = gen_len
        self.conf_reduce = conf_reduce
        self.prefill_chunk = min(prefill_chunk, prompt_len)
        self.prefill_token_budget = (
            prefill_token_budget if prefill_token_budget is not None
            else max(slots_per_tier) * self.prefill_chunk)
        self.metrics = ServingMetrics(
            [TierCost(t.name, t.flops_per_request(gen_len))
             for t in self.tiers], slots_per_tier)
        # the scheduler streams every gate decision into the metrics'
        # calibration telemetry; the engine streams the outcomes
        self.scheduler = CascadeScheduler(
            slots_per_tier, gates,
            shards_per_tier=[t.data_shards() for t in self.tiers],
            calibration=self.metrics.calibration)
        self.clock = clock if clock is not None else WallClock()
        self.tracer = tracer
        self.profile_annotations = bool(profile_annotations)
        self.tick_id = 0
        if tracer is not None:
            tracer.name_process(obs.ENGINE_PID, "engine ticks")
            # tid layout on the engine pid: one lane per tier, plus a
            # whole-tick umbrella lane at tid = num_tiers
            tracer.name_track(obs.ENGINE_PID, len(self.tiers), "tick")
            for i, t in enumerate(self.tiers):
                tracer.name_track(obs.ENGINE_PID, i, f"tier{i} {t.name}")
                tracer.name_process(obs.REQUEST_PID_BASE + i,
                                    f"requests tier{i} {t.name}")
        max_seq = prompt_len + gen_len
        if use_paged_kv:
            ppr = math.ceil(max_seq / kv_block_size)
            for spec, cap, nb in zip(self.tiers, slots_per_tier,
                                     kv_blocks_per_tier):
                if nb is not None and nb < cap * ppr + 1 \
                        and cache_lib.has_recurrent_state(spec.cfg):
                    raise ValueError(
                        f"tier {spec.name}: kv_blocks={nb} over-subscribes "
                        "the arena but the model carries recurrent state "
                        "(mamba/rwkv), which cannot replay a stalled "
                        "decode step — use full provisioning (kv_blocks="
                        "None)")
        self.runtimes = [
            _TierRuntime(spec, cap, prompt_len, max_seq, self.device,
                         block_size=kv_block_size,
                         kv_blocks=nb, prefill_chunk=self.prefill_chunk,
                         use_paged_kv=use_paged_kv,
                         use_chunked_prefill=self.chunked_prefill,
                         use_unified_step=self.unified_step,
                         use_ragged_step=self.ragged_step,
                         flat_buckets=flat_buckets,
                         prefix_cache=self.prefix_cache,
                         speculation_k=self.speculation_k,
                         spec_draft=(i < m - 1))
            for i, (spec, cap, nb) in enumerate(
                zip(self.tiers, slots_per_tier, kv_blocks_per_tier))]
        self.requests: List[Request] = []
        self._rid = 0
        # per-tier token-budget window state, reset each tick: tokens
        # charged (seeded with the tick's carried decode+chunk load) and
        # requests admitted (never-starve guard)
        self._budget_used = [0] * m
        self._admitted = [0] * m
        self.host_syncs = 0                 # blocking device->host fetches
        # the overload layer's state: whether any submit carried a
        # deadline (the shedding pass is off until one does), the
        # minimum observed tick duration (the shedding floor's unit), and
        # each tier's stalled rows in its last plan (drain diagnostics)
        self._has_deadlines = False
        self._min_tick_dt: Optional[float] = None
        self._last_tick_t: Optional[float] = None
        self._last_stalls = [0] * m

    # -- submission --------------------------------------------------------

    def submit(self, prompt, arrival_time: float = 0.0,
               deadline: Optional[float] = None) -> Request:
        """Queue one request: a 1D prompt of 1..prompt_len tokens under
        chunked prefill, of exactly prompt_len tokens under uniform
        prefill.  ``deadline`` (absolute, in the engine's clock domain)
        opts it into load shedding: the shedding pass rejects it
        (terminal ``SHED``) once the deadline has passed or provably
        cannot be met (see :meth:`_service_floor`)."""
        prompt = np.asarray(prompt, np.int32)
        if self.chunked_prefill:
            if prompt.ndim != 1 or not 1 <= prompt.shape[0] <= self.prompt_len:
                raise ValueError(
                    f"prompt must be 1D with 1..{self.prompt_len} tokens, "
                    f"got shape {prompt.shape}")
        elif prompt.shape != (self.prompt_len,):
            raise ValueError(
                f"prompt must be [{self.prompt_len}], got {prompt.shape} "
                "(the uniform packed prefill batches one prompt length; "
                "use chunked prefill for mixed lengths)")
        req = Request(rid=self._rid, prompt=prompt, gen_len=self.gen_len,
                      arrival_time=float(arrival_time),
                      deadline=None if deadline is None else float(deadline))
        self._rid += 1
        self.requests.append(req)
        self.scheduler.submit(req)
        self.metrics.record_submitted()
        if deadline is not None:
            self._has_deadlines = True
        if self.tracer is not None:
            self.tracer.request_transition(
                req.rid, "QUEUED", 0, prompt_tokens=req.prompt_tokens)
        return req

    # -- one engine tick ---------------------------------------------------

    def _fetch(self, tier: int, *tensors):
        """The tick's one blocking device->host transfer of every given
        tensor — tokens and confidences, and under speculation the verify
        windows, accepted counts and drafts; the split executor brings its
        chunk and decode picks together: integer tensors ride bit-cast as
        int32 beside the f32 ones in a single copy (counted overall and
        per tier).  Returns numpy arrays of the given shapes, in order.

        A data-sharded tier's values (:class:`Sharded`) come back with one
        asynchronous copy per shard into pinned host memory and one wait
        for them all (:func:`_to_host`), still one fetch; the shards join
        on the host.

        The copy runs under the retry wrapper as kind ``device_get``: a
        retry re-reads the same device tensors, so it is safe, and a CUDA
        fault of a kernel surfaces here (the first synchronisation) and
        propagates, since only an injected transient error is retried.
        When the retries run out the engine stops (:class:`_RetryExhausted`
        propagates): the tick's results are lost without the copy.
        Traced as the ``device_get`` phase: the device time the host waits
        for shows here."""
        self.host_syncs += 1
        self.metrics.record_host_sync(tier)
        tr = self.tracer
        t0 = tr.now_us() if tr is not None else 0.0
        shards = [t if isinstance(t, Sharded) else (t,) for t in tensors]
        flats = self._launch(tier, "device_get", lambda: _to_host([
            torch.cat([
                t.reshape(-1).to(torch.float32) if t.is_floating_point()
                else t.reshape(-1).to(torch.int32).view(torch.float32)
                for t in parts]) for parts in zip(*shards)]))
        if tr is not None:
            tr.phase("device_get", tier, t0, tick=self.tick_id)
        out = [[] for _ in tensors]
        for flat, parts in zip(flats, zip(*shards)):
            o = 0
            for k, t in enumerate(parts):
                part = flat[o:o + t.numel()]
                if not t.is_floating_point():
                    part = part.view(torch.int32)
                out[k].append(part.numpy().reshape(tuple(t.shape)))
                o += t.numel()
        return [x[0] if len(x) == 1 else np.concatenate(x) for x in out]

    def _launch(self, tier: int, kind: str, thunk):
        """Run one launch (or fetch) under bounded retry with backoff.  A
        transient failure (:func:`_transient_error_types`: an injected
        :class:`repro_torch.serving.faults.TransientError`) retries up to
        ``launch_retries`` times, sleeping ``retry_backoff`` seconds,
        doubling; any other exception propagates at once.  Exhaustion
        raises :class:`_RetryExhausted` for the call site to sacrifice a
        single victim request (:meth:`_fail_one`).

        Relaunching is safe although the port writes KV in place (a JAX
        launch is functional: its engine keeps the new cache only after
        the launch succeeds).  The injected error is raised in
        ``FaultPlan.pre_launch``, before the thunk runs, so a retried
        launch has written nothing; a relaunch after :meth:`_fail_one`
        rewrites the survivors' pages with the same values, and the
        victim's released pages map to the null block.  Every host-state
        change of a tick (``prefill_pos``, ``publish_prefix``, ``pos``,
        the emitted tokens) therefore stays after the wrapped launch: the
        plan is pure host data built before it."""
        delay = self.retry_backoff
        attempt = 0
        while True:
            try:
                if self.faults is not None:
                    self.faults.pre_launch(self.tick_id, tier, kind, attempt)
                return thunk()
            except self._transient as e:
                if self.tracer is not None:
                    self.tracer.instant("launch_retry", tier,
                                        tick=self.tick_id, kind=kind,
                                        attempt=attempt, error=str(e))
                if attempt >= self.launch_retries:
                    raise _RetryExhausted(kind, e) from e
                self.metrics.record_retry(tier)
                attempt += 1
                if delay > 0:
                    time.sleep(delay)
                    delay *= 2

    def _trace_req(self, req: Request, state: str, tier: int,
                   shard: Optional[int]) -> None:
        if self.tracer is not None:
            self.tracer.request_transition(req.rid, state, tier, shard,
                                           tick=self.tick_id)

    def _annotate(self, kind: str, rt: _TierRuntime):
        """The profiler range of one launch, ``<kind>/<tier name>``."""
        return obs.annotation(f"{kind}/{rt.spec.name}",
                              self.profile_annotations, rt.device)

    def _admit(self, tier: int, now: float) -> None:
        """Admission, traced as the tick's ``admit`` phase (the leading
        and the trailing pass emit one event each)."""
        tr = self.tracer
        if tr is None:
            return self._admit_requests(tier, now)
        t0 = tr.now_us()
        before = self.metrics.tier_requests[tier]
        self._admit_requests(tier, now)
        tr.phase("admit", tier, t0, tick=self.tick_id,
                 admitted=self.metrics.tier_requests[tier] - before)

    def _admit_requests(self, tier: int, now: float) -> None:
        """Bind rows one at a time, bounded by free rows, free KV blocks
        for the *first chunk* (later chunks grow lazily), and the tier's
        per-tick token budget.  The budget window is pre-charged with the
        tick's carried load (see :meth:`_tick_load`) and a new request
        bills only its first chunk; the window's first admitted request
        is always admitted, so a long prompt cannot starve.  Split tiers
        keep the JAX engine's legacy accounting instead: a window of
        prefill tokens only, starting at zero, each request billed its
        whole prompt.  With the prefix cache on, a request binds its
        longest cached prefix (:meth:`_pick_shard_prefix`), its prefill
        resumes at the first uncached token, and its bill skips the
        cached tokens.  No compute here — the token batch runs in
        :meth:`_tier_step`.  Uniform-prefill tiers admit and prefill in
        :meth:`_admit_uniform` instead."""
        rt = self.runtimes[tier]
        if not rt.chunked:
            return self._admit_uniform(tier, rt, now)
        fresh = 0
        while True:
            head = self.scheduler.peek(tier, now)
            if head is None:
                break
            plen = head.prompt_tokens
            # a preempted request being re-admitted replays work the
            # metrics already counted: its admission is not recorded
            # again (Eq 7 cost and the request count stay per request);
            # the replayed compute shows as replayed_tokens instead
            replay = head.state is RequestState.PREEMPTED
            shard, cached, pblocks = self._pick_shard_prefix(tier, rt, head)
            if shard is None:
                break               # no row, or no blocks for the chunk
            # admission billing skips the cached prefix entirely: unified
            # tiers charge the first *uncached* chunk, split tiers the
            # uncached suffix
            cost = ((lambda r, c=cached: min(rt.chunk, r.prompt_tokens - c))
                    if rt.unified else
                    (lambda r, c=cached: r.prompt_tokens - c)
                    if cached else None)
            reqs, slot_ids = self.scheduler.admit(
                tier, now, limit=1,
                token_budget=self.prefill_token_budget,
                budget_used=self._budget_used[tier],
                admitted_before=self._admitted[tier] if rt.unified else None,
                token_cost=cost, shard=shard)
            if not reqs:
                break               # over budget this tick
            req, slot = reqs[0], slot_ids[0]
            rt.pool.bind(slot, cached + min(rt.chunk, plen - cached),
                         row_tokens=plen + self.gen_len,
                         prefix=(cached, pblocks) if cached else None)
            rt.slot_req[slot] = req
            # chunked prefill resumes at the first uncached token
            rt.prefill_pos[slot] = cached
            self._trace_req(req, "PREFILL", tier, shard)
            if rt.prefix:
                self.metrics.record_prefix_lookup(tier, cached, plen)
                if self.tracer is not None:
                    self.tracer.prefix_cache_event(
                        tier, req.rid, cached, plen, tick=self.tick_id,
                        shard=shard)
            self._budget_used[tier] += (min(rt.chunk, plen - cached)
                                        if rt.unified else plen - cached)
            self._admitted[tier] += 1
            fresh += 0 if replay else 1
        if fresh:
            self.metrics.record_admission(tier, fresh)

    def _pick_shard(self, tier: int, rt: _TierRuntime,
                    ntokens: int) -> Optional[int]:
        """The data shard the next uniform admission should land on: a
        shard with a free request row whose block pool passes
        ``can_admit`` for the request's first pages, preferring the most
        free blocks (lowest shard id on ties).  None when no shard can
        take it."""
        alloc = self.scheduler.allocators[tier]
        best, best_free = None, -1
        for s in range(rt.data_shards):
            if alloc.free_in(s) == 0 or not rt.pool.can_admit(ntokens, s):
                continue
            free = rt.pool.blocks.free_in(s)
            if free > best_free:
                best, best_free = s, free
        return best

    def _pick_shard_prefix(self, tier: int, rt: _TierRuntime,
                           req: Request):
        """Chunked admission's shard choice plus the longest cached
        prefix there, as ``(shard, cached_tokens, blocks)``, as in the
        JAX engine.  Among shards with a free row whose pool passes
        ``can_admit``, prefer the longest prefix match, then the most free
        blocks (lowest shard id on ties); ``(None, 0, [])`` when no shard
        can take the request's first chunk.  A shard whose pool cannot
        take the request *with* its match (the pinned blocks stop being
        LRU-evictable) is retried without it, so caching never blocks an
        admission the uncached path would have made.  A shard's match is
        looked up only when it has a free row: a lookup touches the
        entry's LRU stamp."""
        alloc = self.scheduler.allocators[tier]
        plen = req.prompt_tokens
        best = None
        for s in range(rt.data_shards):
            if alloc.free_in(s) == 0:
                continue
            cached, blocks = (rt.pool.match_prefix(req.prompt, s)
                              if rt.prefix else (0, []))
            span = cached + min(rt.chunk, plen - cached)
            if not rt.pool.can_admit(span, s, cached=cached,
                                     prefix_blocks=blocks):
                if not cached or not rt.pool.can_admit(
                        min(rt.chunk, plen), s):
                    continue
                cached, blocks = 0, []
            key = (cached, rt.pool.blocks.free_in(s), -s)
            if best is None or key > best[0]:
                best = (key, s, cached, blocks)
        if best is None:
            return None, 0, []
        return best[1], best[2], best[3]

    def _admit_uniform(self, tier: int, rt: _TierRuntime,
                       now: float) -> None:
        """Uniform one-shot prefill admission: bind every request that
        fits — free rows, and on the paged arena the blocks of its whole
        prompt — then prefill them all in ONE launch over the
        ``[capacity, prompt_len]`` batch, scatter the part cache into the
        arena, and fetch their first tokens in a blocking fetch of its own
        (separate from the tick's decode fetch).  When the prefill
        launch's retries run out, the youngest admission fails (its row
        is not populated yet) and the rest relaunch."""
        if rt.paged:
            reqs, slot_ids = [], []
            while self.scheduler.peek(tier, now) is not None:
                shard = self._pick_shard(tier, rt, self.prompt_len)
                if shard is None:
                    break
                r, s = self.scheduler.admit(tier, now, limit=1, shard=shard)
                if not r:
                    break
                rt.pool.bind(s[0], self.prompt_len)
                reqs += r
                slot_ids += s
        else:
            reqs, slot_ids = self.scheduler.admit(tier, now)
        if not reqs:
            return
        self.metrics.record_admission(tier, len(reqs))
        self.metrics.record_prefill_tokens(
            len(reqs) * self.prompt_len, rt.capacity * self.prompt_len)
        tr = self.tracer
        t0 = tr.now_us() if tr is not None else 0.0
        while True:
            prompts = np.zeros((rt.capacity, self.prompt_len), np.int32)
            for i, req in enumerate(reqs):
                prompts[i] = req.prompt
            try:
                with self._annotate("run_prefill", rt):
                    parts, ftok, fconf, order = self._launch(
                        tier, "run_prefill",
                        lambda p=prompts, s=list(slot_ids):
                            rt.run_prefill(s, p))
                break
            except _RetryExhausted as e:
                req, slot = reqs.pop(), slot_ids.pop()
                req.fail(now)
                if rt.paged:
                    rt.pool.release(slot)
                self.scheduler.release(tier, slot)
                self.metrics.record_failed(tier)
                if tr is not None:
                    tr.request_done(req.rid, tier, None, state="FAILED",
                                    tick=self.tick_id, error=str(e))
                if not reqs:
                    return
        if tr is not None:
            tr.phase("launch", tier, t0, tick=self.tick_id, kind="prefill",
                     width=self.prompt_len)
        self.metrics.record_launches(tier, "prefill")
        for slots, part in parts:
            if rt.paged:
                rt.pool.write_prefill(slots, part, self.prompt_len)
            else:
                rt.pool.write_prefill(slots, part)
        del parts
        # timestamp with the post-compute clock, so TTFT includes prefill
        ftok, fconf = self._fetch(tier, ftok, fconf)
        t_emit = self.clock.now()
        for i, (req, slot) in zip(order, zip(reqs, slot_ids)):
            shard = rt.pool.shard_of(slot) if rt.paged else None
            self._trace_req(req, "PREFILL", tier, shard)
            req.start_decode(t_emit)
            self._trace_req(req, "DECODE", tier, shard)
            req.emit(int(ftok[i]), float(fconf[i]), t_emit)
            rt.slot_req[slot] = req
            rt.tok[slot] = ftok[i]
            rt.pos[slot] = self.prompt_len      # next decode writes here

    def _tick_load(self, rt: _TierRuntime) -> int:
        """Tokens the tier's live rows already claim this tick: one per
        decoding row plus each mid-prefill row's next chunk."""
        load = len(rt.decoding())
        for s in rt.prefilling():
            req = rt.slot_req[s]
            load += min(rt.chunk, req.prompt_tokens - int(rt.prefill_pos[s]))
        return load

    def _build_plan(self, rt: _TierRuntime) -> Optional[StepPlan]:
        """Plan one tier's tick on the host: which rows prefill a chunk,
        which decode a token, which stall — plus the flat token batch the
        launch consumes.  Rows denied KV blocks (over-subscribed arena)
        are marked ``KIND_STALL`` and retry next tick.  Page tables grow
        lazily here — prefill rows in slot order first, then decode rows
        oldest-bound-first.

        Under the split executor decode rows are only *listed*: their
        blocks grow in :meth:`_decode_launch`, after the chunk launch, as
        in the JAX engine, so an over-subscribed arena hands out blocks
        in the same order."""
        pre = rt.prefilling() if rt.chunked else []
        dec = rt.decoding()
        dr = rt.draft_slots() if rt.spec_draft else []
        if not pre and not dec and not dr:
            return None
        cap = rt.capacity
        kind = np.zeros(cap, np.int8)
        qlen = np.zeros(cap, np.int32)
        prefill_rows: List[int] = []
        finishing: List[int] = []
        chunks: List[tuple] = []              # (slot, chunk start, length)
        for s in pre:
            req = rt.slot_req[s]
            st = int(rt.prefill_pos[s])
            n = min(rt.chunk, req.prompt_tokens - st)
            if not rt.pool.ensure_blocks(s, st + n - 1):
                kind[s] = KIND_STALL          # replay the chunk next tick
                continue
            kind[s] = KIND_PREFILL
            qlen[s] = n
            prefill_rows.append(s)
            chunks.append((s, st, n))
            if st + n == req.prompt_tokens:
                finishing.append(s)
        decode_rows: List[int] = []
        verify_rows: List[tuple] = []
        draft_rows: List[int] = []
        draft_len = np.zeros(cap, np.int32)
        dentries: List[tuple] = []            # (slot, input tokens, pos0)
        if rt.unified:
            dec_set = set(dec)
            for s in rt.pool.bound_rows():
                if s not in dec_set:
                    continue
                req = rt.slot_req[s]
                p = int(rt.pos[s])
                # speculative verify: a decode row with staged drafts
                # scores its next token and every drafted position in one
                # ragged window (q_len = 1 + nd); its KV writes for
                # rejected positions are overwritten before they are read
                nd = 0
                if rt.spec_k and req.draft_tokens:
                    nd = max(0, min(len(req.draft_tokens), rt.spec_k,
                                    self.gen_len - len(req.tokens) - 1))
                if nd > 0 and not rt.pool.ensure_blocks(s, p + nd):
                    # window denied blocks: drop the drafts (the draft
                    # row re-drafts later) and fall back to plain decode
                    req.draft_tokens = []
                    req.draft_confs = []
                    nd = 0
                if nd == 0 and not rt.pool.ensure_blocks(s, p):
                    kind[s] = KIND_STALL      # stall: retry next tick
                    continue
                toks = [int(rt.tok[s])]
                if nd > 0:
                    toks += [int(t) for t in req.draft_tokens[:nd]]
                    verify_rows.append((s, nd))
                kind[s] = KIND_DECODE
                qlen[s] = len(toks)
                decode_rows.append(s)
                dentries.append((s, toks, p))
        else:
            decode_rows = list(dec)
            kind[dec] = KIND_DECODE
        for s in dr:
            # draft rows: catch up on the target request's emitted tokens
            # (this tier's own draft writes past them are rewritten by
            # the next catch-up before they are read), then draft up to
            # spec_k tokens ahead once caught up.  A row denied blocks
            # skips the tick; it never stalls the tier.
            req = rt.draft_req[s]
            if req.state is not RequestState.DECODE or req.draft_tokens:
                continue             # target mid-prefill / drafts pending
            base = req.prompt_tokens
            e = len(req.tokens)
            p0 = int(rt.pos[s])
            c = base + e - p0
            if c <= 0:
                continue             # caught up; wait for emissions
            n = min(c, rt.chunk)
            kd = 0
            if n == c:               # fully caught up after this chunk
                kd = max(0, min(rt.spec_k, self.gen_len - e - 1))
            if not rt.pool.ensure_blocks(s, max(p0 + n - 1,
                                                base + e + kd - 2)):
                continue
            kind[s] = KIND_DRAFT
            qlen[s] = n
            draft_len[s] = kd
            draft_rows.append(s)
            dentries.append(
                (s, [int(t) for t in req.tokens[p0 - base:p0 - base + n]],
                 p0))
        # batch width: the chunk when any prefill row survived its block
        # check, else the widest decode/verify/draft row (1 when every
        # row is a plain decode)
        width = rt.chunk if prefill_rows else 1
        if dentries:
            width = max(width, max(len(t) for _, t, _ in dentries))
        tokens = np.zeros((cap, width), np.int32)
        pos = np.zeros((cap, width), np.int32)
        for s, st, n in chunks:
            tokens[s, :n] = rt.slot_req[s].prompt[st:st + n]
            pos[s] = st + np.arange(width)    # row's q_start is pos[s, 0]
        # the split chunk launch carries no decode row (dentries empty)
        for s, toks, p0 in dentries:
            tokens[s, :len(toks)] = toks
            pos[s] = p0 + np.arange(width)
        flat_width = flat_tokens = flat_pos = q_start = flat_widths = None
        if rt.ragged:
            # flat packing: each data shard's live tokens concatenated in
            # slot order, padded up to the smallest bucket width that
            # holds them (padding scatters to the null block and emits
            # nothing); the shards' packings side by side
            flat_widths = [rt.bucket_width(int(qlen[rows].sum()))
                           for rows in rt.rows]
            flat_width = sum(flat_widths)
            flat_tokens = np.zeros((1, flat_width), np.int32)
            flat_pos = np.zeros((1, flat_width), np.int32)
            q_start = pos[:, 0].astype(np.int32).copy()
            base = 0
            for rows, w in zip(rt.rows, flat_widths):
                o = base
                for s in range(rows.start, rows.stop):
                    n = int(qlen[s])
                    if n:
                        flat_tokens[0, o:o + n] = tokens[s, :n]
                        flat_pos[0, o:o + n] = pos[s, :n]
                        o += n
                base += w
        return StepPlan(width=width, kind=kind, tokens=tokens, pos=pos,
                        q_len=qlen, prefill_rows=prefill_rows,
                        decode_rows=decode_rows, finishing=finishing,
                        flat_width=flat_width, flat_tokens=flat_tokens,
                        flat_pos=flat_pos, q_start=q_start,
                        verify_rows=verify_rows, draft_rows=draft_rows,
                        draft_len=draft_len, flat_widths=flat_widths)

    # -- overload: preemption, load shedding, single-request failure --------

    def _pick_victim(self, rt: _TierRuntime, shard: int) -> Optional[int]:
        """The row ``preemption_policy`` evicts on `shard` when the plan
        stalled there.  Never the shard's *oldest* bound row (the
        oldest-first reserve discipline guarantees its progress — that
        guarantee is the termination argument, and it is also why the
        preempt-and-replan loop cannot livelock) and never a row whose
        decode already finished (this tick's gate frees it anyway).
        None when no candidate remains."""
        rows = [s for s in rt.pool.bound_rows()
                if rt.pool.shard_of(s) == shard]
        cands = [s for s in rows[1:]
                 if rt.slot_req[s] is not None
                 and not rt.slot_req[s].decode_finished]
        if not cands:
            return None
        if self.preemption_policy == "youngest":
            return cands[-1]
        # fewest-tokens: least total progress (prefilled + decoded);
        # the reverse scan breaks ties toward the youngest binding
        return min(reversed(cands),
                   key=lambda s: int(rt.prefill_pos[s])
                   + len(rt.slot_req[s].tokens))

    def _preempt(self, tier: int, rt: _TierRuntime, slot: int,
                 now: float) -> None:
        """Evict `slot`'s request: discard its partial tier work, free
        its blocks (refcounted: pages its prefix entries hold stay
        indexed, and the replay re-matches them) and its row, and
        re-queue it at the *head* of the tier's queue.  Re-admission
        replays prefill and decode from scratch; greedy decode is
        deterministic, so the replayed stream is the same (the emit-side
        ``first_token_time`` guard keeps TTFT at the original
        emission)."""
        req = rt.slot_req[slot]
        shard = rt.pool.shard_of(slot)
        replayed = int(rt.prefill_pos[slot]) + len(req.tokens)
        self._release_draft(req)        # replay restarts decode: any
        req.preempt(now)                # retained draft row is stale
        rt.slot_req[slot] = None
        rt.tok[slot] = 0
        rt.pos[slot] = 0
        rt.prefill_pos[slot] = 0
        rt.pool.release(slot)
        self.scheduler.release(tier, slot)
        self.scheduler.requeue(req, tier)
        self.metrics.record_preemption(tier, replayed)
        self._trace_req(req, "PREEMPTED", tier, shard)

    def _preempt_stalled(self, tier: int, rt: _TierRuntime,
                         plan: Optional[StepPlan],
                         now: float) -> Optional[StepPlan]:
        """Trade stalls for evictions: while the plan has stalled rows
        and a stalled shard holds a victim, preempt one row and re-plan
        (the pool has one shard, so the shard loop visits shard 0).
        Draft rows go first: dropping one costs only speculative work.
        Terminates — every pass unbinds a row, and re-planning only ever
        *frees* blocks — and cannot starve the tier, since the shard's
        oldest row is exempt and therefore always progresses."""
        while plan is not None:
            stalled = [s for s in range(rt.capacity)
                       if plan.kind[s] == KIND_STALL]
            if not stalled:
                return plan
            shards = sorted({rt.pool.shard_of(s) for s in stalled})
            drafts = [s for s in rt.draft_slots()
                      if rt.pool.shard_of(s) in shards]
            if drafts:
                self._release_draft(rt.draft_req[drafts[-1]])
                plan = self._build_plan(rt)
                continue
            victim = None
            for shard in shards:
                victim = self._pick_victim(rt, shard)
                if victim is not None:
                    break
            if victim is None:
                return plan             # nothing evictable: stalls stand
            self._preempt(tier, rt, victim, now)
            plan = self._build_plan(rt)
        return plan

    def _fail_one(self, tier: int, rt: _TierRuntime, rows: Sequence[int],
                  now: float, err: Exception) -> int:
        """Retry exhaustion sacrifices ONE request so the run survives:
        the youngest-bound row among `rows` (the highest row on a dense
        arena, whose binding order is not tracked) fails terminally and
        frees its row and blocks; the caller re-plans and relaunches for
        the survivors.  Returns the victim row."""
        if rt.paged:
            order = {s: i for i, s in enumerate(rt.pool.bound_rows())}
            victim = max(rows, key=lambda s: order.get(s, -1))
        else:
            victim = max(rows)
        req = rt.slot_req[victim]
        shard = rt.pool.shard_of(victim) if rt.paged else None
        self._release_draft(req)
        req.fail(now)
        rt.slot_req[victim] = None
        rt.tok[victim] = 0
        rt.pos[victim] = 0
        rt.prefill_pos[victim] = 0
        if rt.paged:
            rt.pool.release(victim)
        self.scheduler.release(tier, victim)
        self.metrics.record_failed(tier)
        if self.tracer is not None:
            self.tracer.request_done(req.rid, tier, shard, state="FAILED",
                                     tick=self.tick_id, error=str(err))
        return victim

    def _shed(self, tier: int, now: float) -> None:
        """The load-shedding pass (nothing to do until a submitted
        request carries a deadline): reject queued requests of `tier`
        whose deadline has passed or provably cannot be met."""
        if not self._has_deadlines:
            return
        for req in self.scheduler.shed(tier, now, self._service_floor(tier)):
            self._release_draft(req)    # escalated-then-shed requests
            req.shed(now)               # may hold a cheap-tier row
            self.metrics.record_shed(tier)
            if self.tracer is not None:
                self.tracer.request_done(req.rid, tier, None, state="SHED",
                                         tick=self.tick_id)

    def _service_floor(self, tier: int):
        """A per-request lower bound on remaining service time at `tier`
        (None until a tick duration has been observed, so only
        already-expired deadlines shed): the fewest ticks to finish —
        ``ceil(prompt / chunk)`` prefill ticks plus ``gen_len - 1``
        decode ticks, minus one because the final chunk emits the first
        token in its own tick — times the *minimum* observed tick
        duration.  A true lower bound: queue wait, stalls, preemption
        replays and escalation only add to it."""
        dt = self._min_tick_dt
        if dt is None or dt <= 0:
            return None
        rt = self.runtimes[tier]
        if rt.chunked:
            return lambda r: max(
                math.ceil(r.prompt_tokens / rt.chunk)
                + self.gen_len - 2, 0) * dt
        return lambda r: (self.gen_len - 1) * dt

    def _drain_diagnostics(self) -> str:
        """Per-tier state for the did-not-drain RuntimeError: queue
        depth, live rows, the last plan's stalled rows and the free
        blocks — enough to tell block starvation from a scheduling bug."""
        lines = []
        for t, rt in enumerate(self.runtimes):
            line = (f"tier {t} ({rt.spec.name}): "
                    f"queued={len(self.scheduler.queues[t])} "
                    f"live_rows={len(rt.occupied())} "
                    f"stalled_rows={self._last_stalls[t]}")
            if rt.paged:
                shards = range(rt.pool.data_shards)
                line += (" free_blocks_by_shard="
                         f"{[rt.pool.blocks.free_in(s) for s in shards]}")
                held = [rt.pool.blocks.reserved_in(s) for s in shards]
                if any(held):
                    line += f" withheld_by_shard={held}"
                if rt.prefix:
                    ents = [rt.pool.prefix_index_entries(s) for s in shards]
                    line += (f" prefix_entries_by_shard={ents}"
                             " evictable_by_shard="
                             f"{[rt.pool.evictable_in(s) for s in shards]}")
            lines.append(line)
        return "; ".join(lines)

    def _tier_step(self, tier: int, now: float) -> int:
        """One tier's compute for a tick: plan on the host (trading stalls
        for preemptions under a policy), then the unified (ragged or
        padded) or the split executor.  Returns the number of decode
        tokens emitted."""
        rt = self.runtimes[tier]
        tr = self.tracer
        t0 = tr.now_us() if tr is not None else 0.0
        plan = self._build_plan(rt)
        if self.preemption_policy != "none" and rt.chunked:
            plan = self._preempt_stalled(tier, rt, plan, now)
        self._last_stalls[tier] = (
            0 if plan is None else int((plan.kind == KIND_STALL).sum()))
        if plan is not None and tr is not None:
            tr.phase("plan", tier, t0, tick=self.tick_id, width=plan.width,
                     prefill_rows=len(plan.prefill_rows),
                     decode_rows=len(plan.decode_rows),
                     stalled=self._last_stalls[tier])
        if plan is None:
            return 0
        if rt.unified:
            return self._exec_unified(tier, rt, plan, now)
        return self._exec_split(tier, rt, plan, now)

    def _exec_unified(self, tier: int, rt: _TierRuntime,
                      plan: StepPlan, now: float) -> int:
        """ONE launch serves every live row — each contributes its next
        prefill chunk or its single decode token, packed flat (ragged) or
        in a padded ``[capacity, width]`` batch — and one blocking fetch
        brings back every emitted (token, confidence) pair.  A row
        finishing prefill emits its first token from its last-slot
        logits.  Mid-prompt-only ticks skip the fetch; ticks where every
        live row stalled skip the launch too.

        Under speculation the launch is :meth:`_TierRuntime.run_spec`,
        whose draft loop runs ``max(draft_len) - 1`` decode steps (none
        when no row drafts): a verify row emits its accepted drafts and
        the verifier's next token, a drafting row stages its drafts on
        its target request, truncated at the first one below
        ``spec_delta`` (default: this tier's gate δ).

        The launch runs under the retry wrapper before any host state
        advances; when its retries run out one victim fails (a draft-only
        launch drops its drafts instead), the tier re-plans and the
        launch runs again for the survivors."""
        spec = None
        tr = self.tracer
        name = ("run_spec" if rt.spec_k else "run_ragged" if rt.ragged
                else "run_mixed")
        while True:
            if not plan.prefill_rows and not plan.decode_rows \
                    and not plan.draft_rows:
                return 0                # every live row stalled
            t0 = tr.now_us() if tr is not None else 0.0
            try:
                with self._annotate(name, rt):
                    if rt.spec_k:
                        spec, steps = self._launch(
                            tier, name, lambda p=plan: rt.run_spec(
                                p.flat_tokens, p.flat_pos, p.q_len,
                                p.q_start, p.draft_len, p.flat_widths))
                        tok, conf = spec["tok"], spec["conf"]
                        processed, kind = plan.flat_width, "spec"
                    elif rt.ragged:
                        tok, conf = self._launch(
                            tier, name, lambda p=plan: rt.run_ragged(
                                p.flat_tokens, p.flat_pos, p.q_len,
                                p.q_start, p.flat_widths))
                        processed, kind = plan.flat_width, "ragged"
                    else:
                        tok, conf = self._launch(
                            tier, name, lambda p=plan: rt.run_mixed(
                                p.tokens, p.pos, p.q_len))
                        processed, kind = rt.capacity * plan.width, "mixed"
                break
            except _RetryExhausted as e:
                rows = plan.prefill_rows + plan.decode_rows
                if rows:
                    self._fail_one(tier, rt, rows, now, e)
                else:
                    # a draft-only launch exhausted its retries: drop the
                    # speculation (the targets just decode normally)
                    for s in plan.draft_rows:
                        self._release_draft(rt.draft_req[s])
                plan = self._build_plan(rt)
                if plan is None:
                    return 0
        if tr is not None:
            # asynchronous dispatch: this phase is the host's launch cost
            # (the copy of the plan included); device time shows under
            # device_get
            tr.phase("launch", tier, t0, tick=self.tick_id,
                     kind="ragged" if rt.ragged else "mixed",
                     width=plan.flat_width if rt.ragged else plan.width)
        if rt.spec_k:
            self.metrics.record_draft_steps(tier, steps)
        self.metrics.record_launches(tier, kind)
        # live vs processed token slots: the ragged launch computes its
        # bucket width, the padded one capacity * width
        self.metrics.record_step_tokens(tier, plan.live_tokens, processed)
        if plan.prefill_rows:
            self.metrics.record_prefill_tokens(
                plan.live_prefill_tokens,
                plan.live_prefill_tokens if rt.ragged else processed)
        # host state advances on host-known lengths only
        for s in plan.prefill_rows:
            rt.prefill_pos[s] += int(plan.q_len[s])
            if rt.prefix:
                # the launch above scattered this chunk's KV: completed
                # chunk boundaries are now publishable prefix entries
                rt.pool.publish_prefix(s, rt.slot_req[s].prompt,
                                       int(rt.prefill_pos[s]))
        t_dec = self.clock.now()
        for s in plan.finishing:
            req = rt.slot_req[s]
            req.start_decode(t_dec)
            self._trace_req(req, "DECODE", tier, rt.pool.shard_of(s))
            rt.pos[s] = req.prompt_tokens   # next decode writes here
        for s in plan.draft_rows:
            # catch-up advances on host-known lengths, like prefill
            rt.pos[s] += int(plan.q_len[s])
        drafting = [s for s in plan.draft_rows if plan.draft_len[s] > 0]
        if not plan.finishing and not plan.decode_rows and not drafting:
            return 0            # mid-prompt chunks / pure catch-up only
        names = ["tok", "conf"]
        if plan.verify_rows:
            names += ["spec_tok", "spec_conf", "acc_len"]
        if drafting:
            names += ["draft_tok", "draft_conf"]
        dev = {"tok": tok, "conf": conf, **(spec or {})}
        got = dict(zip(names, self._fetch(tier, *(dev[n] for n in names))))
        tok, conf = got["tok"], got["conf"]
        t_emit = self.clock.now()           # post-compute
        ver = dict(plan.verify_rows)
        for s in plan.finishing + plan.decode_rows:
            req = rt.slot_req[s]
            nd = ver.get(s, 0)
            if not nd:
                req.emit(int(tok[s]), float(conf[s]), t_emit)
                rt.tok[s] = tok[s]
                continue
            # greedy speculative acceptance: emit the verifier's argmax
            # at every accepted position plus the next one — argmaxes
            # only, so the stream equals non-speculative decode's
            acc = min(int(got["acc_len"][s]), nd)
            for j in range(acc + 1):
                req.emit(int(got["spec_tok"][s, j]),
                         float(got["spec_conf"][s, j]), t_emit)
            rt.tok[s] = got["spec_tok"][s, acc]
            rt.pos[s] += acc + 1
            self.metrics.record_speculation(tier, nd, acc)
            # per-token agreement for the draft tier's gate: every
            # verified draft up to and including the first rejection
            # (past it the drafts' context is already wrong)
            for j in range(min(acc + 1, nd)):
                self.metrics.calibration.record_verify_outcome(
                    tier - 1, float(req.draft_confs[j]), j < acc)
            req.draft_tokens = []
            req.draft_confs = []
        for s in plan.decode_rows:
            if s not in ver:
                rt.pos[s] += 1
        if drafting:
            # stage the drafts on their target requests (the next tier
            # verifies them later this tick), truncated at the first
            # token the gate distrusts
            thr = (self.spec_delta if self.spec_delta is not None
                   else self.scheduler.delta(tier))
            dtok, dconf = got["draft_tok"], got["draft_conf"]
            for s in drafting:
                keep = 0
                while (keep < plan.draft_len[s]
                       and float(dconf[s, keep]) >= thr):
                    keep += 1
                req = rt.draft_req[s]
                req.draft_tokens = [int(x) for x in dtok[s, :keep]]
                req.draft_confs = [float(x) for x in dconf[s, :keep]]
        return len(plan.decode_rows)

    def _exec_split(self, tier: int, rt: _TierRuntime,
                    plan: StepPlan, now: float) -> int:
        """Split execution: the chunk launch over the prefill rows, then
        the decode launch — rows whose final chunk completed decode in the
        same tick, their first token flowing into the decode input on the
        device — then ONE blocking fetch for both result pairs.  Two
        launches on mixed ticks, which the unified executors fuse.  When
        the chunk launch's retries run out one victim fails and the tick
        restarts for the survivors (the failed launch advanced no host
        state)."""
        pf = None
        tr = self.tracer
        if plan.prefill_rows:
            t0 = tr.now_us() if tr is not None else 0.0
            try:
                with self._annotate("run_chunk", rt):
                    tok, conf = self._launch(
                        tier, "run_chunk", lambda: rt.run_chunk(
                            plan.tokens, plan.pos, plan.q_len))
            except _RetryExhausted as e:
                self._fail_one(tier, rt,
                               plan.prefill_rows + plan.decode_rows, now, e)
                plan = self._build_plan(rt)
                if plan is None:
                    return 0
                return self._exec_split(tier, rt, plan, now)
            if tr is not None:
                tr.phase("launch", tier, t0, tick=self.tick_id,
                         kind="chunk", width=plan.width)
            processed = rt.capacity * plan.width
            self.metrics.record_launches(tier, "chunk")
            self.metrics.record_prefill_tokens(plan.live_prefill_tokens,
                                               processed)
            self.metrics.record_step_tokens(tier, plan.live_prefill_tokens,
                                            processed)
            for s in plan.prefill_rows:
                rt.prefill_pos[s] += int(plan.q_len[s])
                if rt.prefix:
                    rt.pool.publish_prefix(s, rt.slot_req[s].prompt,
                                           int(rt.prefill_pos[s]))
            t_dec = self.clock.now()
            for s in plan.finishing:
                req = rt.slot_req[s]
                req.start_decode(t_dec)
                self._trace_req(req, "DECODE", tier, rt.pool.shard_of(s))
                rt.pos[s] = req.prompt_tokens   # next decode writes here
            pf = {"tok": tok, "conf": conf, "finished": plan.finishing}
        dc = self._decode_launch(tier, rt, pf, now)
        emit_first = pf is not None and bool(pf["finished"])
        if not emit_first and dc is None:
            return 0
        pairs = ([pf["tok"], pf["conf"]] if emit_first else []) + \
            ([dc["tok"], dc["conf"]] if dc is not None else [])
        fetched = self._fetch(tier, *pairs)
        t_emit = self.clock.now()           # post-compute
        if emit_first:
            ptok, pconf = fetched[:2]
            for s in pf["finished"]:
                req = rt.slot_req[s]
                if req is None:
                    continue    # failed mid-tick (decode retry exhaustion)
                req.emit(int(ptok[s]), float(pconf[s]), t_emit)
                rt.tok[s] = ptok[s]
        if dc is None:
            return 0
        ntok, nconf = fetched[-2:]
        for s in dc["active"]:
            rt.slot_req[s].emit(int(ntok[s]), float(nconf[s]), t_emit)
            rt.tok[s] = ntok[s]
            rt.pos[s] += 1
        return len(dc["active"])

    def _decode_launch(self, tier: int, rt: _TierRuntime,
                       pf: Optional[dict], now: float) -> Optional[dict]:
        """The split executor's decode launch over every row.  Rows whose
        final chunk completed this tick take their first token from the
        chunk launch's device output.  Page tables grow here, oldest row
        first; a row denied a block stalls (its write lands in the null
        block, its output is discarded) and retries next tick.  The dense
        arena has every row's positions already.  When the launch's
        retries run out one active row fails and the launch runs again
        for the rest: the victim's page-table row is unmapped by then, so
        its write lands in the null block."""
        decoding = rt.decoding()
        finished = pf["finished"] if pf is not None else []
        if finished:
            # a finishing row's first token is still on the device, so it
            # looks one emit behind `decode_finished`: drop the rows that
            # first token already completes (gen_len == 1)
            decoding = [s for s in decoding if s not in finished
                        or len(rt.slot_req[s].tokens) + 1
                        < rt.slot_req[s].gen_len]
        if not decoding:
            return None
        if rt.paged:
            dec = set(decoding)
            active = [s for s in rt.pool.bound_rows()
                      if s in dec and rt.pool.ensure_blocks(s,
                                                            int(rt.pos[s]))]
            if not active:
                return None
        else:
            active = decoding
        # rows mid-prefill share the decode batch but must not touch their
        # partly filled pages: the launch's page-table copy unmaps them
        tr = self.tracer
        while True:
            t0 = tr.now_us() if tr is not None else 0.0
            try:
                with self._annotate("run_step", rt):
                    tok, conf = self._launch(
                        tier, "run_step", lambda: rt.run_step(
                            rt.tok, mask_rows=rt.prefilling(),
                            first=pf["tok"] if finished else None,
                            fresh=finished))
                break
            except _RetryExhausted as e:
                victim = self._fail_one(tier, rt, active, now, e)
                active = [s for s in active if s != victim]
                if not active:
                    return None
        if tr is not None:
            tr.phase("launch", tier, t0, tick=self.tick_id, kind="decode",
                     width=1)
        self.metrics.record_launches(tier, "step")
        self.metrics.record_step_tokens(tier, len(active), rt.capacity)
        return {"active": active, "tok": tok, "conf": conf}

    def _finish(self, tier: int, now: float) -> None:
        """Gate the finished rows, traced as the tick's ``finish``
        phase."""
        tr = self.tracer
        if tr is None:
            self._finish_requests(tier, now)
            return
        t0 = tr.now_us()
        done, esc = self._finish_requests(tier, now)
        tr.phase("finish", tier, t0, tick=self.tick_id, completed=done,
                 escalated=esc)

    def _finish_requests(self, tier: int, now: float):
        """Gate every row whose decode finished: escalate it to the next
        tier's queue or complete it, and free its row and blocks — except
        that under speculation an escalated request's row stays bound as
        its draft row.  A completed escalated request streams its
        escalation outcomes into the calibration telemetry.  An
        escalation storm of the fault plan forces this gate's decisions
        for the tick (forced decisions still stream into the gate stats
        and the calibration telemetry like real ones)."""
        rt = self.runtimes[tier]
        last = tier == len(self.tiers) - 1
        forced = (None if last or self.faults is None
                  else self.faults.force_escalation(self.tick_id, tier))
        done = esc = 0
        for slot in rt.occupied():
            req = rt.slot_req[slot]
            if not (req.state is RequestState.DECODE and req.decode_finished):
                continue
            seq_conf = req.gate(self.conf_reduce)
            if not last and self.scheduler.gate_decision(tier, seq_conf,
                                                         force=forced):
                req.escalate(now)
                self.scheduler.push_escalated(req)
                # span on the *next* tier's track: queued for escalation
                self._trace_req(req, "ESCALATED", tier + 1, None)
                esc += 1
                if rt.spec_draft:
                    # keep the row as the request's draft row: its prompt
                    # KV is resident, so this tier can catch up on the
                    # next tier's emissions and draft ahead.  The row
                    # changes role, not owner (no pool or scheduler
                    # release).
                    self._release_draft(req)    # M>2: drop the older row
                    rt.draft_req[slot] = req
                    rt.slot_req[slot] = None
                    rt.tok[slot] = 0
                    rt.pos[slot] = req.prompt_tokens  # rewind: replay the
                    rt.prefill_pos[slot] = 0          # target's emissions
                    req.draft_tier = tier
                    req.draft_slot = slot
                    continue
            else:
                # post-compute time: the final decode step belongs to this
                # request's latency (`now` was sampled at step start)
                req.complete(self.clock.now())
                self._release_draft(req)
                self.metrics.record_completion(req)
                if req.tier > 0:
                    # the escalation outcome: did the tiers agree?
                    self.metrics.record_gate_outcomes(req)
                if self.tracer is not None:
                    self.tracer.request_done(
                        req.rid, tier,
                        rt.pool.shard_of(slot) if rt.paged else None,
                        tick=self.tick_id)
                done += 1
            rt.slot_req[slot] = None
            rt.tok[slot] = 0
            rt.pos[slot] = 0
            rt.prefill_pos[slot] = 0
            if rt.paged:
                rt.pool.release(slot)
            self.scheduler.release(tier, slot)
        return done, esc

    def _release_draft(self, req: Request) -> None:
        """Free `req`'s retained draft row, if any, and clear its staged
        drafts.  Idempotent; called on every terminal path (completion)
        and when a request escalates again (more than two tiers)."""
        req.draft_tokens = []
        req.draft_confs = []
        if req.draft_slot is None:
            return
        drt = self.runtimes[req.draft_tier]
        s = req.draft_slot
        drt.draft_req[s] = None
        drt.tok[s] = 0
        drt.pos[s] = 0
        drt.prefill_pos[s] = 0
        # refcounted: pages shared with the prefix index stay live
        drt.pool.release(s)
        self.scheduler.release(req.draft_tier, s)
        req.draft_tier = None
        req.draft_slot = None

    def step(self, now: Optional[float] = None) -> None:
        now = self.clock.now() if now is None else now
        self.tick_id += 1
        if self.faults is not None:
            self.faults.begin_tick(self.tick_id, self)
        # minimum observed tick duration: the unit of the shedding pass's
        # service-time floor (constant under a VirtualClock, so the floor
        # is exact there)
        if self._last_tick_t is not None:
            d = now - self._last_tick_t
            if d > 0 and (self._min_tick_dt is None
                          or d < self._min_tick_dt):
                self._min_tick_dt = d
        self._last_tick_t = now
        tr = self.tracer
        tick_t0 = tr.now_us() if tr is not None else 0.0
        # open each tier's token-budget window: unified tiers pre-charge
        # the tick's carried decode+chunk load (one currency), split tiers
        # start the legacy prefill-only window at zero
        self._budget_used = [self._tick_load(rt) if rt.unified else 0
                             for rt in self.runtimes]
        self._admitted = [0] * len(self.tiers)
        active = []
        # the tick's profiler range, tick/<tick_id>: the join key between
        # a profiler trace and the host tracer's events
        with obs.step_annotation(self.tick_id, self.profile_annotations,
                                 self.device):
            for tier in range(len(self.tiers)):
                self._shed(tier, now)
                self._admit(tier, now)
                active.append(self._tier_step(tier, now))
                self._finish(tier, now)
            # trailing admission pass: requests escalated this tick enter
            # the next tier's rows immediately (their prefill starts next
            # tick)
            for tier in range(len(self.tiers)):
                self._admit(tier, now)
        if tr is not None:
            for t, rt in enumerate(self.runtimes):
                tr.counter(f"queue depth/{rt.spec.name}",
                           len(self.scheduler.queues[t]), tid=t)
                tr.counter(f"live rows/{rt.spec.name}",
                           len(rt.occupied()), tid=t)
            tr.phase("tick", len(self.tiers), tick_t0, tick=self.tick_id,
                     t_engine=now)
        self.metrics.record_step(active, now)
        self.metrics.sync_gate_stats(self.scheduler.gate_stats)

    # -- run loop ----------------------------------------------------------

    def _any_occupied(self) -> bool:
        return any(rt.occupied() for rt in self.runtimes)

    def _done(self) -> bool:
        return self.scheduler.pending == 0 and not self._any_occupied()

    def memory_stats(self) -> List[dict]:
        """Per-tier KV arena accounting: block geometry, arena bytes,
        high-water blocks and bytes actually mapped (paged: overall and
        per data shard), and what the dense one-row-per-request arena
        would allocate.  Byte figures are a device's: over a model axis,
        one model shard's KV heads of each block."""
        return [dict(tier=rt.spec.name, **rt.pool.memory_stats())
                for rt in self.runtimes]

    def mesh_topology(self) -> List[dict]:
        """Per-tier mesh layout, as the JAX engine records it (``mesh``
        None for an unmeshed tier): axis sizes, device count and indices
        (``torch.device.index``: None on the CPU), data shard count, and
        whether params are tensor-sharded (``TierSpec.shard_params``)."""
        out = []
        for rt in self.runtimes:
            if rt.mesh is None:
                out.append({"tier": rt.spec.name, "mesh": None,
                            "devices": 1, "data_shards": 1})
                continue
            out.append({
                "tier": rt.spec.name,
                "mesh": {a: int(n) for a, n in rt.mesh.shape.items()},
                "devices": int(rt.mesh.devices.size),
                "device_ids": [d.index for d in rt.mesh.devices.flat],
                "data_shards": rt.data_shards,
                "shard_params": bool(rt.spec.shard_params),
            })
        return out

    def reset_clock(self) -> None:
        """Restart the clock at t=0 (after set-up, before timed
        requests)."""
        self.clock.reset()

    def warmup(self) -> None:
        """Run each tier's launches once with all rows idle (the dummy
        writes land in the null block, or in rows that admission
        overwrites) — the ragged step at every bucket width (the
        speculative one, with no draft step, under speculation), the
        padded step at the chunk width and at width 1, the split chunk
        and decode launches, or the uniform prefill and decode launches,
        each on every data shard — so the allocator and the
        matrix-product heuristics are warm before the clock starts; waits
        for every device the tiers use, and ends by resetting the
        clock."""
        for rt in self.runtimes:
            zr = np.zeros(rt.capacity, np.int32)
            if rt.ragged:
                for w in rt.flat_buckets:
                    z = np.zeros((1, w * rt.data_shards), np.int32)
                    if rt.spec_k:
                        rt.run_spec(z, z, zr, zr, zr, [w] * rt.data_shards)
                    else:
                        rt.run_ragged(z, z, zr, zr, [w] * rt.data_shards)
            elif rt.unified:
                for w in dict.fromkeys((rt.chunk, 1)):
                    z = np.zeros((rt.capacity, w), np.int32)
                    rt.run_mixed(z, z, zr)
            else:
                if rt.chunked:
                    z = np.zeros((rt.capacity, rt.chunk), np.int32)
                    rt.run_chunk(z, z, zr)
                else:
                    # one row a shard, so that every shard prefills
                    span = rt.rows[0].stop
                    rt.run_prefill(
                        list(range(0, rt.capacity, span)),
                        np.zeros((rt.data_shards, self.prompt_len),
                                 np.int32))
                rt.run_step(zr)
        for dev in {d for rt in self.runtimes for d in (
                rt.mesh.devices.flat if rt.mesh is not None
                else rt.devices)}:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        self.reset_clock()

    def run(self, max_steps: int = 1_000_000, *,
            metrics_interval: Optional[float] = None,
            on_snapshot=None) -> dict:
        """Drive to completion; returns ``metrics.summary()``.
        ``metrics_interval`` hands a :meth:`ServingMetrics.snapshot` to
        ``on_snapshot`` every that many clock units (seconds, or ticks
        under a VirtualClock): the ``--metrics-interval`` CLI flag prints
        it as one line per window."""
        steps = 0
        next_snap = (self.clock.now() + metrics_interval
                     if metrics_interval else None)
        while not self._done():
            now = self.clock.now()
            if not self._any_occupied() and not any(
                    self.scheduler.admissible(t, now)
                    for t in range(len(self.tiers))):
                # idle: jump/sleep to the arrival of the queue head
                self.clock.wait_until(self.scheduler.queues[0][0].arrival_time)
                continue
            self.step(self.clock.now())
            self.clock.step_done()
            steps += 1
            if next_snap is not None and self.clock.now() >= next_snap:
                if on_snapshot is not None:
                    on_snapshot(self.metrics.snapshot(self.clock.now()))
                next_snap = self.clock.now() + metrics_interval
            if steps > max_steps:
                raise RuntimeError(
                    f"engine did not drain after {steps} steps (scheduler "
                    "stuck?): " + self._drain_diagnostics())
        return self.metrics.summary()
