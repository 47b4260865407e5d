"""Continuous-batching scheduler with confidence-gated escalation queues
(a copy of the JAX package's ``repro/serving/scheduler.py``: data-sharded
row allocators, requeue-on-preemption, load shedding and forced gate
decisions included).

One arrival queue feeds tier 0; each gate m owns an escalation queue
feeding tier m+1.  Every engine step the scheduler admits waiting requests
into free decode slots (continuous batching: admission happens mid-decode,
never waiting for the batch to drain), packing escalated requests densely
— the invariant is that after admission a tier never holds a free slot
while its queue has an admissible request.

δ per gate is either fixed, or derived online from an escalation *budget*
(:func:`repro_torch.core.server.delta_for_escalation_rate` over a sliding
window of observed confidences).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Callable, Deque, List, Optional, Sequence, Tuple

from repro_torch.core.server import GateStats, delta_for_escalation_rate
from repro_torch.serving.request import Request
from repro_torch.serving.slots import SlotAllocator


@dataclass
class GateSpec:
    """Gate configuration: fixed δ or an escalation budget.

    Exactly one of ``delta`` / ``budget`` should be set.  In budget mode δ
    is the ``budget``-quantile of the last ``window`` observed sequence
    confidences; until ``min_calibration`` confidences are seen the
    initial ``delta_init`` is used.
    """
    delta: Optional[float] = None
    budget: Optional[float] = None
    window: int = 512
    min_calibration: int = 4
    delta_init: float = 0.5

    def __post_init__(self):
        if (self.delta is None) == (self.budget is None):
            raise ValueError("set exactly one of delta / budget")


class CascadeScheduler:
    """Queues + slot accounting for an M-tier cascade."""

    def __init__(self, slots_per_tier: Sequence[int],
                 gates: Sequence[GateSpec],
                 shards_per_tier: Optional[Sequence[int]] = None,
                 calibration=None):
        num_tiers = len(slots_per_tier)
        if len(gates) != num_tiers - 1:
            raise ValueError("one gate per non-final tier")
        self.num_tiers = num_tiers
        # sharded serving: a tier on a mesh with D data shards partitions
        # its rows into D contiguous ranges; admission targets one shard
        shards = ([1] * num_tiers if shards_per_tier is None
                  else [int(s) for s in shards_per_tier])
        if len(shards) != num_tiers:
            raise ValueError("one shard count per tier")
        self.allocators = [SlotAllocator(c, d)
                           for c, d in zip(slots_per_tier, shards)]
        self.gates = list(gates)
        self.gate_stats = [GateStats() for _ in gates]
        # streaming calibration telemetry sink (observability.
        # GateCalibration, usually ServingMetrics.calibration): every
        # gate decision streams (confidence, escalated) into it; the
        # engine streams the outcomes separately.  None: off.
        self.calibration = calibration
        self._conf_windows: List[Deque[float]] = [
            deque(maxlen=g.window) for g in gates]
        # queue[0] = arrivals; queue[m>0] = escalations from gate m-1
        self.queues: List[Deque[Request]] = [deque()
                                             for _ in range(num_tiers)]
        # exact admission-token accounting: tokens admit() charged
        # against its budget windows, per tier (the one-currency ledger:
        # under unified execution each admission bills its first chunk,
        # so this is the admitted prefill work in budget currency)
        self.admitted_tokens = [0] * num_tiers

    # -- submission --------------------------------------------------------

    def submit(self, req: Request) -> None:
        self.queues[0].append(req)

    def push_escalated(self, req: Request) -> None:
        self.queues[req.tier + 1].append(req)

    def requeue(self, req: Request, tier: int) -> None:
        """Put a preempted request back at the *head* of `tier`'s queue:
        it was already admitted once, so it outranks later arrivals for
        re-admission (starvation guard for the replay path)."""
        self.queues[tier].appendleft(req)

    # -- load shedding -------------------------------------------------------

    def shed(self, tier: int, now: float,
             floor: Optional[Callable[[Request], float]] = None,
             ) -> List[Request]:
        """Remove and return queued requests of `tier` that are past —
        or provably unable to meet — their deadline.  A request sheds
        when ``max(now, arrival) + floor(request) > deadline``:
        ``floor`` is a lower bound on its remaining service time
        (0 when not provided, so only already-expired deadlines shed).
        Deadline-less requests never shed.  The caller owns the state
        transition (``Request.shed``) and the metrics."""
        q = self.queues[tier]
        if not q:
            return []
        shed: List[Request] = []
        kept: List[Request] = []
        for req in q:
            if req.deadline is not None and \
                    max(now, req.arrival_time) + \
                    (floor(req) if floor is not None else 0.0) \
                    > req.deadline:
                shed.append(req)
            else:
                kept.append(req)
        if shed:
            q.clear()
            q.extend(kept)
        return shed

    # -- admission (continuous batching) -----------------------------------

    def admissible(self, tier: int, now: float) -> bool:
        q = self.queues[tier]
        return bool(q) and (tier > 0 or q[0].arrival_time <= now)

    def peek(self, tier: int, now: float) -> Optional[Request]:
        """The queue head that :meth:`admit` would pop next (None if the
        queue is empty, not yet arrived, or the tier has no free slot).
        Lets the engine inspect prompt length / block demand before
        committing to the admission."""
        if not self.admissible(tier, now) \
                or self.allocators[tier].num_free == 0:
            return None
        return self.queues[tier][0]

    def admit(self, tier: int, now: float, limit: Optional[int] = None,
              token_budget: Optional[int] = None, budget_used: int = 0,
              token_cost=None, admitted_before: Optional[int] = None,
              shard: Optional[int] = None,
              ) -> Tuple[List[Request], List[int]]:
        """Pop requests into free slots of `tier` until either runs out.
        Returns the packed (requests, slot_ids) admitted this step.
        ``limit`` caps the number admitted (the block-paged KV arena may
        run out of blocks before the tier runs out of rows).
        ``token_budget`` caps the total *tokens* admitted in one budget
        window; ``budget_used`` carries tokens already charged against
        it (the engine admits one request per call, pre-charging the
        tick's carried load: one token per decoding row plus each
        mid-prefill row's next chunk — one currency).  ``token_cost``
        maps a request to its budget charge (default: its prompt length;
        the engine charges its first chunk, and with the prefix cache on
        subtracts the matched cached prefix first: cached tokens cost 0
        budget).  The window's first admitted
        request is always admitted even when over budget, so a prompt
        longer than the whole budget cannot starve: with
        ``admitted_before`` the guard keys on admissions, without it on
        ``budget_used == 0``.  ``shard`` pins the admission to one data
        shard's row range (the engine picks the shard whose KV block pool
        can hold the request); None lets the allocator balance shards."""
        reqs: List[Request] = []
        slots: List[int] = []
        used = budget_used
        alloc = self.allocators[tier]
        while self.admissible(tier, now) and alloc.free_in(shard) > 0 \
                and (limit is None or len(reqs) < limit):
            head = self.queues[tier][0]
            need = (head.prompt_tokens if token_cost is None
                    else token_cost(head))
            first = (used == 0 if admitted_before is None
                     else admitted_before + len(reqs) == 0)
            if token_budget is not None and not first \
                    and used + need > token_budget:
                break
            slot = alloc.alloc(shard)
            req = self.queues[tier].popleft()
            req.admit(tier, slot, now)
            reqs.append(req)
            slots.append(slot)
            used += need
        self.admitted_tokens[tier] += used - budget_used
        return reqs, slots

    def release(self, tier: int, slot: int) -> None:
        self.allocators[tier].free(slot)

    # -- gating ------------------------------------------------------------

    def delta(self, gate: int) -> float:
        g = self.gates[gate]
        if g.delta is not None:
            return g.delta
        win = self._conf_windows[gate]
        if len(win) < g.min_calibration:
            return g.delta_init
        return delta_for_escalation_rate(list(win), g.budget)

    def gate_decision(self, gate: int, seq_conf: float,
                      force: Optional[bool] = None) -> bool:
        """Record `seq_conf` at `gate`; True -> escalate to tier gate+1.
        ``force`` overrides the threshold comparison (fault injection:
        escalation storms simulate a miscalibrated gate) — the forced
        decision still streams into the stats, the confidence window and
        the calibration telemetry, exactly as a genuine one would."""
        delta = self.delta(gate)
        self._conf_windows[gate].append(seq_conf)
        st = self.gate_stats[gate]
        st.seen += 1
        escalate = seq_conf <= delta if force is None else bool(force)
        if escalate:
            st.escalated += 1
        if self.calibration is not None:
            self.calibration.record_gate(gate, seq_conf, escalate)
        return escalate

    # -- introspection -----------------------------------------------------

    @property
    def pending(self) -> int:
        return sum(len(q) for q in self.queues)

    def check_invariant(self, now: float) -> None:
        """Continuous-batching invariant: no tier has both a free slot and
        an admissible queued request (call after admission).  Holds for
        unbounded admission; a token-budget-limited tier may legitimately
        leave admissible requests queued past the budget (and a
        block-limited one past free KV blocks), so this is a test helper
        for fully-provisioned, budget-unconstrained runs."""
        for t in range(self.num_tiers):
            if self.allocators[t].num_free > 0 and self.admissible(t, now):
                raise AssertionError(
                    f"tier {t}: free slots with non-empty queue")
