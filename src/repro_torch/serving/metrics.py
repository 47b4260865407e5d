"""Serving metrics: latency percentiles, throughput, utilization, and the
paper's Eq 7 cost accounting (the torch port's copy of the JAX package's
``repro/serving/metrics.py``, with its prefix-cache and overload
blocks).

Cost convention (Eq 7)::

    cost/request  = Σ_m (N_m / N) · cost_m      N_m = requests reaching m
    always-exp    = Σ_m cost_m                  (escalate everything)
    always-fast   = cost_0
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.server import GateStats, ServerStats
# canonical definition lives in observability (shared with the
# calibration telemetry); re-exported here for its historical home
from repro_torch.serving.observability import (GateCalibration,  # noqa: F401
                                               length_bucket)
from repro_torch.serving.request import Request


def percentile(values: Sequence[float], q: float) -> float:
    if not values:
        return float("nan")
    return float(np.percentile(np.asarray(values, np.float64), q))


@dataclass
class TierCost:
    name: str
    flops_per_request: float


class ServingMetrics:
    """Aggregates per-request records + per-step occupancy counters."""

    def __init__(self, tiers: Sequence[TierCost],
                 slots_per_tier: Sequence[int]):
        self.tiers = list(tiers)
        self.slots_per_tier = list(slots_per_tier)
        n_gates = len(tiers) - 1
        self.stats = ServerStats(gates=[GateStats() for _ in range(n_gates)])
        self.latencies: List[float] = []
        self.ttfts: List[float] = []
        self.ttft_by_bucket: Dict[str, List[float]] = {}
        self.prompt_lens: List[int] = []
        self.tier_requests = [0] * len(tiers)   # N_m: requests reaching m
        self.busy_slot_steps = [0] * len(tiers)
        # live prompt tokens vs token slots the prefill launches processed
        self.prefill_live_tokens = 0
        self.prefill_processed_tokens = 0
        # per tier: live tokens each launch computed vs the token slots it
        # processed (its bucketed flat width, or capacity * width when
        # padded; the wasted-slot ratio is 1 - live/proc)
        self.step_live_tokens = [0] * len(tiers)
        self.step_processed_tokens = [0] * len(tiers)
        # one launch + one blocking device->host fetch per active tier per
        # tick is the unified executors' budget (split: two launches, one
        # fetch); launches also counted by kind per tier
        self.launches_by_tier = [0] * len(tiers)
        self.launches_by_kind = [dict() for _ in tiers]
        # ticks in which each tier launched anything, and this tick's flags
        self.active_ticks = [0] * len(tiers)
        self._launched = [False] * len(tiers)
        self.host_syncs_by_tier = [0] * len(tiers)
        # streaming gate-calibration telemetry: per-gate confidence
        # histograms + reliability bins fed by escalation and verify
        # outcomes (scheduler records decisions, engine records outcomes)
        self.calibration = GateCalibration(n_gates)
        # speculative cascade decoding, indexed by the *verify* tier:
        # drafted counts verified draft positions, accepted those the
        # scoring model's argmax confirmed (rolled_back = the rest, whose
        # provisional KV writes are overwritten before they are read)
        self.spec_drafted_by_tier = [0] * len(tiers)
        self.spec_accepted_by_tier = [0] * len(tiers)
        self.spec_rolled_back_by_tier = [0] * len(tiers)
        # decode steps of the draft loop, indexed by the *draft* tier
        self.spec_draft_steps_by_tier = [0] * len(tiers)
        # prefix-cache telemetry (the engine records one lookup per
        # chunked admission when the cache is on): hits are admissions
        # that mapped a cached prefix; cached tokens are prompt tokens
        # served from shared KV blocks — prefill work (and admission
        # budget) the cascade never paid
        self.prefix_lookups_by_tier = [0] * len(tiers)
        self.prefix_hits_by_tier = [0] * len(tiers)
        self.prefix_cached_tokens_by_tier = [0] * len(tiers)
        self.prefix_prompt_tokens_by_tier = [0] * len(tiers)
        # overload-and-failure accounting: submissions (conservation
        # denominator), deadline-shed and retry-failed requests per tier
        # they were queued for / running on, preemptions with the tokens
        # they discarded (prefilled prompt + generated tokens, all
        # recomputed at replay), and transient launch-attempt retries
        self.submitted = 0
        self.shed_by_tier = [0] * len(tiers)
        self.failed_by_tier = [0] * len(tiers)
        self.preemptions_by_tier = [0] * len(tiers)
        self.replayed_tokens_by_tier = [0] * len(tiers)
        self.retries_by_tier = [0] * len(tiers)
        # per-tick intervals in the engine's clock domain (seconds, or
        # ticks under a VirtualClock)
        self.tick_durations: List[float] = []
        self._last_step_time: Optional[float] = None
        self.steps = 0
        # throughput window: first arrival -> last completion (makespan)
        self.first_arrival: Optional[float] = None
        self.last_finish: Optional[float] = None

    # -- recording ---------------------------------------------------------

    def record_admission(self, tier: int, n: int = 1) -> None:
        self.tier_requests[tier] += n
        self.stats.cost += self.tiers[tier].flops_per_request * n
        if tier == 0:
            self.stats.requests += n

    def record_submitted(self, n: int = 1) -> None:
        """A request entered the system (the conservation denominator:
        at drain, submitted == completed + shed + failed)."""
        self.submitted += n

    def record_shed(self, tier: int, n: int = 1) -> None:
        """`n` queued requests rejected by the load-shedding pass."""
        self.shed_by_tier[tier] += n

    def record_failed(self, tier: int, n: int = 1) -> None:
        """`n` live requests sacrificed to exhausted launch retries."""
        self.failed_by_tier[tier] += n

    def record_preemption(self, tier: int, replayed_tokens: int) -> None:
        """One row evicted by the preemption policy; `replayed_tokens`
        counts the discarded work (prefilled prompt tokens + generated
        tokens) the replay will recompute."""
        self.preemptions_by_tier[tier] += 1
        self.replayed_tokens_by_tier[tier] += int(replayed_tokens)

    def record_retry(self, tier: int, n: int = 1) -> None:
        """`n` transient launch-attempt failures absorbed by the
        engine's bounded retry-with-backoff path."""
        self.retries_by_tier[tier] += n

    def record_step(self, active_per_tier: Sequence[int], now: float) -> None:
        self.steps += 1
        for t, n in enumerate(active_per_tier):
            self.busy_slot_steps[t] += n
            self.active_ticks[t] += self._launched[t]
        self._launched = [False] * len(self._launched)
        if self._last_step_time is not None and now >= self._last_step_time:
            self.tick_durations.append(now - self._last_step_time)
        self._last_step_time = now

    def record_gate_outcomes(self, req: Request) -> None:
        """Stream a completed *escalated* request's outcomes into the
        calibration telemetry: for each gate it crossed, did the next
        tier's token stream agree with the one the gate rejected?"""
        for g in range(req.tier):
            agree = req.tokens_by_tier[g] == req.tokens_by_tier[g + 1]
            self.calibration.record_outcome(
                g, req.seq_conf_by_tier[g], agree, req.prompt_tokens)

    def record_speculation(self, tier: int, drafted: int,
                           accepted: int) -> None:
        """One verify window resolved on `tier`: `drafted` draft
        positions scored, `accepted` confirmed (the rest rolled back)."""
        self.spec_drafted_by_tier[tier] += int(drafted)
        self.spec_accepted_by_tier[tier] += int(accepted)
        self.spec_rolled_back_by_tier[tier] += int(drafted - accepted)

    def record_draft_steps(self, tier: int, n: int) -> None:
        """`n` decode steps of `tier`'s draft loop in one launch."""
        self.spec_draft_steps_by_tier[tier] += int(n)

    def record_prefix_lookup(self, tier: int, cached_tokens: int,
                             prompt_tokens: int) -> None:
        """One prefix-cache lookup at admission: `cached_tokens` of the
        request's `prompt_tokens` were served from shared KV blocks
        (0 on a miss)."""
        self.prefix_lookups_by_tier[tier] += 1
        if cached_tokens:
            self.prefix_hits_by_tier[tier] += 1
            self.prefix_cached_tokens_by_tier[tier] += int(cached_tokens)
        self.prefix_prompt_tokens_by_tier[tier] += int(prompt_tokens)

    def record_prefill_tokens(self, live: int, processed: int) -> None:
        """One prefill execution: `live` real prompt tokens inside a
        batch of `processed` token slots."""
        self.prefill_live_tokens += int(live)
        self.prefill_processed_tokens += int(processed)

    def record_step_tokens(self, tier: int, live: int,
                           processed: int) -> None:
        """One token-batch launch of `tier`: `live` real tokens inside a
        launch that processed `processed` token slots."""
        self.step_live_tokens[tier] += int(live)
        self.step_processed_tokens[tier] += int(processed)

    def record_launches(self, tier: int, kind: str) -> None:
        """One launch of `tier`, of kind ``ragged`` or ``mixed`` (the
        unified executors), ``spec`` (the ragged executor under
        speculation), ``chunk`` or ``step`` (the split one), or
        ``prefill`` (a uniform one-shot prefill at admission)."""
        self.launches_by_tier[tier] += 1
        self._launched[tier] = True
        kinds = self.launches_by_kind[tier]
        kinds[kind] = kinds.get(kind, 0) + 1

    def record_host_sync(self, tier: int, n: int = 1) -> None:
        """One blocking device->host fetch paid by `tier`."""
        self.host_syncs_by_tier[tier] += n

    def record_completion(self, req: Request) -> None:
        self.latencies.append(req.latency)
        self.prompt_lens.append(req.prompt_tokens)
        if req.ttft is not None:
            self.ttfts.append(req.ttft)
            self.ttft_by_bucket.setdefault(
                length_bucket(req.prompt_tokens), []).append(req.ttft)
        if self.first_arrival is None \
                or req.arrival_time < self.first_arrival:
            self.first_arrival = req.arrival_time
        if self.last_finish is None or req.finish_time > self.last_finish:
            self.last_finish = req.finish_time

    def sync_gate_stats(self, gate_stats: Sequence[GateStats]) -> None:
        """Mirror the scheduler's gate counters into ServerStats."""
        for mine, theirs in zip(self.stats.gates, gate_stats):
            mine.seen = theirs.seen
            mine.escalated = theirs.escalated

    # -- summary -----------------------------------------------------------

    def conservation(self) -> dict:
        """Request conservation: every submitted request must end DONE,
        SHED, or FAILED (``in_flight`` is the residue — nonzero only
        mid-run; at drain ``ok`` must hold)."""
        done = len(self.latencies)
        shed = sum(self.shed_by_tier)
        failed = sum(self.failed_by_tier)
        in_flight = self.submitted - done - shed - failed
        return {"submitted": self.submitted, "completed": done,
                "shed": shed, "failed": failed, "in_flight": in_flight,
                "ok": in_flight == 0}

    def snapshot(self, now: float) -> dict:
        """A cheap point-in-time readout: progress, escalation, and the
        streaming calibration state (per-gate ECE + agreement)."""
        return {
            "t": now,
            "requests": self.stats.requests,
            "completed": len(self.latencies),
            "steps": self.steps,
            "escalation_rates": [g.escalation_rate
                                 for g in self.stats.gates],
            "gate_ece": [self.calibration.ece(g)
                         for g in range(self.calibration.n_gates)],
            "gate_agreement": [self.calibration.agreement_rate(g)
                               for g in range(self.calibration.n_gates)],
            "gate_outcomes": list(self.calibration.outcomes),
            "shed": sum(self.shed_by_tier),
            "preemptions": sum(self.preemptions_by_tier),
            "failed": sum(self.failed_by_tier),
            "tick_duration_p50": percentile(self.tick_durations, 50),
        }

    @property
    def elapsed(self) -> float:
        """First arrival -> last completion (makespan)."""
        if self.first_arrival is None or self.last_finish is None:
            return 0.0
        return self.last_finish - self.first_arrival

    def summary(self) -> dict:
        n = max(self.stats.requests, 1)
        elapsed = self.elapsed
        util = [self.busy_slot_steps[t] / max(self.steps * c, 1)
                for t, c in enumerate(self.slots_per_tier)]
        live, proc = sum(self.step_live_tokens), \
            sum(self.step_processed_tokens)
        return {
            "requests": self.stats.requests,
            "completed": len(self.latencies),
            "submitted": self.submitted,
            "steps": self.steps,
            "elapsed": elapsed,
            "throughput": (len(self.latencies) / elapsed
                           if elapsed > 0 else float("nan")),
            "latency_p50": percentile(self.latencies, 50),
            "latency_p95": percentile(self.latencies, 95),
            "ttft_p50": percentile(self.ttfts, 50),
            "ttft_p95": percentile(self.ttfts, 95),
            "ttft_p50_by_prompt_bucket": {
                b: percentile(v, 50)
                for b, v in sorted(
                    self.ttft_by_bucket.items(),
                    key=lambda kv: int(kv[0].split("-")[0]))},
            "prompt_len_mean": (float(np.mean(self.prompt_lens))
                                if self.prompt_lens else float("nan")),
            "prompt_len_max": (max(self.prompt_lens)
                               if self.prompt_lens else 0),
            "prefill_live_tokens": self.prefill_live_tokens,
            "prefill_processed_tokens": self.prefill_processed_tokens,
            "prefill_live_token_ratio": (
                self.prefill_live_tokens / self.prefill_processed_tokens
                if self.prefill_processed_tokens else float("nan")),
            "step_live_tokens": live,
            "step_processed_tokens": proc,
            "step_live_tokens_by_tier": list(self.step_live_tokens),
            "step_processed_tokens_by_tier":
                list(self.step_processed_tokens),
            "wasted_slot_ratio": 1.0 - live / proc if proc else float("nan"),
            "wasted_slot_ratio_by_tier": [
                1.0 - l / p if p else float("nan")
                for l, p in zip(self.step_live_tokens,
                                self.step_processed_tokens)],
            "launches": list(self.launches_by_tier),
            "launches_by_kind": [dict(k) for k in self.launches_by_kind],
            "active_ticks": list(self.active_ticks),
            "launches_per_tick": [
                n_ / self.steps if self.steps else float("nan")
                for n_ in self.launches_by_tier],
            "host_syncs": list(self.host_syncs_by_tier),
            "host_syncs_per_tick": [
                n_ / self.steps if self.steps else float("nan")
                for n_ in self.host_syncs_by_tier],
            "tick_duration_p50": percentile(self.tick_durations, 50),
            "tick_duration_p95": percentile(self.tick_durations, 95),
            "tick_duration_max": (max(self.tick_durations)
                                  if self.tick_durations else float("nan")),
            "tier_names": [t.name for t in self.tiers],
            "tier_requests": list(self.tier_requests),
            "tier_utilization": util,
            "escalation_rates": [g.escalation_rate
                                 for g in self.stats.gates],
            # overload-and-failure surface: shed rate is over submissions
            # (a request shed before admission never counts as a request)
            "shed": sum(self.shed_by_tier),
            "shed_by_tier": list(self.shed_by_tier),
            "shed_rate": (sum(self.shed_by_tier) / self.submitted
                          if self.submitted else 0.0),
            "failed": sum(self.failed_by_tier),
            "failed_by_tier": list(self.failed_by_tier),
            "preemptions": sum(self.preemptions_by_tier),
            "preemptions_by_tier": list(self.preemptions_by_tier),
            "replayed_tokens": sum(self.replayed_tokens_by_tier),
            "replayed_tokens_by_tier": list(self.replayed_tokens_by_tier),
            "launch_retries": sum(self.retries_by_tier),
            "launch_retries_by_tier": list(self.retries_by_tier),
            "conservation": self.conservation(),
            # prefix cache: hit rate over lookups, tokens served from
            # shared blocks (the prefill work saved), and the fraction
            # of all admitted prompt tokens the cache absorbed
            "prefix_cache": {
                "lookups": sum(self.prefix_lookups_by_tier),
                "hits": sum(self.prefix_hits_by_tier),
                "hit_rate": (sum(self.prefix_hits_by_tier)
                             / sum(self.prefix_lookups_by_tier)
                             if sum(self.prefix_lookups_by_tier)
                             else float("nan")),
                "cached_tokens": sum(self.prefix_cached_tokens_by_tier),
                "cached_token_frac": (
                    sum(self.prefix_cached_tokens_by_tier)
                    / sum(self.prefix_prompt_tokens_by_tier)
                    if sum(self.prefix_prompt_tokens_by_tier)
                    else float("nan")),
                "hits_by_tier": list(self.prefix_hits_by_tier),
                "cached_tokens_by_tier":
                    list(self.prefix_cached_tokens_by_tier),
            },
            # speculative cascade decoding: accept rate over verified
            # drafts and the draft/accept/rollback counters per verify
            # tier, the draft loop's decode steps per draft tier
            "speculation": {
                "drafted": sum(self.spec_drafted_by_tier),
                "accepted": sum(self.spec_accepted_by_tier),
                "rolled_back": sum(self.spec_rolled_back_by_tier),
                "accept_rate": (sum(self.spec_accepted_by_tier)
                                / sum(self.spec_drafted_by_tier)
                                if sum(self.spec_drafted_by_tier)
                                else float("nan")),
                "drafted_by_tier": list(self.spec_drafted_by_tier),
                "accepted_by_tier": list(self.spec_accepted_by_tier),
                "rolled_back_by_tier":
                    list(self.spec_rolled_back_by_tier),
                "draft_steps_by_tier":
                    list(self.spec_draft_steps_by_tier),
            },
            # streaming gate calibration: per-gate confidence histogram,
            # reliability diagram + ECE from escalation and verify
            # outcomes (overall and per prompt-length bucket)
            "gate_calibration": self.calibration.summary(),
            "flops_per_request_cascade": self.stats.cost / n,   # Eq 7
            "flops_per_request_always_fast":
                self.tiers[0].flops_per_request,
            "flops_per_request_always_expensive":
                sum(t.flops_per_request for t in self.tiers),
        }
