"""Request lifecycle for the async cascade runtime (a copy of the JAX
package's ``repro/serving/request.py``; numpy only).

A request moves through::

    QUEUED -> PREFILL -> DECODE -> GATED -+-> DONE
       ^                                  |
       '---------- ESCALATED <------------'   (conf <= δ, next tier)

Escalated requests re-enter QUEUED-like waiting in the next tier's
escalation queue and are re-prefilled there (the expensive member decodes
from scratch, as in the paper's cascade — its quality, not the fast
model's draft, is what the gate bought).

Overload and failure add three more states (see docs/serving.md
"Overload and failure semantics"):

  * ``PREEMPTED`` — a live row evicted by the engine's preemption policy
    when the KV block pool runs dry.  The tier's partial work is
    discarded and the request re-queues at the head of its tier's queue;
    re-admission replays prefill (and, deterministically, the same
    decode) from scratch through the idempotent chunk machinery, so the
    replayed token stream is bit-identical to an uninterrupted run.
  * ``SHED`` (terminal) — a *queued* request rejected by the load-shedding
    pass because its deadline has passed or provably cannot be met.
  * ``FAILED`` (terminal) — a live request sacrificed when a launch's
    bounded retry budget exhausts on persistent transient errors (the
    engine fails one request, never the whole run).

Timestamps are recorded in the engine's clock domain (wall seconds or
virtual ticks): arrival, admission per tier, first token, finish.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
    GATED = "gated"
    ESCALATED = "escalated"
    PREEMPTED = "preempted"   # evicted from a row; re-queued for replay
    SHED = "shed"             # terminal: deadline-rejected while queued
    FAILED = "failed"         # terminal: launch retries exhausted
    DONE = "done"


_ALLOWED = {
    RequestState.QUEUED: {RequestState.PREFILL, RequestState.SHED},
    RequestState.PREFILL: {RequestState.DECODE, RequestState.PREEMPTED,
                           RequestState.FAILED},
    RequestState.DECODE: {RequestState.DECODE, RequestState.GATED,
                          RequestState.PREEMPTED, RequestState.FAILED},
    RequestState.GATED: {RequestState.ESCALATED, RequestState.DONE},
    RequestState.ESCALATED: {RequestState.PREFILL, RequestState.SHED},
    RequestState.PREEMPTED: {RequestState.PREFILL, RequestState.SHED},
    RequestState.SHED: set(),
    RequestState.FAILED: set(),
    RequestState.DONE: set(),
}

#: states a request can never leave (conservation: every submitted
#: request ends in exactly one of these)
TERMINAL_STATES = frozenset({RequestState.DONE, RequestState.SHED,
                             RequestState.FAILED})


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                    # [P] int32
    gen_len: int
    arrival_time: float
    # absolute completion deadline in the engine's clock domain; None =
    # no deadline.  The scheduler's shedding pass rejects queued requests
    # past (or provably unable to meet) it into the SHED terminal state.
    deadline: Optional[float] = None
    state: RequestState = RequestState.QUEUED
    tier: int = 0                         # current cascade member index
    slot: Optional[int] = None            # KV slot in the current tier pool
    preemptions: int = 0                  # times evicted and replayed

    tokens: List[int] = field(default_factory=list)       # current tier
    token_conf: List[float] = field(default_factory=list)
    # speculative cascade decoding: the cheap-tier row retained at
    # escalation to draft ahead of this request's expensive-tier decode,
    # plus the drafts it staged for the next verify pass.  Cleared by
    # the engine on every terminal/replay path (never by admit(), which
    # runs while the draft row is live).
    draft_tier: Optional[int] = None
    draft_slot: Optional[int] = None
    draft_tokens: List[int] = field(default_factory=list)
    draft_confs: List[float] = field(default_factory=list)
    seq_conf_by_tier: List[float] = field(default_factory=list)
    # per-tier token-stream snapshots (taken at gate time): tier t's
    # stream vs tier t+1's is the escalation-outcome agreement proxy
    # feeding the streaming calibration telemetry
    tokens_by_tier: List[List[int]] = field(default_factory=list)
    admit_times: List[float] = field(default_factory=list)
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    # lifecycle span log [(state, t), ...] in the engine's clock domain
    # (timestamps are None for transitions the caller didn't stamp);
    # the tracer keeps its own wall-clock spans — this is the
    # metrics-facing record
    span_log: List[tuple] = field(default_factory=list)

    def _to(self, state: RequestState) -> None:
        if state not in _ALLOWED[self.state]:
            raise ValueError(
                f"request {self.rid}: illegal transition "
                f"{self.state.value} -> {state.value}")
        self.state = state

    # -- lifecycle ---------------------------------------------------------

    def admit(self, tier: int, slot: int, now: float) -> None:
        """QUEUED/ESCALATED/PREEMPTED -> PREFILL in `tier` occupying
        `slot`.  Re-admission after preemption resets the tier's partial
        work (tokens/confidences) exactly like escalation does — greedy
        decode is deterministic, so the replay regenerates the identical
        stream."""
        if not self.span_log:
            self.span_log.append((RequestState.QUEUED.value,
                                  self.arrival_time))
        self._to(RequestState.PREFILL)
        self.tier = tier
        self.slot = slot
        self.tokens = []
        self.token_conf = []
        self.admit_times.append(now)
        self.span_log.append((RequestState.PREFILL.value, now))

    def start_decode(self, now: Optional[float] = None) -> None:
        self._to(RequestState.DECODE)
        self.span_log.append((RequestState.DECODE.value, now))

    def emit(self, token: int, conf: float, now: float) -> None:
        """Record one generated token + its gate confidence."""
        if self.state is not RequestState.DECODE:
            raise ValueError(f"request {self.rid}: emit in {self.state.value}")
        self.tokens.append(int(token))
        self.token_conf.append(float(conf))
        if self.first_token_time is None:
            self.first_token_time = now

    @property
    def prompt_tokens(self) -> int:
        """Prompt length in tokens (mixed-length serving: per request)."""
        return int(self.prompt.shape[0])

    @property
    def decode_finished(self) -> bool:
        return len(self.tokens) >= self.gen_len

    def gate(self, reduce: str = "mean") -> float:
        """DECODE -> GATED; returns the aggregated sequence confidence."""
        self._to(RequestState.GATED)
        conf = sequence_confidence(self.token_conf, reduce)
        self.seq_conf_by_tier.append(conf)
        self.tokens_by_tier.append(list(self.tokens))
        return conf

    def escalate(self, now: Optional[float] = None) -> None:
        """GATED -> ESCALATED (will queue for tier+1)."""
        self._to(RequestState.ESCALATED)
        self.slot = None
        self.span_log.append((RequestState.ESCALATED.value, now))

    def preempt(self, now: Optional[float] = None) -> None:
        """PREFILL/DECODE -> PREEMPTED: evicted from its row, partial
        tier work discarded; the engine re-queues it for replay."""
        self._to(RequestState.PREEMPTED)
        self.slot = None
        self.preemptions += 1
        self.span_log.append((RequestState.PREEMPTED.value, now))

    def shed(self, now: Optional[float] = None) -> None:
        """QUEUED/ESCALATED/PREEMPTED -> SHED (terminal): load-shedding
        rejected this request (deadline passed or provably unmeetable)."""
        self._to(RequestState.SHED)
        self.finish_time = None
        self.span_log.append((RequestState.SHED.value, now))

    def fail(self, now: Optional[float] = None) -> None:
        """PREFILL/DECODE -> FAILED (terminal): launch retries exhausted
        with this request chosen as the sacrifice."""
        self._to(RequestState.FAILED)
        self.slot = None
        self.span_log.append((RequestState.FAILED.value, now))

    def complete(self, now: float) -> None:
        self._to(RequestState.DONE)
        self.slot = None
        self.finish_time = now
        self.span_log.append((RequestState.DONE.value, now))

    # -- derived metrics ---------------------------------------------------

    @property
    def latency(self) -> Optional[float]:
        if self.finish_time is None:
            return None
        return self.finish_time - self.arrival_time

    @property
    def ttft(self) -> Optional[float]:
        """Time to first (fast-tier) token."""
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival_time

    @property
    def num_escalations(self) -> int:
        return self.tier


def sequence_confidence(token_conf, reduce: str = "mean") -> float:
    """Aggregate per-token confidences (numpy twin of
    repro_torch.core.confidence.sequence_confidence)."""
    c = np.asarray(token_conf, np.float64)
    if c.size == 0:
        return 0.0
    if reduce == "mean":
        return float(c.mean())
    if reduce == "min":
        return float(c.min())
    if reduce == "prod":
        return float(np.exp(np.log(np.clip(c, 1e-9, 1.0)).sum()))
    raise ValueError(reduce)
