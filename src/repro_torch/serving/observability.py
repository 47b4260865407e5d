"""Serving observability (the torch port of the JAX package's
``repro/serving/observability.py``): request/tick tracing, streaming gate
calibration, and profiler hooks.  All three cost nothing when disabled.

* :class:`Tracer` — a host-side tracer.  The engine records per-request
  lifecycle spans (QUEUED → PREFILL → DECODE → ESCALATED → DONE, one
  async track per request id under its tier's process row) and per-tick
  phase events (admit, plan, launch, device_get, finish) into a bounded
  ring buffer, exported as Chrome trace-event JSON that Perfetto loads
  (``serve_async --trace-out trace.json``; ``scripts/check_trace.py``
  validates it).  Events are built only from values the tick already
  fetched, so tracing adds no host sync and no device transfer.  The
  tracer uses the standard library only.
* :class:`GateCalibration` — streaming calibration telemetry.  Per gate:
  a confidence histogram of every decision, reliability bins (binned
  confidence against realized correctness) and a streaming ECE, overall
  and per prompt-length bucket.  Two correctness streams feed the bins:
  **escalation outcomes** (when an escalated request completes, the
  expensive tier's token stream either agrees with the cheap tier's or
  not; observed only for escalated traffic, so the bins cover the
  low-confidence slice) and **verify outcomes** (under speculative
  cascade decoding each draft token the expensive tier scored is
  accepted or rejected; every draft is scored whatever the gate decided,
  so this stream has no selection bias).
* profiler hooks — :func:`annotation` and :func:`step_annotation` open
  ``torch.profiler.record_function`` ranges (and, on a CUDA device, NVTX
  ranges) named as the JAX engine names its ``jax.profiler`` annotations
  (``run_ragged/<tier>`` and so on; ``tick/<id>`` for a tick), so a
  device trace carries the host tracer's tick ids and launch names;
  :func:`profile_window` is ``serve_async --profile DIR``.

``length_bucket`` lives here (re-exported by ``serving/metrics.py``) so
the metrics and the telemetry bucket prompt lengths alike.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch


def length_bucket(n: int) -> str:
    """Power-of-two prompt-length bucket label ("1", "2", "3-4", "5-8",
    "9-16", ...)."""
    hi = 1
    while hi < n:
        hi *= 2
    lo = hi // 2 + 1
    return str(hi) if lo >= hi else f"{lo}-{hi}"


# ---------------------------------------------------------------------------
# Structured tracer (Chrome trace-event / Perfetto export)
# ---------------------------------------------------------------------------

# track layout: pid 0 carries the engine's per-tick phase events (one
# tid per tier, plus one extra tid for the whole-tick span); pid
# REQUEST_PID_BASE + tier carries that tier's request lifecycle spans
# as async events keyed by request id.
ENGINE_PID = 0
REQUEST_PID_BASE = 1000


class Tracer:
    """Bounded ring buffer of Chrome trace events.

    All timestamps come from the tracer's own monotonic wall clock
    (``time.perf_counter_ns``-based microseconds), independent of the
    engine's — possibly virtual — clock, so host-time bubbles are real
    on the timeline even in deterministic runs.  The ring holds the
    most recent ``capacity`` events (``dropped`` counts evictions);
    export emits the surviving window plus track-naming metadata.
    """

    def __init__(self, capacity: int = 1 << 18):
        if capacity <= 0:
            raise ValueError("tracer capacity must be positive")
        self.capacity = capacity
        self._events: deque = deque(maxlen=capacity)
        self.dropped = 0
        self._open_req: Dict[int, dict] = {}     # rid -> open async span
        self._tracks: Dict[tuple, str] = {}      # (pid, tid) -> name
        self._pids: Dict[int, str] = {}
        self._t0 = time.perf_counter_ns()

    # -- clock --------------------------------------------------------------

    def now_us(self) -> float:
        return (time.perf_counter_ns() - self._t0) / 1e3

    # -- low-level event append --------------------------------------------

    def _append(self, ev: dict) -> None:
        if len(self._events) == self.capacity:
            self.dropped += 1
        self._events.append(ev)

    def name_process(self, pid: int, name: str) -> None:
        self._pids[pid] = name

    def name_track(self, pid: int, tid: int, name: str) -> None:
        self._tracks[(pid, tid)] = name

    # -- engine phase events (complete "X" events) --------------------------

    def phase(self, name: str, tid: int, t0_us: float,
              t1_us: Optional[float] = None, **args) -> None:
        """One completed engine phase on pid 0, track ``tid`` (tier
        index, or the extra whole-tick lane): an "X" event from
        ``t0_us`` to ``t1_us`` (default: now)."""
        t1 = self.now_us() if t1_us is None else t1_us
        self._append({"name": name, "ph": "X", "ts": t0_us,
                      "dur": max(t1 - t0_us, 0.0), "pid": ENGINE_PID,
                      "tid": tid, "args": args})

    @contextlib.contextmanager
    def span(self, name: str, tid: int, **args):
        """``with tracer.span("admit", tid=tier, tick=k): ...`` — times
        the body and appends the phase event."""
        t0 = self.now_us()
        try:
            yield
        finally:
            self.phase(name, tid, t0, **args)

    def instant(self, name: str, tid: int, **args) -> None:
        self._append({"name": name, "ph": "i", "ts": self.now_us(),
                      "pid": ENGINE_PID, "tid": tid, "s": "t",
                      "args": args})

    def prefix_cache_event(self, tier: int, rid: int, cached_tokens: int,
                           prompt_tokens: int, **args) -> None:
        """One prefix-cache lookup at admission, as an instant on the
        tier's engine lane: ``prefix_cache_hit`` when a cached prefix
        was mapped (args carry how many of the prompt's tokens it
        covers), ``prefix_cache_miss`` otherwise."""
        self.instant(
            "prefix_cache_hit" if cached_tokens else "prefix_cache_miss",
            tier, rid=rid, cached_tokens=int(cached_tokens),
            prompt_tokens=int(prompt_tokens), **args)

    def counter(self, name: str, value: float, tid: int = 0) -> None:
        """A counter track sample (queue depth, live rows, ...)."""
        self._append({"name": name, "ph": "C", "ts": self.now_us(),
                      "pid": ENGINE_PID, "tid": tid,
                      "args": {"value": float(value)}})

    # -- request lifecycle (async "b"/"e" spans keyed by rid) ---------------

    def request_transition(self, rid: int, state: str, tier: int,
                           shard: Optional[int] = None, **args) -> None:
        """Close the request's open lifecycle span (if any) and open a
        new one named ``state`` on the tier's request track.  Async
        events keyed by ``rid`` may overlap freely on one track —
        Perfetto renders each request id on its own sub-lane."""
        now = self.now_us()
        self._close_req(rid, now)
        pid = REQUEST_PID_BASE + tier
        ev = {"name": state, "ph": "b", "cat": "request", "id": rid,
              "ts": now, "pid": pid, "tid": int(shard or 0),
              "args": dict(args)}
        self._append(ev)
        self._open_req[rid] = ev

    def request_done(self, rid: int, tier: int,
                     shard: Optional[int] = None,
                     state: str = "DONE", **args) -> None:
        """Terminal transition: close the open span and mark the
        terminal `state` (DONE, or the overload terminals SHED/FAILED)
        as an instant on the tier's request track."""
        now = self.now_us()
        self._close_req(rid, now)
        self._append({"name": state, "ph": "i", "ts": now,
                      "pid": REQUEST_PID_BASE + tier,
                      "tid": int(shard or 0), "s": "t",
                      "args": dict(rid=rid, **args)})

    def _close_req(self, rid: int, now_us: float) -> None:
        open_ev = self._open_req.pop(rid, None)
        if open_ev is not None:
            self._append({"name": open_ev["name"], "ph": "e",
                          "cat": "request", "id": rid, "ts": now_us,
                          "pid": open_ev["pid"], "tid": open_ev["tid"],
                          "args": {}})

    # -- export -------------------------------------------------------------

    def events(self) -> List[dict]:
        return list(self._events)

    def trace_dict(self) -> dict:
        """The Chrome trace-event JSON object: track metadata + the ring's
        surviving events (a truncated ring may open with orphan "e"
        closes — Perfetto tolerates them; ``scripts/check_trace.py``
        knows the ring semantics)."""
        meta = []
        for pid, name in sorted(self._pids.items()):
            meta.append({"name": "process_name", "ph": "M", "pid": pid,
                         "tid": 0, "args": {"name": name}})
            meta.append({"name": "process_sort_index", "ph": "M",
                         "pid": pid, "tid": 0, "args": {"sort_index": pid}})
        for (pid, tid), name in sorted(self._tracks.items()):
            meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                         "tid": tid, "args": {"name": name}})
        return {"traceEvents": meta + self.events(),
                "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped}}

    def export(self, path: str) -> int:
        """Write Perfetto-loadable JSON; returns the event count."""
        trace = self.trace_dict()
        with open(path, "w") as f:
            json.dump(trace, f)
        return len(trace["traceEvents"])


# ---------------------------------------------------------------------------
# Streaming gate-calibration telemetry
# ---------------------------------------------------------------------------


class ReliabilityBins:
    """Streaming reliability diagram: fixed confidence bins accumulating
    (count, Σconf, Σcorrect) so ECE is computable at any point without
    storing samples.  Bin ``i`` covers ``[i/bins, (i+1)/bins)`` (the
    last bin closed at 1.0)."""

    def __init__(self, bins: int = 10):
        if bins <= 0:
            raise ValueError("need at least one bin")
        self.bins = bins
        self.count = np.zeros(bins, np.int64)
        self.conf_sum = np.zeros(bins, np.float64)
        self.correct_sum = np.zeros(bins, np.float64)

    def record(self, conf: float, correct: bool) -> None:
        i = min(int(conf * self.bins), self.bins - 1)
        i = max(i, 0)
        self.count[i] += 1
        self.conf_sum[i] += conf
        self.correct_sum[i] += 1.0 if correct else 0.0

    @property
    def total(self) -> int:
        return int(self.count.sum())

    def ece(self) -> float:
        """Expected Calibration Error over the streamed samples:
        Σ_b (n_b/N)·|conf̄_b − acc̄_b| (Guo et al. 2017).  NaN until a
        sample arrives."""
        n = self.total
        if n == 0:
            return float("nan")
        mask = self.count > 0
        avg_conf = self.conf_sum[mask] / self.count[mask]
        avg_acc = self.correct_sum[mask] / self.count[mask]
        w = self.count[mask] / n
        return float(np.sum(w * np.abs(avg_conf - avg_acc)))

    def diagram(self) -> List[dict]:
        """Per-bin reliability rows (lo, hi, n, mean conf, realized
        accuracy) — empty bins keep n=0 with NaN means."""
        out = []
        for i in range(self.bins):
            n = int(self.count[i])
            out.append({
                "lo": i / self.bins,
                "hi": (i + 1) / self.bins,
                "n": n,
                "conf": self.conf_sum[i] / n if n else float("nan"),
                "acc": self.correct_sum[i] / n if n else float("nan"),
            })
        return out


class GateCalibration:
    """Per-gate streaming calibration state, fed by every gate decision
    (``record_gate``: the confidence histogram and its escalated share),
    every escalation outcome (``record_outcome``) and every speculative
    verify outcome (``record_verify_outcome``); the two outcome streams
    share the reliability bins."""

    def __init__(self, n_gates: int, bins: int = 10):
        self.n_gates = n_gates
        self.bins = bins
        self.conf_hist = [np.zeros(bins, np.int64) for _ in range(n_gates)]
        self.esc_hist = [np.zeros(bins, np.int64) for _ in range(n_gates)]
        self.reliability = [ReliabilityBins(bins) for _ in range(n_gates)]
        self.reliability_by_bucket: List[Dict[str, ReliabilityBins]] = [
            {} for _ in range(n_gates)]
        self.outcomes = [0] * n_gates
        self.agreements = [0] * n_gates
        self.verify_outcomes = [0] * n_gates
        self.verify_accepts = [0] * n_gates

    def record_gate(self, gate: int, conf: float, escalated: bool) -> None:
        i = min(max(int(conf * self.bins), 0), self.bins - 1)
        self.conf_hist[gate][i] += 1
        if escalated:
            self.esc_hist[gate][i] += 1

    def record_outcome(self, gate: int, conf: float, agree: bool,
                       prompt_len: Optional[int] = None) -> None:
        self.outcomes[gate] += 1
        if agree:
            self.agreements[gate] += 1
        self.reliability[gate].record(conf, agree)
        if prompt_len is not None:
            bucket = length_bucket(prompt_len)
            by = self.reliability_by_bucket[gate]
            if bucket not in by:
                by[bucket] = ReliabilityBins(self.bins)
            by[bucket].record(conf, agree)

    def record_verify_outcome(self, gate: int, conf: float,
                              accepted: bool) -> None:
        """One speculative verify decision at `gate`: the draft tier
        emitted a token with confidence `conf` and the verify tier's
        argmax `accepted` (or rejected) it.  Streams into the same
        reliability bins escalation outcomes feed — per token rather
        than per sequence, and without selection bias."""
        self.verify_outcomes[gate] += 1
        if accepted:
            self.verify_accepts[gate] += 1
        self.reliability[gate].record(conf, accepted)

    # -- readouts -----------------------------------------------------------

    def verify_accept_rate(self, gate: int) -> float:
        n = self.verify_outcomes[gate]
        return self.verify_accepts[gate] / n if n else float("nan")

    def ece(self, gate: int) -> float:
        return self.reliability[gate].ece()

    def agreement_rate(self, gate: int) -> float:
        n = self.outcomes[gate]
        return self.agreements[gate] / n if n else float("nan")

    def summary(self) -> List[dict]:
        """Per-gate calibration block for ``ServingMetrics.summary()``
        (plain lists: JSON-serializable)."""
        out = []
        for g in range(self.n_gates):
            by_bucket = {
                b: {"ece": r.ece(), "n": r.total}
                for b, r in sorted(
                    self.reliability_by_bucket[g].items(),
                    key=lambda kv: int(kv[0].split("-")[0]))}
            out.append({
                "gate": g,
                "seen": int(self.conf_hist[g].sum()),
                "conf_hist": self.conf_hist[g].tolist(),
                "esc_hist": self.esc_hist[g].tolist(),
                "bin_edges": [i / self.bins for i in range(self.bins + 1)],
                "outcomes": self.outcomes[g],
                "agreement_rate": self.agreement_rate(g),
                "verify_outcomes": self.verify_outcomes[g],
                "verify_accept_rate": self.verify_accept_rate(g),
                "ece": self.ece(g),
                "reliability": self.reliability[g].diagram(),
                "ece_by_prompt_bucket": by_bucket,
            })
        return out


# ---------------------------------------------------------------------------
# torch profiler hooks
# ---------------------------------------------------------------------------

NULL_CONTEXT = contextlib.nullcontext()
# the Chrome trace profile_window writes into its directory
PROFILE_TRACE = "torch_trace.json"


@contextlib.contextmanager
def _range(name: str, device):
    """A ``record_function`` range, inside an NVTX range on a CUDA
    device (no fallback: a CUDA device whose NVTX range fails raises)."""
    with torch.profiler.record_function(name):
        if torch.device(device).type != "cuda":
            yield
            return
        torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            torch.cuda.nvtx.range_pop()


def annotation(name: str, enabled: bool = True, device="cpu"):
    """A named profiler range around one launch (the shared no-op context
    when ``enabled`` is False): the engine wraps its launches as
    ``run_ragged/<tier>`` etc., so a profiler trace shows each launch's
    kernels under the JAX engine's annotation names."""
    if not enabled:
        return NULL_CONTEXT
    return _range(name, device)


def step_annotation(tick: int, enabled: bool = True, device="cpu"):
    """The range of one engine tick, named ``tick/<id>`` with the
    engine's tick id — the join key between a profiler trace and the
    host tracer's ``tick`` args (the JAX engine's
    ``StepTraceAnnotation(step_num=tick)``)."""
    if not enabled:
        return NULL_CONTEXT
    return _range(f"tick/{tick}", device)


@contextlib.contextmanager
def profile_window(out_dir: Optional[str], device="cpu"):
    """An opt-in ``torch.profiler`` window (``serve_async --profile
    DIR``): host (CPU) activity and, on a CUDA device, the card's kernels
    for the body, written as a Chrome trace to ``DIR/torch_trace.json``
    when the body ends; a CUDA device the profiler cannot trace raises.
    Yields the profiler (None when ``out_dir`` is None: a no-op)."""
    if not out_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile, supported_activities
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available() or \
                ProfilerActivity.CUDA not in supported_activities():
            raise RuntimeError(
                f"profile_window: device {device!r} asked for, but this "
                "torch cannot trace the card's kernels")
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(out_dir, PROFILE_TRACE))
