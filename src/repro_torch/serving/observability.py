"""Streaming gate-calibration telemetry (the torch port's copy of the
calibration half of the JAX package's ``repro/serving/observability.py``;
numpy only).

The paper's argument is that cascade quality is governed by the
*calibration* of the gate confidence, so the serving loop measures it as
it serves.  :class:`GateCalibration` keeps, per gate, a confidence
histogram of every decision, reliability bins (binned confidence against
realized correctness) and a streaming ECE, overall and per prompt-length
bucket.  Two correctness streams feed the bins:

* **escalation outcomes** — when an escalated request completes, the
  expensive tier's token stream either agrees with the cheap tier's or
  not.  Observed only for escalated traffic (confidence ≤ δ), so the
  bins cover the low-confidence slice;
* **verify outcomes** — under speculative cascade decoding each draft
  token the expensive tier scored is accepted or rejected.  Every draft
  is scored whatever the gate decided, so this stream has no selection
  bias.

``length_bucket`` lives here (re-exported by ``serving/metrics.py``) so
the metrics and the telemetry bucket prompt lengths alike.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


def length_bucket(n: int) -> str:
    """Power-of-two prompt-length bucket label ("1", "2", "3-4", "5-8",
    "9-16", ...)."""
    hi = 1
    while hi < n:
        hi *= 2
    lo = hi // 2 + 1
    return str(hi) if lo >= hi else f"{lo}-{hi}"


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
