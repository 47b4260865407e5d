"""Cascade-serving orchestrator and gate bookkeeping (a copy of the JAX
package's ``repro/core/server.py``; numpy only).

:class:`CascadeServer` wraps M generate functions (fast -> expensive)
behind the paper's confidence gates, packs the escalated requests into
dense sub-batches before invoking the next member, and keeps running
statistics (escalation rate per gate, realized cost).  Members expose
``generate(prompts) -> (outputs, seq_conf)``; the last member's
confidence is ignored (no gate after it).  The serving engine shares
``GateStats`` and :func:`delta_for_escalation_rate` (δ from a target
escalation budget on calibration traffic).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class ServingMember:
    name: str
    generate: Callable          # prompts [B, P] -> (outputs [B, G], conf [B])
    cost_per_request: float     # FLOPs (or MACs) per request


@dataclass
class GateStats:
    seen: int = 0
    escalated: int = 0

    @property
    def escalation_rate(self) -> float:
        return self.escalated / max(self.seen, 1)


@dataclass
class ServerStats:
    requests: int = 0
    cost: float = 0.0
    gates: List[GateStats] = field(default_factory=list)

    @property
    def cost_per_request(self) -> float:
        return self.cost / max(self.requests, 1)


def delta_for_escalation_rate(confs, target_rate: float) -> float:
    """δ such that ~target_rate of calibration confidences fall at/below
    it (the deployment knob: an escalation *budget* rather than a fixed
    threshold)."""
    confs = np.asarray(confs, np.float64)
    if len(confs) == 0:
        return 0.5
    return float(np.quantile(confs, np.clip(target_rate, 0.0, 1.0)))


class CascadeServer:
    """M-member cascade with packed escalation."""

    def __init__(self, members: Sequence[ServingMember],
                 deltas: Sequence[float]):
        if len(deltas) != len(members) - 1:
            raise ValueError("one gate per non-final member")
        self.members = list(members)
        self.deltas = [float(d) for d in deltas]
        self.stats = ServerStats(gates=[GateStats()
                                        for _ in range(len(members) - 1)])

    def serve(self, prompts) -> Tuple[np.ndarray, np.ndarray]:
        """prompts [B, P] -> (outputs [B, G], member_index [B])."""
        prompts = np.asarray(prompts)
        B = prompts.shape[0]
        if B == 0:
            # no member is invoked, so the output length is unknowable:
            # return an empty [0, 0] outputs/handled_by pair
            return np.zeros((0, 0), np.int32), np.zeros(0, np.int32)
        self.stats.requests += B

        active_idx = np.arange(B)
        outputs: Optional[np.ndarray] = None
        handled_by = np.zeros(B, np.int32)

        for m, member in enumerate(self.members):
            sub_prompts = prompts[active_idx]
            self.stats.cost += member.cost_per_request * len(active_idx)
            out, conf = member.generate(sub_prompts)
            out = np.asarray(out)
            conf = np.asarray(conf)
            if outputs is None:
                outputs = np.zeros((B,) + out.shape[1:], out.dtype)
            outputs[active_idx] = out
            handled_by[active_idx] = m

            if m == len(self.members) - 1:
                break
            gate = self.stats.gates[m]
            gate.seen += len(active_idx)
            esc_mask = conf <= self.deltas[m]
            gate.escalated += int(esc_mask.sum())
            active_idx = active_idx[esc_mask]          # packed sub-batch
            if len(active_idx) == 0:
                break

        return outputs, handled_by

    def summary(self) -> dict:
        s = self.stats
        return {
            "requests": s.requests,
            "cost_per_request": s.cost_per_request,
            "always_fast_cost": self.members[0].cost_per_request,
            "always_expensive_cost": sum(m.cost_per_request
                                         for m in self.members),
            "escalation_rates": [g.escalation_rate for g in s.gates],
        }
