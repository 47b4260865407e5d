"""Gate bookkeeping shared by the serving engine (a copy of the
``GateStats``/``ServerStats``/``delta_for_escalation_rate`` half of the
JAX package's ``repro/core/server.py``; numpy only)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np


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
