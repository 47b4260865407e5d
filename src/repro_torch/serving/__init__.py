"""Asynchronous cascade serving runtime (torch port of the main path).

  * :mod:`repro_torch.serving.request`   — request lifecycle state machine
  * :mod:`repro_torch.serving.slots`     — block-paged KV arenas (free list
    of fixed-size blocks + per-request page tables)
  * :mod:`repro_torch.serving.scheduler` — continuous batching + escalation
    queues
  * :mod:`repro_torch.serving.metrics`   — latency/throughput/Eq 7
    accounting
  * :mod:`repro_torch.serving.observability` — the request/tick tracer
    (Chrome-trace export), streaming gate-calibration telemetry (per-gate
    ECE against escalation and verify outcomes) and profiler ranges
  * :mod:`repro_torch.serving.faults`    — deterministic fault injection
    (pool shrinkage, escalation storms, transient launch failures, slow
    ticks) behind zero-cost-when-None engine hooks
  * :mod:`repro_torch.serving.engine`    — CascadeEngine tying tiers
    together
"""
from repro_torch.serving.engine import CascadeEngine, TierSpec  # noqa: F401
from repro_torch.serving.faults import FaultPlan, TransientError  # noqa: F401
from repro_torch.serving.metrics import ServingMetrics  # noqa: F401
from repro_torch.serving.observability import Tracer  # noqa: F401
from repro_torch.serving.request import Request, RequestState  # noqa: F401
from repro_torch.serving.scheduler import CascadeScheduler, GateSpec  # noqa: F401
from repro_torch.serving.slots import (BlockAllocator, SlotAllocator,  # noqa: F401
                                       TierSlotPool)

__all__ = [
    "CascadeEngine", "TierSpec", "ServingMetrics", "Request", "RequestState",
    "CascadeScheduler", "GateSpec", "SlotAllocator", "BlockAllocator",
    "TierSlotPool", "FaultPlan", "TransientError", "Tracer",
]
