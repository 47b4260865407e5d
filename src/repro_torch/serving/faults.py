"""Deterministic fault injection for the serving runtime (the torch
port's copy of the JAX package's ``repro/serving/faults.py``; numpy
only, so a seeded plan injects the same faults at the same (tick, tier,
launch kind) in both packages).

A :class:`FaultPlan` is a seeded, reproducible schedule of adverse
conditions threaded through :class:`repro_torch.serving.CascadeEngine` behind
zero-cost-when-None hooks (the same pattern as the Tracer: every call
site is guarded, a ``faults=None`` engine builds no objects and takes no
branches beyond the None check).  Four fault families:

  * **Pool shrinkage** — ``Shrink(tick, tier, blocks, restore_tick)``
    withholds free KV blocks from a tier's arena mid-run
    (:meth:`repro_torch.serving.slots.TierSlotPool.shrink`), forcing the
    over-subscription machinery (stalls, or preemption when a policy is
    set) to absorb a capacity loss.  The shrink caps keep the run
    deadlock-free by construction; ``restore_tick`` returns the blocks.
  * **Escalation storms** — ``Storm(start, end, gate)`` forces every
    gate decision at ``gate`` to escalate during ticks
    ``[start, end)``: the miscalibrated-confidence overload the paper's
    calibration work exists to prevent, driven through
    ``CascadeScheduler.gate_decision(force=True)`` so stats and
    calibration telemetry see it like real traffic.
  * **Transient launch failures** — raise :class:`TransientError` from
    inside the engine's retry wrapper, either probabilistically
    (``launch_fail_prob``, seeded and keyed by (tick, tier, kind) so
    draws are order-independent) or at targeted ticks
    (``fail_launches={(tick, tier): attempts}``).  Failures spanning
    fewer attempts than the engine's retry budget recover invisibly;
    more, and the engine sacrifices a single request (FAILED) rather
    than the run.
  * **Slow ticks** — seeded probabilistic ``time.sleep`` at tick start:
    host-side scheduling jitter for wall-clock runs.

Determinism: every probabilistic draw is a pure function of
``(seed, tick, ...)`` via ``np.random.default_rng`` keyed sequences —
no shared RNG state, so the same plan over the same workload injects
the same faults regardless of call order.

CLI spec format (``serve_async --inject-faults SPEC``): comma-separated
``key=value`` entries, repeatable where it makes sense::

    seed=N                            RNG seed (default 0)
    shrink=TICK:TIER:BLOCKS[:RESTORE] withhold BLOCKS from TIER's arena
                                      at TICK (restore at tick RESTORE)
    storm=START-END:GATE              force-escalate GATE during
                                      ticks [START, END)
    launch=PROB[:ATTEMPTS]            each (tick, tier, kind) launch
                                      fails w.p. PROB for ATTEMPTS
                                      consecutive attempts (default 1)
    launchat=TICK:TIER[:ATTEMPTS]     deterministic launch failure
    slow=PROB:SECONDS                 sleep SECONDS before a tick w.p.
                                      PROB

Example: ``--inject-faults "seed=7,shrink=5:0:8:40,storm=10-14:0,launch=0.05"``
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np


class TransientError(RuntimeError):
    """A fault-injected transient launch/transfer failure: the kind of
    error the engine's bounded retry-with-backoff path absorbs."""


@dataclass(frozen=True)
class Shrink:
    """Withhold `blocks` free KV blocks from `tier`'s arena at `tick`
    (restored at `restore_tick`; None = never)."""
    tick: int
    tier: int
    blocks: int
    restore_tick: Optional[int] = None


@dataclass(frozen=True)
class Storm:
    """Force every decision at `gate` to escalate during ticks
    ``[start, end)`` — a simulated gate-miscalibration overload."""
    start: int
    end: int
    gate: int = 0


# stable small codes for launch kinds, so probabilistic draws can be
# keyed per kind without hashing strings (unknown kinds share one code:
# run_ragged and run_spec draw as code 0, as in the JAX package)
_KIND_CODES = {"run_mixed": 1, "run_chunk": 2, "run_step": 3,
               "run_prefill": 4, "device_get": 5}


@dataclass
class FaultPlan:
    """A seeded, deterministic schedule of injected faults (see module
    docstring).  Construct directly for tests, or :meth:`parse` the CLI
    spec string."""
    seed: int = 0
    shrinks: Tuple[Shrink, ...] = ()
    storms: Tuple[Storm, ...] = ()
    #: targeted launch failures: (tick, tier) -> consecutive failing
    #: attempts (attempts > the engine's retry budget exhaust it)
    fail_launches: Dict[Tuple[int, int], int] = field(default_factory=dict)
    launch_fail_prob: float = 0.0
    launch_fail_attempts: int = 1
    slow_tick_prob: float = 0.0
    slow_tick_seconds: float = 0.0
    #: applied-event log [(tick, kind, detail), ...] — what actually
    #: fired, for tests and the CLI summary
    log: List[tuple] = field(default_factory=list)

    # -- deterministic draws -------------------------------------------------

    def _draw(self, *key: int) -> float:
        """A uniform [0,1) draw that is a pure function of (seed, *key):
        order-independent, replay-stable."""
        return float(np.random.default_rng(
            [self.seed] + [int(k) for k in key]).random())

    # -- engine hooks (each guarded by `if faults is not None` there) --------

    def begin_tick(self, tick: int, engine) -> None:
        """Tick-start faults: apply scheduled shrinks/restores to the
        engine's tier pools and (seeded) sleep for a slow tick."""
        for ev in self.shrinks:
            pool = engine.runtimes[ev.tier].pool
            if not hasattr(pool, "shrink"):
                continue            # dense arenas have no block pool
            if ev.tick == tick:
                took = pool.shrink(ev.blocks)
                self.log.append((tick, "shrink",
                                 {"tier": ev.tier, "requested": ev.blocks,
                                  "withheld": took}))
            if ev.restore_tick == tick:
                back = pool.unshrink()
                self.log.append((tick, "restore",
                                 {"tier": ev.tier, "restored": back}))
        if self.slow_tick_prob > 0.0 and \
                self._draw(tick, 7001) < self.slow_tick_prob:
            self.log.append((tick, "slow",
                             {"seconds": self.slow_tick_seconds}))
            time.sleep(self.slow_tick_seconds)

    def pre_launch(self, tick: int, tier: int, kind: str,
                   attempt: int) -> None:
        """Called inside the engine's retry wrapper before each launch
        attempt; raises :class:`TransientError` when the plan says this
        (tick, tier, kind) fails at this attempt index."""
        times = self.fail_launches.get((tick, tier))
        if times is not None and attempt < times:
            self.log.append((tick, "launch_fault",
                             {"tier": tier, "kind": kind,
                              "attempt": attempt, "targeted": True}))
            raise TransientError(
                f"injected launch failure: tick {tick} tier {tier} "
                f"{kind} attempt {attempt}")
        if self.launch_fail_prob > 0.0 and \
                attempt < self.launch_fail_attempts and \
                self._draw(tick, tier, _KIND_CODES.get(kind, 0)) \
                < self.launch_fail_prob:
            self.log.append((tick, "launch_fault",
                             {"tier": tier, "kind": kind,
                              "attempt": attempt, "targeted": False}))
            raise TransientError(
                f"injected launch failure: tick {tick} tier {tier} "
                f"{kind} attempt {attempt}")

    def force_escalation(self, tick: int, gate: int) -> Optional[bool]:
        """True when a storm covers (tick, gate); None = no override."""
        for st in self.storms:
            if st.gate == gate and st.start <= tick < st.end:
                return True
        return None

    # -- CLI spec ------------------------------------------------------------

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """Build a plan from the ``--inject-faults`` spec string (see
        module docstring for the grammar)."""
        kw: dict = {"shrinks": [], "storms": [], "fail_launches": {}}
        for entry in spec.split(","):
            entry = entry.strip()
            if not entry:
                continue
            key, sep, val = entry.partition("=")
            if not sep:
                raise ValueError(f"fault spec entry {entry!r}: "
                                 "expected key=value")
            if key == "seed":
                kw["seed"] = int(val)
            elif key == "shrink":
                parts = [int(x) for x in val.split(":")]
                if len(parts) not in (3, 4):
                    raise ValueError(
                        f"shrink={val!r}: want TICK:TIER:BLOCKS[:RESTORE]")
                kw["shrinks"].append(Shrink(*parts))
            elif key == "storm":
                rng, _, gate = val.partition(":")
                start, sep2, end = rng.partition("-")
                if not sep2:
                    raise ValueError(
                        f"storm={val!r}: want START-END[:GATE]")
                kw["storms"].append(Storm(int(start), int(end),
                                          int(gate or 0)))
            elif key == "launch":
                prob, _, attempts = val.partition(":")
                kw["launch_fail_prob"] = float(prob)
                if attempts:
                    kw["launch_fail_attempts"] = int(attempts)
            elif key == "launchat":
                parts = [int(x) for x in val.split(":")]
                if len(parts) not in (2, 3):
                    raise ValueError(
                        f"launchat={val!r}: want TICK:TIER[:ATTEMPTS]")
                tick, tier = parts[0], parts[1]
                kw["fail_launches"][(tick, tier)] = (
                    parts[2] if len(parts) == 3 else 1)
            elif key == "slow":
                prob, sep2, secs = val.partition(":")
                if not sep2:
                    raise ValueError(f"slow={val!r}: want PROB:SECONDS")
                kw["slow_tick_prob"] = float(prob)
                kw["slow_tick_seconds"] = float(secs)
            else:
                raise ValueError(f"unknown fault spec key {key!r}")
        kw["shrinks"] = tuple(kw["shrinks"])
        kw["storms"] = tuple(kw["storms"])
        return cls(**kw)

    def describe(self) -> dict:
        """A json-able summary of the plan (recorded into run summaries)."""
        return {
            "seed": self.seed,
            "shrinks": [dataclasses.asdict(s) for s in self.shrinks],
            "storms": [dataclasses.asdict(s) for s in self.storms],
            "fail_launches": {f"{t}:{m}": n for (t, m), n
                              in self.fail_launches.items()},
            "launch_fail_prob": self.launch_fail_prob,
            "launch_fail_attempts": self.launch_fail_attempts,
            "slow_tick_prob": self.slow_tick_prob,
            "slow_tick_seconds": self.slow_tick_seconds,
        }
