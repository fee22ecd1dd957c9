"""Straggler detection & mitigation policy (the port's copy of
``repro.distributed.straggler``).

Host-side step-time telemetry: per-step durations (optionally per-host, when
the launcher aggregates them) feed a robust outlier detector (median +
k*MAD). Persistent stragglers trigger a mitigation escalation:

  1. log + tolerate (transient: GC pause, network blip),
  2. rebalance work away from the slow host,
  3. declare the host unhealthy -> elastic.plan_remesh.

The detector is pure; ``serving.router`` feeds it per-host step times on
the router's injectable clock.
"""

from __future__ import annotations

import dataclasses
import statistics
from collections import deque

__all__ = ["StragglerMonitor", "StepReport"]


@dataclasses.dataclass(frozen=True)
class StepReport:
    step: int
    duration_s: float
    is_outlier: bool
    severity: str            # "ok" | "slow" | "straggler"
    median_s: float


@dataclasses.dataclass
class StragglerMonitor:
    """Sliding-window robust outlier detection on step times.

    ``min_samples`` is the explicit warm-up threshold: a report is judged
    only once at least ``min_samples`` *prior* samples exist, so the first
    ``min_samples`` reports are always "ok" and the first judged sample is
    compared against a median of exactly ``min_samples`` earlier steps.
    (This replaces an implicit ``len > 5``-after-append guard that reached
    the same first judged step but was neither documented nor tunable.)

    ``should_escalate`` is edge-triggered, not latching: when ``patience``
    consecutive straggler reports accumulate, a pending-escalation flag is
    set and the consecutive counter resets; the next ``report()`` clears
    the flag. The decision is therefore visible exactly between the
    triggering report and the following one, and re-escalation requires a
    fresh run of ``patience`` stragglers — a monitor that escalated once
    does not demand a remesh forever after.
    """
    window: int = 50
    slow_factor: float = 1.5        # > median * f -> "slow"
    straggler_factor: float = 3.0   # > median * f -> "straggler"
    patience: int = 3               # consecutive stragglers before escalation
    min_samples: int = 5            # prior samples required before judging

    def __post_init__(self):
        if self.min_samples < 1:
            raise ValueError(f"min_samples {self.min_samples} < 1")
        self._times: deque[float] = deque(maxlen=self.window)
        self._consecutive = 0
        self._pending = False

    def report(self, step: int, duration_s: float) -> StepReport:
        self._pending = False
        med = (statistics.median(self._times) if self._times
               else duration_s)
        warm = len(self._times) >= self.min_samples
        self._times.append(duration_s)
        if warm and duration_s > med * self.straggler_factor:
            self._consecutive += 1
            sev = "straggler"
            if self._consecutive >= self.patience:
                self._pending = True
                self._consecutive = 0
        elif warm and duration_s > med * self.slow_factor:
            self._consecutive = 0
            sev = "slow"
        else:
            self._consecutive = 0
            sev = "ok"
        return StepReport(step=step, duration_s=duration_s,
                          is_outlier=sev != "ok", severity=sev, median_s=med)

    @property
    def should_escalate(self) -> bool:
        """True when persistent straggling warrants a remesh (policy step 3);
        cleared by the next ``report()`` — see the class docstring."""
        return self._pending
