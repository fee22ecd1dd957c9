"""Deterministic fault injection for the multi-host serving router (the
port's copy of ``repro.serving.faults``: the same events and the same
seeded plans).

A :class:`FaultPlan` is *data*, not behaviour: an immutable script of
:class:`FaultEvent` records indexed by router step. The router queries the
plan at each step (``killed`` / ``delay`` / ``drops``) and reacts exactly
as it would to a real failure — the plan itself never touches server
state. Because the plan, the arrival trace, and the router's virtual
clock are all pure functions of their seeds, a scenario replays bitwise
identically in tests and on the card (``chip_smoke.py``'s router phase),
which share scenarios through this module.

Actions:

* ``kill``  — the host goes permanently silent from ``step`` on: its
  engine stops iterating and it misses every heartbeat, until the
  router's health check declares it dead and resubmits its resident work
  (LM requests restart from their prompt, scans resume at their synced
  chunk cursor).
* ``delay`` — ``delay_s`` is added to the host's measured step duration
  for ``span`` consecutive steps; this feeds the per-host
  ``StragglerMonitor``, so a scripted persistent delay drives the
  straggler -> drain -> remesh escalation.
* ``drop``  — the host steps, but its results and heartbeat are withheld
  for ``span`` steps (a transient network partition). Harvesting is a
  full-state sync, so everything a dropped step computed is recovered by
  the next undropped one.

Standard library only (``random.Random`` is specified to be reproducible
across platforms and Python versions for the methods used here, so
``FaultPlan.seeded`` gives the reference's plan for the same seed).
"""

from __future__ import annotations

import dataclasses
import random

__all__ = ["FaultEvent", "FaultPlan"]

_ACTIONS = ("kill", "delay", "drop")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scripted fault: ``action`` on ``host`` starting at router step
    ``step``. ``kill`` is permanent from its step; ``delay``/``drop``
    cover ``span`` consecutive steps."""
    step: int
    host: int
    action: str
    delay_s: float = 0.0
    span: int = 1

    def __post_init__(self) -> None:
        if self.action not in _ACTIONS:
            raise ValueError(f"unknown fault action {self.action!r} "
                             f"(expected one of {_ACTIONS})")
        if self.step < 0 or self.host < 0:
            raise ValueError(f"step/host must be >= 0, got "
                             f"step={self.step} host={self.host}")
        if self.span < 1:
            raise ValueError(f"span {self.span} < 1")
        if self.action == "delay" and not self.delay_s > 0:
            raise ValueError(
                f"delay event needs delay_s > 0, got {self.delay_s}")

    def covers(self, step: int) -> bool:
        if self.action == "kill":
            return step >= self.step
        return self.step <= step < self.step + self.span


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An immutable scripted fault scenario (``seed`` records provenance
    when the plan came from :meth:`seeded`). The empty plan is the
    no-fault default the router runs with."""
    events: tuple[FaultEvent, ...] = ()
    seed: int | None = None

    def __post_init__(self) -> None:
        object.__setattr__(
            self, "events",
            tuple(sorted(self.events, key=lambda e: (e.step, e.host))))

    # -- queries the router makes each step ---------------------------------
    def killed(self, host: int, step: int) -> bool:
        return any(e.host == host and e.action == "kill" and e.covers(step)
                   for e in self.events)

    def kill_step(self, host: int) -> int | None:
        steps = [e.step for e in self.events
                 if e.host == host and e.action == "kill"]
        return min(steps) if steps else None

    def delay(self, host: int, step: int) -> float:
        return sum(e.delay_s for e in self.events
                   if e.host == host and e.action == "delay"
                   and e.covers(step))

    def drops(self, host: int, step: int) -> bool:
        return any(e.host == host and e.action == "drop" and e.covers(step)
                   for e in self.events)

    @classmethod
    def seeded(cls, seed: int, n_hosts: int, horizon: int, *,
               n_kills: int = 1, n_drops: int = 2, n_delays: int = 1,
               delay_s: float = 1.0) -> "FaultPlan":
        """Deterministic scenario generator: the same seed yields the same
        plan everywhere. Kills land in the middle half of ``horizon``
        (mid-run, not at the edges); drops and delays anywhere within it.
        Refuses to kill every host — a scenario with no surviving capacity
        is an outage script, not a failover test (script one explicitly
        with ``FaultPlan(events=...)`` if that is the point)."""
        if n_hosts < 1 or horizon < 4:
            raise ValueError(f"need n_hosts >= 1 and horizon >= 4, got "
                             f"n_hosts={n_hosts} horizon={horizon}")
        if n_kills >= n_hosts:
            raise ValueError(f"refusing to kill all hosts ({n_kills} "
                             f"kills on {n_hosts} hosts)")
        rng = random.Random(seed)
        events = [
            FaultEvent(step=rng.randrange(horizon // 4,
                                          max(horizon // 4 + 1,
                                              3 * horizon // 4)),
                       host=victim, action="kill")
            for victim in rng.sample(range(n_hosts), n_kills)]
        for _ in range(n_drops):
            events.append(FaultEvent(step=rng.randrange(horizon),
                                     host=rng.randrange(n_hosts),
                                     action="drop",
                                     span=rng.randrange(1, 3)))
        for _ in range(n_delays):
            events.append(FaultEvent(step=rng.randrange(horizon),
                                     host=rng.randrange(n_hosts),
                                     action="delay", delay_s=delay_s,
                                     span=rng.randrange(1, 4)))
        return cls(events=tuple(events), seed=seed)
