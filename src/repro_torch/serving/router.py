"""Fault-tolerant multi-host serving: a router over per-host Bayesian LM
servers (the port's twin of ``repro.serving.router``).

One :class:`~repro_torch.serving.server.BayesianLMServer` caps the pool at a
single host, and a dead host is an outage. The router fronts N per-host
servers behind the same ``submit`` / ``submit_scan`` / ``step`` / ``run``
/ ``result`` surface (``engine.predict_volume(server=router)`` works
unchanged)::

    clients ──> ServingRouter ──sticky──> host 0: BayesianLMServer
                 │  health checks   └───> host 1: BayesianLMServer
                 │  retry/backoff   └───> host 2: BayesianLMServer
                 └─ StragglerMonitor + elastic.plan_remesh on loss

Scheduling. Each work item gets a *sticky home* host (round-robin over
accepting hosts) and is placed there immediately; when the home's
admission queue backpressures, placement *spills* to the next host
(``router_spills_total``), and when every host is full the item waits in
the router with bounded exponential backoff — degradation follows the
pool's escalation-policy surface (``flag`` keeps retrying, ``deprioritize``
retries at worsening priority, ``terminate`` sheds after the retry
budget) instead of erroring.

Fault tolerance. Hosts heartbeat on the injectable tracer clock
(``obs/trace.default_clock`` — nothing under ``serving/`` reads ``time.*``);
silence past ``heartbeat_timeout_s`` declares the host dead
(``router_host_deaths_total``) and its resident work is resubmitted with
bounded retry/backoff (``router_retries_total``). Resubmission is
idempotent: LM requests restart from their prompt and voxel scans resume
at their synced ``chunk_results`` cursor — exactly the single-host
``_preempt`` re-admission contract. Per-host step durations feed a
:class:`~repro_torch.distributed.straggler.StragglerMonitor`; persistent
straggling drains the host (queued work re-routed, resident decode
finishes in place) and host membership is recomputed through
``distributed.elastic.plan_remesh`` (``router_remesh_total``; the plan is
logged as a tracer event). Scripted failures come from an injectable
:class:`~repro_torch.serving.faults.FaultPlan`, so tests and the card's
smoke run replay identical scenarios.

Hosts. Every host is a ``BayesianLMServer`` on ``device`` in this process
(on one card they share the weights and the cached steps; each holds its
own pool). A multi-device mesh per host comes with the port's
``DeviceMesh`` layer.

Determinism. Pool rows are computed batch-independently (see
serving/server.py), so a request's tokens do not depend on which host —
or which co-residents — served it. On the CPU the recovered results are
therefore bit for bit those of an unfaulted single-host run. On the card
``fused_decode`` sums across blocks with float atomics, so a token near a
tie may differ from run to run; there the check is tokens and a tolerance.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable

import torch

from repro_torch import device as device_lib
from repro_torch.distributed import elastic
from repro_torch.distributed.straggler import StragglerMonitor
from repro_torch.obs import registry as obs_registry
from repro_torch.obs import trace as obs_trace
from repro_torch.serving.faults import FaultPlan
from repro_torch.serving.metrics import ServingSummary
from repro_torch.serving.server import (BayesianLMServer, QueueFullError,
                                        RequestState, ServerConfig)

__all__ = ["RouterConfig", "WorkRecord", "RouterSummary", "ServingRouter"]

# -- router telemetry (process registry; see repro_torch/obs/registry.py) ---
_DEATHS = obs_registry.REGISTRY.counter(
    "router_host_deaths_total",
    "hosts declared dead after missing heartbeats", labels=("host",))
_RETRIES = obs_registry.REGISTRY.counter(
    "router_retries_total",
    "work items resubmitted to a surviving host", labels=("reason",))
_SPILLS = obs_registry.REGISTRY.counter(
    "router_spills_total",
    "placements that overflowed a backpressured sticky home onto another "
    "host", labels=("home",))
_REMESH = obs_registry.REGISTRY.counter(
    "router_remesh_total",
    "elastic remesh decisions after host loss or straggler drain")
_SHED = obs_registry.REGISTRY.counter(
    "router_shed_total",
    "work items dropped by graceful degradation", labels=("reason",))
_HOST_STEPS = obs_registry.REGISTRY.counter(
    "router_host_steps_total", "engine iterations per host",
    labels=("host",))
_HOST_UNITS = obs_registry.REGISTRY.counter(
    "router_host_units_total",
    "work units (LM tokens / scan chunks) harvested per host",
    labels=("host", "modality"))


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    n_hosts: int = 2
    heartbeat_timeout_s: float = 5.0  # silence beyond this = host is dead
    max_retries: int = 3              # failover resubmits per work item
    backoff_steps: int = 1            # base retry backoff in router steps
                                      # (doubles per attempt, capped at 64x)
    max_pending: int | None = None    # router admission cap (in-flight work
                                      # items); None = n_hosts * max_queue
    straggler_window: int = 16        # per-host StragglerMonitor knobs —
    straggler_factor: float = 3.0     # persistent straggling escalates to
    straggler_patience: int = 3       # drain + remesh
    straggler_min_samples: int = 5
    trace: bool = False               # enable the process tracer

    def __post_init__(self) -> None:
        if self.n_hosts < 1:
            raise ValueError(f"n_hosts {self.n_hosts} < 1")
        if not self.heartbeat_timeout_s > 0:
            raise ValueError(
                f"heartbeat_timeout_s {self.heartbeat_timeout_s} <= 0")
        if self.max_retries < 0 or self.backoff_steps < 1:
            raise ValueError(
                f"max_retries {self.max_retries} must be >= 0 and "
                f"backoff_steps {self.backoff_steps} >= 1")


@dataclasses.dataclass
class _Host:
    """Router-side view of one serving host."""
    index: int
    server: BayesianLMServer
    monitor: StragglerMonitor
    last_beat: float
    alive: bool = True        # False once dead or fully drained out
    draining: bool = False    # no new placements; resident work finishes
    silenced: bool = False    # a kill fault has been observed (event dedup)
    steps: int = 0
    resident: set[int] = dataclasses.field(default_factory=set)

    @property
    def accepting(self) -> bool:
        return self.alive and not self.draining


@dataclasses.dataclass
class WorkRecord:
    """Router-side state of one work item: enough to resubmit it
    idempotently (LM: the prompt spec; voxel: the synced chunk cursor)
    plus the latest progress snapshot harvested from its host. Mirrors the
    result surface of :class:`~repro_torch.serving.server.RequestState`
    (``generated`` / ``uncertainty`` / ``scan_moments()``)."""
    rid: int
    kind: str                  # "lm" | "voxel"
    home: int                  # sticky host assignment
    spec: tuple                # resubmission payload
    priority: int
    status: str = "pending"    # pending|placed|done|escalated|shed|lost
    host: int | None = None
    attempts: int = 0          # failed placement rounds (backpressure)
    retries: int = 0           # failover resubmits (death / drain)
    next_try_step: int = 0
    effective_priority: int = 0
    submitted_step: int = 0
    generated: list[int] = dataclasses.field(default_factory=list)
    uncertainty: list[float] = dataclasses.field(default_factory=list)
    chunk_results: list = dataclasses.field(default_factory=list)
    final: RequestState | None = None

    @property
    def done(self) -> bool:
        """Terminal — completed, policy-terminated, or dropped."""
        return self.status in ("done", "escalated", "shed", "lost")

    @property
    def escalated(self) -> bool:
        return self.final is not None and self.final.escalated

    def scan_moments(self):
        """Reassemble a finished scan (result-surface parity with
        ``RequestState`` — ``engine.predict_volume(server=router)`` calls
        this)."""
        if self.final is None:
            raise ValueError(f"work item {self.rid} is {self.status}; "
                             f"no final state to reassemble")
        return self.final.scan_moments()


@dataclasses.dataclass(frozen=True)
class RouterSummary:
    """Aggregate outcome of one router run (per-host serving summaries
    come from :meth:`ServingRouter.host_summaries`)."""
    requests: int
    completed: int
    escalated: int
    shed: int
    lost: int
    retries: int
    spills: int
    host_deaths: int
    remeshes: int
    steps: int
    hosts_alive: int
    n_hosts: int
    total_tokens: int
    total_voxels: int
    wall_s: float
    recovery_steps: tuple[int, ...]   # per death event: steps from death
                                      # to every victim re-placed

    def format(self) -> str:
        worst = max(self.recovery_steps) if self.recovery_steps else 0
        return (f"router: {self.completed}/{self.requests} completed "
                f"({self.escalated} escalated, {self.shed} shed, "
                f"{self.lost} lost) on {self.hosts_alive}/{self.n_hosts} "
                f"hosts | {self.total_tokens} tokens, "
                f"{self.total_voxels} voxels in {self.steps} steps "
                f"({self.wall_s:.3f}s) | deaths {self.host_deaths}, "
                f"retries {self.retries}, spills {self.spills}, "
                f"remeshes {self.remeshes}, worst recovery {worst} steps")


class ServingRouter:
    """Route a request stream over N per-host servers — see the module
    docstring for the design.

        router = ServingRouter(model, params, ServerConfig(max_slots=4),
                               RouterConfig(n_hosts=3))
        rid = router.submit(prompt_tokens)
        router.run()
        rec = router.result(rid)      # .generated / .uncertainty / ...

    Every host serves on ``device`` (None -> the card; ``params`` must
    live there). ``clock`` defaults to ``obs.trace.default_clock``; fault
    scenarios with ``kill`` events should inject an ``obs.trace.ManualClock``
    and advance it between steps (``run(tick=...)``) so heartbeat timeouts
    elapse deterministically — and so a host step that builds a kernel, or
    one long admission among short decode steps, does not read as a dead
    host or a straggler."""

    def __init__(self, model, params, cfg: ServerConfig = ServerConfig(),
                 rcfg: RouterConfig = RouterConfig(), *,
                 device: torch.device | str | None = None,
                 faults: FaultPlan | None = None,
                 clock: Callable[[], float] | None = None,
                 tracer: obs_trace.Tracer | None = None) -> None:
        self.device = device_lib.resolve(device)
        self.cfg, self.rcfg = cfg, rcfg
        self.faults = faults if faults is not None else FaultPlan()
        self._clock = obs_trace.default_clock if clock is None else clock
        self._tracer = obs_trace.TRACER if tracer is None else tracer
        if rcfg.trace:
            self._tracer.enable()
        # every host is one single-device server: "pod" is the host axis
        self._mesh_shape = {"pod": rcfg.n_hosts, "data": 1, "model": 1}
        now = self._clock()
        self.hosts = [
            _Host(index=i,
                  server=BayesianLMServer(model, params, cfg,
                                          device=self.device, clock=clock,
                                          tracer=tracer),
                  monitor=StragglerMonitor(
                      window=rcfg.straggler_window,
                      straggler_factor=rcfg.straggler_factor,
                      patience=rcfg.straggler_patience,
                      min_samples=rcfg.straggler_min_samples),
                  last_beat=now)
            for i in range(rcfg.n_hosts)]
        self._max_pending = rcfg.max_pending if rcfg.max_pending \
            else rcfg.n_hosts * cfg.max_queue
        self._ids = itertools.count()
        self._rr = 0                       # round-robin home cursor
        self.records: dict[int, WorkRecord] = {}
        self._pending: set[int] = set()    # rids awaiting (re)placement
        self.step_i = 0
        self.remeshes: list[elastic.RemeshPlan] = []
        self._recoveries: list[dict] = []
        # per-router tallies (the registry counters are process-global and
        # shared across routers; summaries must be per-router)
        self.n_retries = self.n_spills = self.n_deaths = 0
        self.n_remeshes = self.n_shed = self.n_lost = 0
        self._t0: float | None = None
        self._t_end: float | None = None

    # ---- admission ---------------------------------------------------------
    def submit(self, tokens, *, max_new_tokens: int | None = None,
               priority: int = 0) -> int:
        """Route ONE prompt: sticky round-robin home, immediate placement
        (spilling to another host when the home backpressures), router
        retry with backoff when every host is full."""
        self._admission_check()
        rec = WorkRecord(rid=next(self._ids), kind="lm",
                         home=self._next_home(),
                         spec=(tokens, max_new_tokens), priority=priority,
                         effective_priority=priority,
                         submitted_step=self.step_i)
        return self._register(rec)

    def submit_scan(self, plan, x, *, chunk: int = 4096, priority: int = 0,
                    fused: bool | None = None) -> int:
        """Route ONE clinical scan (same contract as
        ``BayesianLMServer.submit_scan``; failover resumes it at the
        synced chunk cursor)."""
        self._admission_check()
        rec = WorkRecord(rid=next(self._ids), kind="voxel",
                         home=self._next_home(),
                         spec=(plan, x, chunk, fused),
                         priority=priority, effective_priority=priority,
                         submitted_step=self.step_i)
        return self._register(rec)

    def _admission_check(self) -> None:
        if not any(h.accepting for h in self.hosts):
            raise RuntimeError(
                "no accepting hosts (all dead or draining)")
        inflight = sum(1 for r in self.records.values() if not r.done)
        if inflight >= self._max_pending:
            self._tracer.event("reject", kind="router", inflight=inflight)
            raise QueueFullError(
                f"router at max_pending ({self._max_pending} in flight)")

    def _next_home(self) -> int:
        accepting = [h.index for h in self.hosts if h.accepting]
        home = accepting[self._rr % len(accepting)]
        self._rr += 1
        return home

    def _register(self, rec: WorkRecord) -> int:
        self.records[rec.rid] = rec
        if self._t0 is None:
            self._t0 = self._clock()
        self._tracer.event("route", req_id=rec.rid, kind=rec.kind,
                           home=rec.home)
        if not self._place(rec):
            self._defer(rec, reason="backpressure")
        return rec.rid

    # ---- placement ---------------------------------------------------------
    def _place(self, rec: WorkRecord) -> bool:
        """Try the sticky home first, then spill across the other hosts in
        index order; returns False when every accepting host
        backpressures."""
        order = [rec.home] + [h.index for h in self.hosts
                              if h.index != rec.home]
        for hidx in order:
            hs = self.hosts[hidx]
            if not hs.accepting:
                continue
            try:
                if rec.kind == "lm":
                    tokens, mnt = rec.spec
                    hs.server.submit(tokens, max_new_tokens=mnt,
                                     priority=rec.effective_priority,
                                     req_id=rec.rid)
                else:
                    plan, x, chunk, fused = rec.spec
                    hs.server.submit_scan(
                        plan, x, chunk=chunk,
                        priority=rec.effective_priority,
                        fused=fused, req_id=rec.rid,
                        resume_results=rec.chunk_results or None)
            except QueueFullError:
                continue
            except Exception:
                if rec.attempts == 0 and rec.retries == 0:
                    # invalid request, not backpressure: don't keep a
                    # record the caller was told failed to submit
                    del self.records[rec.rid]
                raise
            rec.status, rec.host = "placed", hidx
            hs.resident.add(rec.rid)
            self._pending.discard(rec.rid)
            if hidx != rec.home:
                self.n_spills += 1
                _SPILLS.inc(home=str(rec.home))
                self._tracer.event("spill", req_id=rec.rid,
                                   home=rec.home, host=hidx)
            self._recovery_account(rec.rid)
            return True
        return False

    def _defer(self, rec: WorkRecord, reason: str) -> None:
        """Graceful degradation instead of erroring: requeue in the router
        with bounded exponential backoff, shaped by the pool's escalation
        policy — ``deprioritize`` worsens the item's priority each round,
        and ``terminate`` sheds it once the retry budget is spent."""
        rec.attempts += 1
        if self.cfg.escalation_policy == "terminate" and \
                rec.attempts > self.rcfg.max_retries:
            self._shed(rec, reason=reason)
            return
        if self.cfg.escalation_policy == "deprioritize":
            rec.effective_priority += self.cfg.deprioritize_penalty
        rec.status, rec.host = "pending", None
        rec.next_try_step = self.step_i + self.rcfg.backoff_steps * \
            (1 << min(rec.attempts - 1, 6))
        self._pending.add(rec.rid)
        self._tracer.event("defer", req_id=rec.rid, reason=reason,
                           retry_at=rec.next_try_step,
                           priority=rec.effective_priority)

    def _shed(self, rec: WorkRecord, reason: str) -> None:
        rec.status, rec.host = "shed", None
        self._pending.discard(rec.rid)
        self.n_shed += 1
        _SHED.inc(reason=reason)
        self._tracer.event("shed", req_id=rec.rid, reason=reason,
                           terminal="shed", attempts=rec.attempts)
        self._recovery_account(rec.rid)

    def _lose(self, rec: WorkRecord, reason: str) -> None:
        rec.status, rec.host = "lost", None
        self._pending.discard(rec.rid)
        self.n_lost += 1
        _SHED.inc(reason=reason)
        self._tracer.event("shed", req_id=rec.rid, reason=reason,
                           terminal="lost", retries=rec.retries)
        self._recovery_account(rec.rid)

    # ---- the router iteration ----------------------------------------------
    def step(self) -> bool:
        """One router iteration: place deferred work whose backoff
        expired, step every live host (with fault injection), harvest
        progress, heartbeat health checks, straggler escalation. Returns
        False once fully idle."""
        i, tr = self.step_i, self._tracer
        # (1) deferred placements whose backoff expired, priority order
        due = sorted((r for r in self._pending
                      if self.records[r].next_try_step <= i),
                     key=lambda r: (self.records[r].effective_priority, r))
        for rid in due:
            rec = self.records[rid]
            if not self._place(rec):
                if not any(h.accepting for h in self.hosts):
                    break          # capacity is gone; handled at (4)
                self._defer(rec, reason="backpressure")
        # (2) step hosts under the fault plan, harvest, heartbeat
        for hs in self.hosts:
            if not hs.alive:
                continue
            if self.faults.killed(hs.index, i):
                if not hs.silenced:
                    hs.silenced = True
                    tr.event("fault_kill", host=hs.index, step=i)
                continue           # silent: no step, no heartbeat
            t0 = self._clock()
            with tr.span("host_step", host=hs.index, step=i):
                hs.server.step()
            dt = (self._clock() - t0) + self.faults.delay(hs.index, i)
            hs.steps += 1
            _HOST_STEPS.inc(host=str(hs.index))
            if self.faults.drops(hs.index, i):
                # transient partition: the step ran but nothing came back
                # — no heartbeat, no harvest, no straggler sample. Harvest
                # is a full-state sync, so the next undropped step
                # recovers everything this one computed.
                tr.event("fault_drop", host=hs.index, step=i)
                continue
            hs.last_beat = self._clock()
            rep = hs.monitor.report(hs.steps, dt)
            if rep.is_outlier:
                tr.event("straggle", host=hs.index, severity=rep.severity,
                         duration_s=dt, median_s=rep.median_s)
            self._harvest(hs)
            if hs.monitor.should_escalate and hs.accepting and \
                    sum(1 for h in self.hosts if h.accepting) > 1:
                # the last accepting host is never drained — a straggler
                # with nowhere to send work beats no capacity at all
                self._drain_host(hs)
            if hs.draining and hs.alive and not hs.resident and \
                    hs.server.occupied_slots == 0:
                hs.alive = False
                tr.event("host_retired", host=hs.index)
        # (3) heartbeat health check
        now = self._clock()
        for hs in self.hosts:
            if hs.alive and \
                    now - hs.last_beat > self.rcfg.heartbeat_timeout_s:
                self._handle_death(hs, reason="heartbeat_timeout")
        self.step_i += 1
        # (4) liveness
        if self._pending and not any(h.accepting for h in self.hosts):
            # graceful termination, not a hang: capacity is gone for good
            for rid in sorted(self._pending):
                self._lose(self.records[rid], reason="no_hosts")
        busy = any(h.alive and (h.resident or h.server.queue_depth
                                or h.server.occupied_slots)
                   for h in self.hosts)
        return busy or bool(self._pending)

    def _harvest(self, hs: _Host) -> None:
        """Sync per-request progress from a host. Copies are full
        snapshots (idempotent — a re-sync after dropped reports converges
        to the same state), and finished work is popped into the router
        record so host memory stays bounded."""
        for rid in sorted(hs.resident):
            st = hs.server.states.get(rid)
            if st is None:
                continue
            rec = self.records[rid]
            if rec.kind == "lm":
                delta = len(st.generated) - len(rec.generated)
                modality = "lm"
                rec.generated = list(st.generated)
            else:
                delta = len(st.chunk_results) - len(rec.chunk_results)
                modality = "voxel"
                rec.chunk_results = list(st.chunk_results)
            rec.uncertainty = list(st.uncertainty)
            if delta > 0:
                _HOST_UNITS.inc(delta, host=str(hs.index),
                                modality=modality)
            if st.status in ("done", "escalated"):
                rec.final = hs.server.pop_result(rid)
                rec.status = st.status
                rec.host = None
                hs.resident.discard(rid)
                self._t_end = self._clock()

    # ---- failure handling --------------------------------------------------
    def _handle_death(self, hs: _Host, reason: str) -> None:
        """A host missed its heartbeat window: declare it dead, resubmit
        every resident work item, and remesh the surviving pool."""
        with self._tracer.span("host_death", host=hs.index, reason=reason,
                               step=self.step_i):
            hs.alive = False
            hs.draining = True
            self.n_deaths += 1
            _DEATHS.inc(host=str(hs.index))
            victims = sorted(hs.resident)
            hs.resident.clear()
            for rid in victims:
                self._resubmit(self.records[rid], from_host=hs.index,
                               reason=reason)
            if victims:
                self._recoveries.append(
                    {"step": self.step_i, "host": hs.index,
                     "waiting": set(victims), "recovered_step": None})
            self._remesh(reason=f"host_death:{hs.index}")

    def _resubmit(self, rec: WorkRecord, *, from_host: int,
                  reason: str) -> None:
        """Bounded retry-with-backoff failover. Idempotent by
        construction: an LM request restarts from its prompt (pool rows
        are batch-independent, so the regenerated tokens are
        bitwise-identical) and a voxel scan resumes at its synced
        ``chunk_results`` cursor — the single-host ``_preempt`` contract,
        across hosts."""
        rec.host = None
        rec.retries += 1
        if rec.retries > self.rcfg.max_retries:
            self._lose(rec, reason="retries_exhausted")
            return
        self.n_retries += 1
        _RETRIES.inc(reason=reason)
        self._tracer.event(
            "retry", req_id=rec.rid, from_host=from_host,
            attempt=rec.retries, kind=rec.kind, reason=reason,
            cursor=(len(rec.chunk_results) if rec.kind == "voxel"
                    else len(rec.generated)))
        rec.status = "pending"
        rec.next_try_step = self.step_i + self.rcfg.backoff_steps * \
            (1 << min(rec.retries - 1, 6))
        self._pending.add(rec.rid)

    def _drain_host(self, hs: _Host) -> None:
        """Persistent straggler: stop placing new work on the host,
        re-route its queued items (resident decode state is host-local and
        finishes in place), and remesh around it. Once empty it retires."""
        with self._tracer.span("straggler_drain", host=hs.index,
                               step=self.step_i):
            hs.draining = True
            self._reassign_queued(hs, reason="straggler_drain")
            self._remesh(reason=f"straggler:{hs.index}")

    def _reassign_queued(self, hs: _Host, reason: str) -> None:
        for rid in sorted(hs.resident):
            st = hs.server.states.get(rid)
            if st is None or st.status != "queued":
                continue
            hs.server.cancel(rid)
            hs.resident.discard(rid)
            self._resubmit(self.records[rid], from_host=hs.index,
                           reason=reason)

    def _remesh(self, reason: str) -> None:
        """Recompute host membership on the surviving pool via
        ``distributed.elastic.plan_remesh`` ("pod" is the host axis). The
        plan is recorded, counted, and logged as a tracer event; hosts
        beyond the planned pod extent drain out."""
        active = [h for h in self.hosts if h.accepting]
        try:
            plan = elastic.plan_remesh(self._mesh_shape,
                                       n_alive=len(active))
        except ValueError as e:
            self._tracer.event("remesh_failed", reason=reason,
                               error=str(e))
            return
        self.n_remeshes += 1
        _REMESH.inc()
        self.remeshes.append(plan)
        self._tracer.event(
            "remesh", reason=reason, old_shape=str(plan.old_shape),
            new_shape=str(plan.new_shape), n_alive=plan.n_alive,
            dropped_chips=plan.dropped_chips,
            reshard_required=plan.reshard_required, note=plan.note)
        self._mesh_shape = dict(plan.new_shape)
        for hs in active[plan.new_shape.get("pod", len(active)):]:
            if hs.accepting:
                self._tracer.event("host_dropped", host=hs.index,
                                   reason="remesh")
                hs.draining = True
                self._reassign_queued(hs, reason="remesh")

    def _recovery_account(self, rid: int) -> None:
        """A victim of a host death reached a new placement (or a terminal
        state): close out recovery windows it was holding open."""
        for recov in self._recoveries:
            if recov["recovered_step"] is None:
                recov["waiting"].discard(rid)
                if not recov["waiting"]:
                    recov["recovered_step"] = self.step_i

    # ---- results & reporting -----------------------------------------------
    @property
    def queue_depth(self) -> int:
        return sum(h.server.queue_depth for h in self.hosts if h.alive) \
            + len(self._pending)

    @property
    def occupied_slots(self) -> int:
        return sum(h.server.occupied_slots for h in self.hosts if h.alive)

    def result(self, req_id: int) -> WorkRecord:
        return self.records[req_id]

    def host_summaries(self) -> list[ServingSummary]:
        """Per-host serving summaries (latency percentiles, occupancy) —
        the pooled view lives in :meth:`summary`."""
        return [h.server.metrics.summary() for h in self.hosts]

    def summary(self) -> RouterSummary:
        recs = list(self.records.values())
        wall = 0.0
        if self._t0 is not None and self._t_end is not None:
            wall = max(0.0, self._t_end - self._t0)
        return RouterSummary(
            requests=len(recs),
            completed=sum(r.status == "done" for r in recs),
            escalated=sum(r.status == "escalated" for r in recs),
            shed=sum(r.status == "shed" for r in recs),
            lost=sum(r.status == "lost" for r in recs),
            retries=self.n_retries, spills=self.n_spills,
            host_deaths=self.n_deaths, remeshes=self.n_remeshes,
            steps=self.step_i,
            hosts_alive=sum(h.alive for h in self.hosts),
            n_hosts=len(self.hosts),
            total_tokens=sum(len(r.generated) for r in recs
                             if r.kind == "lm"),
            total_voxels=sum(r.final.request.n_voxels for r in recs
                             if r.kind == "voxel" and r.final is not None
                             and r.status == "done"),
            wall_s=wall,
            recovery_steps=tuple(
                r["recovered_step"] - r["step"] for r in self._recoveries
                if r["recovered_step"] is not None))

    def run(self, max_steps: int | None = None,
            tick: Callable[[], None] | None = None) -> RouterSummary:
        """Drive :meth:`step` until every work item is terminal (or
        ``max_steps``). ``tick`` runs after each step — advance a
        ``ManualClock`` there when replaying fault scenarios, so heartbeat
        timeouts elapse in deterministic virtual time."""
        steps = 0
        while any(not r.done for r in self.records.values()):
            if max_steps is not None and steps >= max_steps:
                break
            self.step()
            if tick is not None:
                tick()
            steps += 1
        return self.summary()
