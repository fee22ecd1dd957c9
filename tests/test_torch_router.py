"""The port's fault-tolerant multi-host router (``repro_torch.serving.
router``) on the CPU: the fault-injection harness, routing, spill and
shed, failover, the straggler drain and remesh, the pool-client surface,
tracing, and the server hooks it builds on — the twins of
tests/test_router.py — and the port's router against the reference's in
lockstep under the same fault plans.

Within the port, bit for bit (the reference's claim, held again here): a
host killed mid-decode yields tokens AND uncertainties equal to an
unfaulted single-host ``BayesianLMServer``, and a killed host's scan
resumes at its chunk cursor with moments equal to the direct
``predict_volume``. Across the two packages: tokens, statuses, homes,
hosts, retries, deaths, remesh plans, summaries and the order of trace
events equal after every router step; rel-unc within TOL = 1e-5 (the
port's LM tests' bar); scan moments within TOL_MOMENTS = 2e-4 (the port's
IVIM tests' bar).

Models: ``smoke_config("qwen2-1.5b", n_layers=2)``, fp32, the reference's
weights from ``PRNGKey(0)`` carried over by ``transformer.params_from_jax``;
uIVIM-NET at ``IvimConfig(n_masks=4, scale=2.0)`` from ``PRNGKey(0)``
carried over by ``ivim.model.params_from_jax``; prompts and voxels from
numpy seeds. Registry counters are process-global: tests read deltas.
"""

import dataclasses
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as j_registry
from repro.ivim import model as j_ivim
from repro.models import build_model as j_build_model
from repro.obs import trace as j_trace
from repro.serving import FaultEvent as JFaultEvent
from repro.serving import FaultPlan as JFaultPlan
from repro.serving import RouterConfig as JRouterConfig
from repro.serving import ServerConfig as JServerConfig
from repro.serving import ServingRouter as JRouter
from repro_torch.configs import registry as t_registry
from repro_torch.ivim import model as t_ivim
from repro_torch.models import model as t_model
from repro_torch.models import transformer as t_transformer
from repro_torch.obs import registry as t_reg
from repro_torch.obs import trace as t_trace
from repro_torch.obs.trace import ManualClock
from repro_torch.serving import (BayesianLMServer, FaultEvent, FaultPlan,
                                 QueueFullError, RouterConfig, ServerConfig,
                                 ServingRouter, engine)

TOL = 1e-5
TOL_MOMENTS = 2e-4
CPU = "cpu"


@pytest.fixture(autouse=True)
def _isolate_port_obs():
    """The port's registry values and tracer state are restored after every
    test (tests/conftest.py does the same for the reference's)."""
    state = t_reg.REGISTRY.dump_state()
    was_enabled = t_trace.TRACER.enabled
    try:
        yield
    finally:
        t_reg.REGISTRY.restore_state(state)
        if not was_enabled:
            t_trace.TRACER.disable()
            t_trace.TRACER.clear()


@pytest.fixture(scope="module")
def lm():
    jcfg = j_registry.smoke_config("qwen2-1.5b", n_layers=2)
    tcfg = t_registry.smoke_config("qwen2-1.5b", n_layers=2)
    jp = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    tp = t_transformer.params_from_jax(tcfg, jax.tree.map(np.asarray, jp),
                                       device=CPU)
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def small(lm):
    _, tcfg, _, tp = lm
    return tcfg, t_model.build_model(tcfg), tp


@pytest.fixture(scope="module")
def ivim():
    """(reference plan, port plan, width) of one uIVIM-NET's weights."""
    jcfg = j_ivim.IvimConfig(n_masks=4, scale=2.0)
    params, state = j_ivim.init(jcfg, jax.random.PRNGKey(0))
    tcfg = t_ivim.IvimConfig(n_masks=4, scale=2.0)
    model = t_ivim.params_from_jax(tcfg, jax.tree.map(np.asarray, params),
                                   jax.tree.map(np.asarray, state),
                                   device=CPU)
    return j_ivim.pack_for_serving(jcfg, params, state), \
        t_ivim.pack_for_serving(model), tcfg.width


def _prompts(cfg, n, length=6, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (n, length))


def _voxels(shape, seed):
    return np.random.default_rng(seed).uniform(0.2, 1.1, shape) \
        .astype(np.float32)


def _scfg(**kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("max_prompt_len", 8)
    kw.setdefault("max_new_tokens", 4)
    return kw


def _router(model, params, scfg=None, faults=None, **rkw):
    clock = ManualClock()
    rkw.setdefault("n_hosts", 3)
    rkw.setdefault("heartbeat_timeout_s", 2.5)
    router = ServingRouter(model, params, ServerConfig(**(scfg or _scfg())),
                           RouterConfig(**rkw), device=CPU, faults=faults,
                           clock=clock)
    return router, clock


def _single_host_reference(model, params, prompts, scfg=None):
    srv = BayesianLMServer(model, params, ServerConfig(**(scfg or _scfg())),
                           device=CPU)
    rids = [srv.submit(p) for p in prompts]
    srv.run()
    return [(list(srv.result(r).generated), list(srv.result(r).uncertainty))
            for r in rids]


def _load_verify_obs():
    path = pathlib.Path(__file__).parent.parent / "benchmarks" / \
        "verify_obs.py"
    spec = importlib.util.spec_from_file_location("verify_obs", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# the fault-injection harness
# ---------------------------------------------------------------------------


def test_fault_plan_validation_and_queries():
    with pytest.raises(ValueError, match="unknown fault action"):
        FaultEvent(step=0, host=0, action="melt")
    with pytest.raises(ValueError, match="delay_s > 0"):
        FaultEvent(step=0, host=0, action="delay")
    with pytest.raises(ValueError, match="span"):
        FaultEvent(step=0, host=0, action="drop", span=0)
    with pytest.raises(ValueError, match="step/host"):
        FaultEvent(step=-1, host=0, action="kill")
    plan = FaultPlan(events=(
        FaultEvent(step=5, host=1, action="kill"),
        FaultEvent(step=2, host=0, action="drop", span=2),
        FaultEvent(step=3, host=2, action="delay", delay_s=1.5, span=2)))
    # kill is permanent from its step; drop/delay cover [step, step+span)
    assert not plan.killed(1, 4) and plan.killed(1, 5) and plan.killed(1, 99)
    assert plan.kill_step(1) == 5 and plan.kill_step(0) is None
    assert not plan.drops(0, 1) and plan.drops(0, 2) and plan.drops(0, 3) \
        and not plan.drops(0, 4)
    assert plan.delay(2, 2) == 0.0 and plan.delay(2, 4) == 1.5
    # events are normalized into (step, host) order
    assert [e.step for e in plan.events] == [2, 3, 5]


def test_fault_plan_seeded_deterministic_and_bounded():
    a = FaultPlan.seeded(7, n_hosts=3, horizon=40)
    b = FaultPlan.seeded(7, n_hosts=3, horizon=40)
    assert a == b                       # same seed -> same scenario
    assert a != FaultPlan.seeded(8, n_hosts=3, horizon=40)
    kills = [e for e in a.events if e.action == "kill"]
    assert len(kills) == 1
    assert 10 <= kills[0].step < 30     # middle half of the horizon
    with pytest.raises(ValueError, match="kill all hosts"):
        FaultPlan.seeded(0, n_hosts=2, horizon=40, n_kills=2)
    with pytest.raises(ValueError, match="horizon"):
        FaultPlan.seeded(0, n_hosts=2, horizon=3)


@pytest.mark.parametrize("seed", range(8))
def test_fault_plan_seeded_matches_reference(seed):
    """``random.Random`` is reproducible across platforms, so the port's
    seeded plan is the reference's, event for event."""
    for kw in (dict(n_hosts=3, horizon=40),
               dict(n_hosts=5, horizon=97, n_kills=2, n_drops=3, n_delays=2,
                    delay_s=0.5)):
        got = FaultPlan.seeded(seed, **kw)
        want = JFaultPlan.seeded(seed, **kw)
        assert got.seed == want.seed == seed
        assert [dataclasses.astuple(e) for e in got.events] == \
            [dataclasses.astuple(e) for e in want.events]
        for host in range(kw["n_hosts"]):
            assert got.kill_step(host) == want.kill_step(host)
            for step in range(kw["horizon"]):
                assert (got.killed(host, step), got.drops(host, step),
                        got.delay(host, step)) == \
                    (want.killed(host, step), want.drops(host, step),
                     want.delay(host, step))


# ---------------------------------------------------------------------------
# routing basics
# ---------------------------------------------------------------------------


def test_router_no_faults_matches_single_host(small):
    """Multi-host routing is invisible to results: every request's tokens
    and uncertainties are bitwise those of a single-host pool (rows are
    batch-independent, and every host runs the same pool shape)."""
    cfg, model, params = small
    prompts = _prompts(cfg, 5)
    ref = _single_host_reference(model, params, prompts)
    router, clock = _router(model, params, n_hosts=2)
    rids = [router.submit(p) for p in prompts]
    s = router.run(tick=lambda: clock.advance(1.0))
    assert s.completed == 5 and s.lost == 0 and s.shed == 0
    assert s.host_deaths == 0 and s.retries == 0
    # sticky round-robin homes over both hosts
    assert {router.result(r).home for r in rids} == {0, 1}
    for r, (toks, unc) in zip(rids, ref):
        rec = router.result(r)
        assert rec.status == "done"
        assert rec.generated == toks
        assert rec.uncertainty == unc
    assert router.queue_depth == 0 and router.occupied_slots == 0
    assert len(router.host_summaries()) == 2
    assert all(h.server.device == torch.device(CPU) for h in router.hosts)
    assert "5/5 completed" in s.format()


def test_router_config_validation(small):
    with pytest.raises(ValueError, match="n_hosts"):
        RouterConfig(n_hosts=0)
    with pytest.raises(ValueError, match="heartbeat"):
        RouterConfig(heartbeat_timeout_s=0.0)
    with pytest.raises(ValueError, match="backoff"):
        RouterConfig(backoff_steps=0)


def test_router_spill_on_home_backpressure(small):
    """A full sticky home overflows onto another host instead of
    rejecting (counted per home in router_spills_total)."""
    cfg, model, params = small
    router, clock = _router(model, params, _scfg(max_slots=1, max_queue=1),
                            n_hosts=2)
    p = _prompts(cfg, 2)
    a = router.submit(p[0])              # home 0, placed on host 0
    router._rr = 0                       # pin the next home back to host 0
    before = t_reg.REGISTRY.value("router_spills_total")
    b = router.submit(p[1])              # home 0 is full -> spills to 1
    assert router.result(a).host == 0
    assert router.result(b).home == 0 and router.result(b).host == 1
    assert router.n_spills == 1
    assert t_reg.REGISTRY.value("router_spills_total") == before + 1
    s = router.run(tick=lambda: clock.advance(1.0))
    assert s.completed == 2 and s.spills == 1


def test_router_shed_under_pressure_terminate_policy(small):
    """Graceful degradation: with every host saturated, the terminate
    escalation policy sheds overflow work (counted, traced, terminal)
    instead of erroring — and the shed request stays queryable."""
    cfg, model, params = small
    scfg = _scfg(max_slots=1, max_queue=1, escalation_policy="terminate")
    router, clock = _router(model, params, scfg, n_hosts=2, max_retries=0,
                            max_pending=16)
    shed0 = t_reg.REGISTRY.value("router_shed_total")
    rids = [router.submit(q) for q in _prompts(cfg, 5)]
    shed = [r for r in rids if router.result(r).status == "shed"]
    assert len(shed) == 3 and router.n_shed == 3
    assert t_reg.REGISTRY.value("router_shed_total") == shed0 + 3
    s = router.run(tick=lambda: clock.advance(1.0))
    assert s.shed == 3 and s.completed == 2 and s.lost == 0
    assert all(router.result(r).done for r in shed)


def test_router_deprioritize_policy_degrades_not_sheds(small):
    """The deprioritize policy keeps overflow work alive at worsening
    priority: it waits out the backpressure and completes."""
    cfg, model, params = small
    scfg = _scfg(max_slots=1, max_queue=1, escalation_policy="deprioritize")
    router, clock = _router(model, params, scfg, n_hosts=2, max_retries=3,
                            max_pending=16)
    rids = [router.submit(q) for q in _prompts(cfg, 5)]
    overflow = [r for r in rids if router.result(r).status == "pending"]
    assert overflow and all(
        router.result(r).effective_priority > 0 for r in overflow)
    s = router.run(tick=lambda: clock.advance(1.0))
    assert s.completed == 5 and s.shed == 0 and s.lost == 0


def test_router_admission_guards(small):
    cfg, model, params = small
    router, clock = _router(model, params, n_hosts=2, max_pending=2)
    p = _prompts(cfg, 3)
    router.submit(p[0])
    router.submit(p[1])
    with pytest.raises(QueueFullError, match="max_pending"):
        router.submit(p[2])
    router.run(tick=lambda: clock.advance(1.0))
    router.submit(p[2])                  # capacity freed -> admits again
    with pytest.raises(ValueError, match="prompt length"):
        router.submit(np.zeros(99, np.int64))
    assert len(router.records) == 3      # the invalid one left no record


# ---------------------------------------------------------------------------
# failover
# ---------------------------------------------------------------------------


def test_kill_host_mid_decode_bitwise_identical(small):
    """The acceptance scenario: a host killed mid-decode is declared dead
    by heartbeat, its resident requests are resubmitted, and every
    recovered request's tokens AND uncertainties are bitwise those of an
    unfaulted single-host run. Counters reflect exactly one death."""
    cfg, model, params = small
    prompts = _prompts(cfg, 6)
    ref = _single_host_reference(model, params, prompts)
    deaths0 = t_reg.REGISTRY.value("router_host_deaths_total")
    retries0 = t_reg.REGISTRY.value("router_retries_total")
    # host 1 goes silent at step 2 — mid-decode for its residents
    faults = FaultPlan(events=(FaultEvent(step=2, host=1, action="kill"),))
    router, clock = _router(model, params, faults=faults, max_retries=3)
    rids = [router.submit(p) for p in prompts]
    assert any(router.result(r).home == 1 for r in rids)
    s = router.run(max_steps=300, tick=lambda: clock.advance(1.0))
    assert s.host_deaths == 1 and s.lost == 0 and s.shed == 0
    assert s.retries >= 1                # the dead host held work
    assert s.remeshes >= 1 and router.remeshes[0].new_shape["pod"] == 2
    assert s.completed == len(prompts)
    assert s.hosts_alive == 2
    assert s.recovery_steps and all(r >= 0 for r in s.recovery_steps)
    assert t_reg.REGISTRY.value("router_host_deaths_total") == deaths0 + 1
    assert t_reg.REGISTRY.value("router_retries_total") == \
        retries0 + s.retries
    for r, (toks, unc) in zip(rids, ref):
        rec = router.result(r)
        assert rec.status == "done"
        assert rec.generated == toks     # bitwise: failover is invisible
        assert rec.uncertainty == unc


def test_kill_host_mid_scan_resumes_at_chunk_cursor(small, ivim):
    """Voxel failover is a cross-host ``_preempt``: the resubmitted scan
    resumes at its synced chunk cursor (chunks computed before the death
    are carried over BY IDENTITY, not recomputed) and the reassembled
    moments are bitwise the direct predict_packed path's."""
    _, model, params = small
    _, plan, width = ivim
    x = torch.from_numpy(_voxels((96, width), 3))
    direct = engine.predict_packed(plan, x, chunk=16, device=CPU)
    faults = FaultPlan(events=(FaultEvent(step=3, host=0, action="kill"),))
    router, clock = _router(model, params, faults=faults, max_retries=3)
    router._rr = 0                       # scan's sticky home = host 0
    rid = router.submit_scan(plan, x, chunk=16)   # 6 chunks
    rec = router.result(rid)
    assert rec.home == 0
    first_chunk = None
    for _ in range(300):
        busy = router.step()
        clock.advance(1.0)
        if first_chunk is None and rec.chunk_results:
            first_chunk = rec.chunk_results[0]
        if not busy and rec.done:
            break
    s = router.summary()
    assert s.host_deaths == 1 and s.retries >= 1 and s.lost == 0
    assert rec.status == "done" and rec.host is None
    assert rec.final.chunk_results[0] is first_chunk   # resumed, not redone
    mean, std = rec.scan_moments()
    assert torch.equal(mean, direct[0]) and torch.equal(std, direct[1])
    assert s.total_voxels == 96


def test_all_hosts_dead_loses_work_without_hanging(small):
    """When the last host dies, pending work is terminally lost (counted,
    traced) and run() returns instead of spinning; new admissions are
    refused loudly."""
    cfg, model, params = small
    faults = FaultPlan(events=(FaultEvent(step=1, host=0, action="kill"),
                               FaultEvent(step=1, host=1, action="kill")))
    router, clock = _router(model, params, n_hosts=2, faults=faults,
                            max_retries=3)
    p = _prompts(cfg, 4)
    rids = [router.submit(q) for q in p]
    s = router.run(max_steps=300, tick=lambda: clock.advance(1.0))
    assert s.host_deaths == 2 and s.hosts_alive == 0
    assert s.completed + s.lost == 4 and s.lost >= 1
    assert all(router.result(r).done for r in rids)
    with pytest.raises(RuntimeError, match="no accepting hosts"):
        router.submit(p[0])


def test_straggler_drain_escalates_to_remesh(small):
    """A scripted persistent delay on one host drives the monitor's
    straggle -> drain -> plan_remesh escalation: the host stops taking
    work, membership is recomputed (pod axis shrinks), and results are
    unchanged."""
    cfg, model, params = small
    prompts = _prompts(cfg, 6)
    ref = _single_host_reference(model, params, prompts, _scfg(max_slots=1))
    # healthy steps take 0 virtual seconds on the ManualClock, so a
    # scripted 2s delay is an unambiguous outlier once the monitor warms;
    # one slot per host keeps the run long enough for the delay window
    faults = FaultPlan(events=(
        FaultEvent(step=2, host=0, action="delay", delay_s=2.0, span=4),))
    remesh0 = t_reg.REGISTRY.value("router_remesh_total")
    router, clock = _router(model, params, _scfg(max_slots=1),
                            faults=faults, straggler_min_samples=2,
                            straggler_patience=2, straggler_window=8)
    rids = [router.submit(p) for p in prompts]
    s = router.run(max_steps=300, tick=lambda: clock.advance(1.0))
    assert s.remeshes >= 1
    assert t_reg.REGISTRY.value("router_remesh_total") == \
        remesh0 + s.remeshes
    assert router.remeshes[0].new_shape["pod"] == 2    # 3 hosts -> 2
    assert not router.hosts[0].accepting               # drained out
    assert s.host_deaths == 0                          # slow, not dead
    assert s.completed == len(prompts) and s.lost == 0 and s.shed == 0
    for r, (toks, unc) in zip(rids, ref):
        assert router.result(r).generated == toks
        assert router.result(r).uncertainty == unc


def test_drop_faults_are_transient_and_lossless(small):
    """Dropped step reports (a partition shorter than the heartbeat
    timeout) delay harvesting but lose nothing: no deaths, no retries,
    bitwise-identical results."""
    cfg, model, params = small
    prompts = _prompts(cfg, 4)
    ref = _single_host_reference(model, params, prompts)
    faults = FaultPlan(events=(
        FaultEvent(step=1, host=0, action="drop", span=2),
        FaultEvent(step=2, host=1, action="drop", span=1)))
    router, clock = _router(model, params, faults=faults)
    rids = [router.submit(p) for p in prompts]
    s = router.run(max_steps=300, tick=lambda: clock.advance(1.0))
    assert s.host_deaths == 0 and s.retries == 0 and s.lost == 0
    assert s.completed == 4
    for r, (toks, unc) in zip(rids, ref):
        assert router.result(r).generated == toks
        assert router.result(r).uncertainty == unc


# ---------------------------------------------------------------------------
# surfaces: engine client, tracing, server hooks
# ---------------------------------------------------------------------------


def test_predict_volume_accepts_router_as_server(small, ivim):
    """The router duck-types the pool-client surface, so
    engine.predict_volume(server=router) serves a scan through the
    multi-host pool bit for bit as the direct path does."""
    _, model, params = small
    _, plan, width = ivim
    vol = torch.from_numpy(_voxels((4, 8, width), 5))
    direct = engine.predict_volume(plan, vol, chunk=16, device=CPU)
    router, _ = _router(model, params, n_hosts=2)
    b0 = t_reg.REGISTRY.value("step_builds_total")
    pooled = engine.predict_volume(plan, vol, chunk=16, server=router)
    assert t_reg.REGISTRY.value("step_builds_total") == b0
    assert torch.equal(pooled[0], direct[0])
    assert torch.equal(pooled[1], direct[1])
    assert pooled[0].shape == (4, 8, 4)


def test_traced_chaos_run_is_bitwise_and_verifier_clean(small):
    """Tracing a faulted run changes nothing (bitwise tokens, no step
    built) and the span log satisfies verify_obs's failover lifecycle
    (host death -> retry -> re-admit)."""
    verify_obs = _load_verify_obs()
    cfg, model, params = small
    prompts = _prompts(cfg, 5)
    faults = FaultPlan(events=(FaultEvent(step=2, host=2, action="kill"),))

    def scenario():
        router, clock = _router(model, params, faults=faults, max_retries=3)
        rids = [router.submit(p) for p in prompts]
        router.run(max_steps=300, tick=lambda: clock.advance(1.0))
        return [(router.result(r).generated, router.result(r).uncertainty)
                for r in rids], router.summary()

    plain_toks, plain_s = scenario()
    tracer = t_trace.TRACER
    tracer.clear()
    b0 = t_reg.REGISTRY.value("step_builds_total")
    tracer.enable()
    try:
        traced_toks, traced_s = scenario()
        events = tracer.events()
    finally:
        tracer.disable()
    assert traced_toks == plain_toks          # tracing is invisible
    assert t_reg.REGISTRY.value("step_builds_total") == b0
    assert traced_s.host_deaths == plain_s.host_deaths == 1
    assert verify_obs.verify_trace_events(events) == []
    names = {e["name"] for e in events}
    assert {"host_death", "retry", "enqueue", "remesh", "route",
            "fault_kill", "host_step"} <= names


def test_server_req_id_pinning_and_cancel(small, ivim):
    """The per-host hooks the router builds on: caller-pinned request ids
    (one global id space across hosts), duplicate-id rejection, queued-
    only cancel with tombstone-corrected queue depth, and scan
    resume_results: validated, and a resumed scan runs only the chunks
    past its cursor, in order, to the direct path's moments."""
    cfg, model, params = small
    _, plan, width = ivim
    srv = BayesianLMServer(model, params, ServerConfig(**_scfg()),
                           device=CPU)
    p = _prompts(cfg, 3)
    assert srv.submit(p[0], req_id=7) == 7
    with pytest.raises(ValueError, match="already tracked"):
        srv.submit(p[1], req_id=7)
    rid = srv.submit(p[1], req_id=9)
    assert srv.queue_depth == 2
    srv.cancel(rid)
    assert srv.queue_depth == 1 and rid not in srv.states
    with pytest.raises(ValueError, match="unknown"):
        srv.cancel(rid)
    srv.run()
    st = srv.result(7)
    assert st.status == "done" and len(st.generated) == 4
    with pytest.raises(ValueError, match="not queued"):
        srv.cancel(7)

    x = torch.from_numpy(_voxels((40, width), 0))
    with pytest.raises(ValueError, match="nothing left to run"):
        srv.submit_scan(plan, x[:32], chunk=16,
                        resume_results=[object(), object()])
    direct = engine.predict_packed(plan, x, chunk=16, device=CPU)
    full = srv.submit_scan(plan, x, chunk=16, req_id=20)
    srv.run()
    done = srv.result(full).chunk_results
    resumed = srv.submit_scan(plan, x, chunk=16, req_id=21,
                              resume_results=done[:2])
    runs = []
    runner = srv.states[resumed].request.runner
    srv.states[resumed] = dataclasses.replace(
        srv.states[resumed], request=dataclasses.replace(
            srv.states[resumed].request,
            runner=lambda xc: runs.append(1) or runner(xc)))
    srv.run()
    st = srv.result(resumed)
    assert len(runs) == 1 and st.chunk_results[:2] == done[:2]
    assert st.chunk_results[0][0] is done[0][0]
    mean, std = st.scan_moments()
    assert torch.equal(mean, direct[0]) and torch.equal(std, direct[1])


# ---------------------------------------------------------------------------
# the port's router against the reference's router, in lockstep
# ---------------------------------------------------------------------------

#: scenario -> (ServerConfig overrides, RouterConfig overrides, fault
#: events as (step, host, action, delay_s, span), LM prompts, scan chunks)
SCENARIOS = {
    "none": ({}, {}, (), 5, 0),
    "kill_decode": ({}, {}, ((2, 1, "kill", 0.0, 1),), 6, 0),
    "kill_scan": ({}, {}, ((3, 0, "kill", 0.0, 1),), 3, 6),
    "straggler": (dict(max_slots=1),
                  dict(straggler_min_samples=2, straggler_patience=2,
                       straggler_window=8),
                  ((2, 0, "delay", 2.0, 4),), 6, 0),
    "drops": ({}, {}, ((1, 0, "drop", 0.0, 2), (2, 1, "drop", 0.0, 1)), 4,
              0),
}


def _host_view(router):
    return [(h.alive, h.draining, h.silenced, h.steps, sorted(h.resident),
             h.server.queue_depth, h.server.occupied_slots)
            for h in router.hosts]


def _record_view(rec):
    return (rec.kind, rec.home, rec.status, rec.host, rec.attempts,
            rec.retries, rec.next_try_step, rec.effective_priority,
            rec.submitted_step, list(rec.generated), len(rec.chunk_results))


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_router_matches_reference_router(lm, small, ivim, scenario):
    """Same weights, prompts, scan, ServerConfig, RouterConfig and fault
    events through both routers, each on its own ManualClock advanced 1 s a
    step, stepped in lockstep: after every step the busy flags, every
    host's state, every record's status, home, host, attempts and retries,
    the death/retry/spill/remesh/shed/loss tallies, the remesh plans and the
    summary are equal; at the end the tokens are equal, rel-unc within TOL,
    scan moments within TOL_MOMENTS, and both routers' trace records carry
    the same names in the same order."""
    jcfg, _, jp, _ = lm
    _, model, params = small
    jplan, plan, width = ivim
    srv_kw, r_kw, events, n_lm, n_chunks = SCENARIOS[scenario]
    scfg = _scfg(**srv_kw)
    r_kw = dict(n_hosts=3, heartbeat_timeout_s=2.5, max_retries=3, **r_kw)
    j_clock, t_clock = j_trace.ManualClock(), ManualClock()
    j_tr = j_trace.Tracer(enabled=True, clock=j_clock)
    t_tr = t_trace.Tracer(enabled=True, clock=t_clock)
    jr = JRouter(j_build_model(jcfg), jp, JServerConfig(**scfg),
                 JRouterConfig(**r_kw),
                 faults=JFaultPlan(events=tuple(
                     JFaultEvent(step=s, host=h, action=a, delay_s=d, span=n)
                     for s, h, a, d, n in events)),
                 clock=j_clock, tracer=j_tr)
    tr = ServingRouter(model, params, ServerConfig(**scfg),
                       RouterConfig(**r_kw), device=CPU,
                       faults=FaultPlan(events=tuple(
                           FaultEvent(step=s, host=h, action=a, delay_s=d,
                                      span=n) for s, h, a, d, n in events)),
                       clock=t_clock, tracer=t_tr)
    rids = []
    if n_chunks:
        x = _voxels((16 * n_chunks - 5, width), 3)
        rids.append(tr.submit_scan(plan, torch.from_numpy(x), chunk=16))
        assert jr.submit_scan(jplan, jnp.asarray(x), chunk=16,
                              backend="xla") == rids[-1]
    for p in _prompts(small[0], n_lm):
        rids.append(tr.submit(p))
        assert jr.submit(p) == rids[-1]
    steps = 0
    while any(not r.done for r in jr.records.values()):
        assert steps < 300
        busy = jr.step()
        assert tr.step() == busy
        j_clock.advance(1.0)
        t_clock.advance(1.0)
        steps += 1
        assert _host_view(tr) == _host_view(jr), steps
        for r in rids:
            assert _record_view(tr.result(r)) == _record_view(jr.result(r)), \
                (steps, r)
        assert (tr.n_deaths, tr.n_retries, tr.n_spills, tr.n_remeshes,
                tr.n_shed, tr.n_lost, sorted(tr._pending)) == \
            (jr.n_deaths, jr.n_retries, jr.n_spills, jr.n_remeshes,
             jr.n_shed, jr.n_lost, sorted(jr._pending))
        assert [dataclasses.asdict(p) for p in tr.remeshes] == \
            [dataclasses.asdict(p) for p in jr.remeshes]
        assert dataclasses.asdict(tr.summary()) == \
            dataclasses.asdict(jr.summary())
    assert steps > 0
    for r in rids:
        t_rec, j_rec = tr.result(r), jr.result(r)
        assert t_rec.status == j_rec.status == "done"
        assert t_rec.generated == j_rec.generated
        np.testing.assert_allclose(t_rec.uncertainty, j_rec.uncertainty,
                                   rtol=TOL, atol=TOL)
        if t_rec.kind == "voxel":
            for got, want in zip(t_rec.scan_moments(), j_rec.scan_moments()):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=TOL_MOMENTS,
                                           atol=TOL_MOMENTS)
    s = tr.summary()
    assert s.host_deaths == sum(a == "kill" for _, _, a, _, _ in events)
    if scenario == "straggler":
        assert s.remeshes >= 1 and s.host_deaths == 0
    if scenario.startswith("kill"):
        assert s.retries >= 1 and s.remeshes >= 1
    assert [(e["name"], e["kind"]) for e in t_tr.events()] == \
        [(e["name"], e["kind"]) for e in j_tr.events()]
    assert _load_verify_obs().verify_trace_events(t_tr.events()) == []
