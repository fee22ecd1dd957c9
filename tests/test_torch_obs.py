"""The port's observability (``repro_torch.obs``) and serving metrics against
the JAX package's, on the CPU: the registry, tracer, exposition and
metrics collector driven with the same scripted inputs through both
packages, the exposition held to the reference's golden file, and the
port's server traced: trace on equals trace off bit for bit, no step is
built by tracing or profiling, and the trace replays through the
repository's verifier (``benchmarks/verify_obs.py``).

Model: ``smoke_config("qwen2-1.5b", n_layers=2)``, fp32, the reference's
weights from ``PRNGKey(0)`` carried over by ``transformer.params_from_jax``;
prompts from a numpy seed. Tolerance: TOL = 1e-5 on uncertainties (one
fp32 forward pass a token); tokens equal.
"""

import contextlib
import dataclasses
import importlib.util
import math
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as j_registry
from repro.models import build_model as j_build_model
from repro.obs import export as j_export
from repro.obs import registry as j_reg
from repro.obs import trace as j_trace
from repro.serving.metrics import MetricsCollector as JMetricsCollector
from repro_torch.configs import registry as t_registry
from repro_torch.core import plan as t_plan
from repro_torch.models import model as t_model
from repro_torch.models import transformer as t_transformer
from repro_torch.obs import export as t_export
from repro_torch.obs import profile as t_profile
from repro_torch.obs import registry as t_reg
from repro_torch.obs import trace as t_trace
from repro_torch.serving import BayesianLMServer, QueueFullError, ServerConfig
from repro_torch.serving.metrics import MetricsCollector

TOL = 1e-5
DATA = pathlib.Path(__file__).parent / "data"
#: (registry module, export module) of each package, for the scripted
#: cases both must answer alike
PACKAGES = {"port": (t_reg, t_export), "reference": (j_reg, j_export)}


def _load_verify_obs():
    path = pathlib.Path(__file__).parent.parent / "benchmarks" / \
        "verify_obs.py"
    spec = importlib.util.spec_from_file_location("verify_obs", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _isolate_port_obs():
    """The port's twin of tests/conftest.py's isolation: the port's process
    registry values and tracer state are restored after every test."""
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
def small():
    cfg = t_registry.smoke_config("qwen2-1.5b", n_layers=2)
    jp = j_build_model(j_registry.smoke_config("qwen2-1.5b", n_layers=2)) \
        .init(jax.random.PRNGKey(0))
    params = t_transformer.params_from_jax(cfg, jax.tree.map(np.asarray, jp),
                                           device="cpu")
    return cfg, t_model.build_model(cfg), params


def _prompts(cfg, n, length=6, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (n, length))


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", PACKAGES)
def test_counter_gauge_histogram_basics(pkg):
    reg_lib, _ = PACKAGES[pkg]
    r = reg_lib.Registry()
    c = r.counter("c", "a counter", labels=("m",))
    c.inc(m="lm")
    c.inc(2.5, m="voxel")
    assert c.value(m="lm") == 1.0 and c.value(m="voxel") == 2.5
    assert c.total() == 3.5
    c.labels(m="lm").inc()
    assert c.value(m="lm") == 2.0
    g = r.gauge("g", "a gauge")
    assert math.isnan(g.value())              # honest "no data", not 0.0
    g.set(7)
    assert g.value() == 7.0
    h = r.histogram("h", "a histogram", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    st = h.values[()]
    assert st["buckets"] == [1, 2]            # cumulative per upper bound
    assert st["count"] == 3 and st["sum"] == pytest.approx(5.55)
    assert r.counter("c", labels=("m",)) is c
    with pytest.raises(ValueError):
        r.gauge("c")                          # kind mismatch
    with pytest.raises(ValueError):
        r.counter("c", labels=("other",))     # label-set mismatch
    with pytest.raises(ValueError):
        c.inc(wrong="x")                      # undeclared label
    assert t_reg.DEFAULT_BUCKETS == j_reg.DEFAULT_BUCKETS


@pytest.mark.parametrize("pkg", PACKAGES)
def test_registry_value_snapshot_reset(pkg):
    reg_lib, _ = PACKAGES[pkg]
    r = reg_lib.Registry()
    c = r.counter("total", labels=("k",))
    c.inc(k="a")
    c.inc(k="b")
    assert r.value("total") == 2.0
    assert r.value("absent") == 0.0
    snap = r.snapshot()
    assert snap["total"] == {"kind": "counter",
                             "values": {"k=a": 1.0, "k=b": 1.0}}
    r.reset()
    assert r.value("total") == 0.0            # values zeroed ...
    assert r.counter("total", labels=("k",)) is c   # ... registration kept


@pytest.mark.parametrize("pkg", PACKAGES)
def test_dump_restore_isolation(pkg):
    reg_lib, _ = PACKAGES[pkg]
    r = reg_lib.Registry()
    c = r.counter("n")
    c.inc()
    state = r.dump_state()
    c.inc(5)
    late = r.counter("late")
    late.inc()
    r.restore_state(state)
    assert c.total() == 1.0                   # rolled back
    assert late.total() == 0.0                # post-dump metric zeroed


def test_keyed_counter_is_the_build_counter():
    """The port's builds counter (the twin of the reference's
    ``fused_trace_total``/``retrace_total``) is a registered KeyedCounter
    with the mapping surface, exposition and snapshot."""
    kc = t_plan.build_counts
    assert isinstance(kc, t_reg.KeyedCounter)
    assert t_reg.REGISTRY.keyed_counter("step_builds_total") is kc
    key = ("test-obs-unique-kind", None, "decode")
    assert kc[key] == 0                       # Counter-style default
    kc[key] += 1
    kc[key] += 1
    assert kc[key] == 2 and key in kc and dict(kc.items())[key] == 2
    assert t_reg.key_str(key) == j_reg.key_str(key) \
        == "('test-obs-unique-kind', None, 'decode')"
    snap = t_reg.REGISTRY.snapshot()["step_builds_total"]
    assert snap["kind"] == "keyed_counter"
    assert snap["values"][t_reg.key_str(key)] == 2
    del kc[key]
    assert kc[key] == 0


def test_key_str_opaque_objects():
    class Spec:
        __hash__ = lambda self: 0xDEADBEEF          # noqa: E731
    assert t_reg.key_str(Spec()) == j_reg.key_str(Spec()) == "Spec#deadbeef"
    assert t_reg.key_str((1, "a", None)) == "(1, 'a', None)"


# ---------------------------------------------------------------------------
# exposition
# ---------------------------------------------------------------------------


def _golden_registry(reg_lib):
    """The reference test's golden registry content, on ``reg_lib``."""
    r = reg_lib.Registry()
    c = r.counter("requests_total", "work items enqueued",
                  labels=("modality",))
    c.inc(modality="lm")
    c.inc(3, modality="voxel")
    r.gauge("queue_depth", "queued items at last step").set(float("nan"))
    r.gauge("occupancy", "slot occupancy fraction",
            labels=("pool",)).set(0.5, pool="a")
    h = r.histogram("latency_seconds", "request latency",
                    buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    k = r.keyed_counter("traces_total", "jit traces by key")
    k[("spec", None, "decode")] += 2
    k["warm\nup"] += 1                        # exercises label escaping
    return r


def test_exposition_golden_file():
    text = t_export.prometheus_text(_golden_registry(t_reg))
    assert text == (DATA / "exposition_golden.txt").read_text()
    assert text == j_export.prometheus_text(_golden_registry(j_reg))


def test_exposition_parses_back():
    text = t_export.prometheus_text(_golden_registry(t_reg))
    samples = t_export.parse_exposition(text)
    assert samples[("requests_total", (("modality", "lm"),))] == 1.0
    assert samples[("requests_total", (("modality", "voxel"),))] == 3.0
    assert math.isnan(samples[("queue_depth", ())])
    assert samples[("occupancy", (("pool", "a"),))] == 0.5
    assert samples[("latency_seconds_bucket", (("le", "0.1"),))] == 1.0
    assert samples[("latency_seconds_bucket", (("le", "1"),))] == 2.0
    assert samples[("latency_seconds_bucket", (("le", "+Inf"),))] == 3.0
    assert samples[("latency_seconds_count", ())] == 3.0
    assert samples[("traces_total", (("key", "'warm\\nup'"),))] == 1.0
    want = j_export.parse_exposition(text)
    assert samples.keys() == want.keys()
    assert all(samples[k] == want[k] or math.isnan(want[k]) for k in want)


@pytest.mark.parametrize("text", ["no value here\n", "m{bad labels} 1\n",
                                  "m not_a_number\n"])
def test_parse_exposition_rejects_malformed(text):
    with pytest.raises(ValueError):
        t_export.parse_exposition(text)
    with pytest.raises(ValueError):
        j_export.parse_exposition(text)


def test_host_provenance():
    prov = t_export.host_provenance()
    assert prov == j_export.host_provenance()
    assert isinstance(prov["hostname"], str) and prov["hostname"]
    assert isinstance(prov["git_sha"], str) and len(prov["git_sha"]) == 40


# ---------------------------------------------------------------------------
# tracer
# ---------------------------------------------------------------------------


def _ticking():
    t = [0.0]

    def clock():
        t[0] += 1.0
        return t[0]
    return clock, t


def test_tracer_spans_nest_and_export():
    logs = {}
    for name, lib in (("port", t_trace), ("reference", j_trace)):
        clock, t = _ticking()
        tr = lib.Tracer(capacity=64, clock=clock)
        tr.event("dropped")                   # disabled: no record, no tick
        assert tr.events() == [] and t[0] == 0.0
        tr.enable()
        with tr.span("outer", a=1):
            tr.event("inside")
            with tr.span("inner"):
                pass
        logs[name] = tr.to_jsonl()
        evs = tr.events()
    assert [e["name"] for e in evs] == ["outer", "inside", "inner",
                                       "inner", "outer"]
    outer_id = evs[0]["span"]
    assert evs[0]["kind"] == "begin" and evs[0]["parent"] is None
    assert evs[1]["span"] == outer_id         # event inside outer
    assert evs[2]["parent"] == outer_id       # inner nests under outer
    assert evs[4] == {"t": 5.0, "name": "outer", "kind": "end",
                      "span": outer_id, "attrs": {}}
    assert len(logs["port"].splitlines()) == 5
    assert logs["port"] == logs["reference"]


def test_tracer_ring_bounded():
    tr = t_trace.Tracer(capacity=4)
    tr.enable()
    for i in range(10):
        tr.event("e", i=i)
    assert [e["attrs"]["i"] for e in tr.events()] == [6, 7, 8, 9]
    clk = t_trace.ManualClock(1.0)
    assert clk() == 1.0 and clk.advance(0.5) == 1.5 and clk() == 1.5
    with pytest.raises(ValueError):
        clk.advance(-1.0)


# ---------------------------------------------------------------------------
# metrics collector on the registry + injectable clock
# ---------------------------------------------------------------------------


def test_request_timeline_fake_clock():
    r = t_reg.Registry()
    clk = t_trace.ManualClock()
    mc = MetricsCollector(2, clock=clk, registry=r)
    mc.on_enqueue(0)
    clk.advance(1.0)
    mc.on_admit(0)
    clk.advance(1.5)
    mc.on_token(0)
    clk.advance(2.5)
    mc.on_finish(0)
    tl = mc.timelines[0]
    assert (tl.queue_wait, tl.ttft, tl.latency) == (1.0, 2.5, 5.0)
    mc.on_enqueue(1)                          # never admitted / finished
    tl1 = mc.timelines[1]
    assert tl1.queue_wait is None and tl1.ttft is None \
        and tl1.latency is None
    s = mc.summary()
    assert s.completed == 1 and s.requests == 2 and s.latency_p50_s == 5.0
    assert r.histogram("serving_request_latency_seconds",
                       labels=("modality",)).values[("lm",)]["count"] == 1


def _scripted_run(collector_cls, reg_lib):
    """A mixed LM + voxel script on a fresh registry and a manual clock."""
    r = reg_lib.Registry()
    clk = t_trace.ManualClock()
    mc = collector_cls(2, clock=clk, registry=r)
    for rid in (0, 1, 2):
        mc.on_enqueue(rid)
    mc.on_enqueue(3, modality="voxel")
    for rid in (0, 1):
        clk.advance(1.0)
        mc.on_admit(rid)
        mc.on_token(rid)
        mc.on_token(rid)
        mc.on_finish(rid, escalated=(rid == 1))
    mc.on_admit(3)
    mc.on_token(3, units=96)
    mc.on_finish(3)
    for _ in range(5):
        mc.on_step(2, 1, voxel_occupied=1)
    return mc.summary(), r


def test_summary_and_exposition_report_identical_totals():
    """The human summary and the exposition are two views of one
    double-entry collector — every total agrees, and the port's summary
    and exposition equal the reference's on the same script."""
    s, r = _scripted_run(MetricsCollector, t_reg)
    js, jr = _scripted_run(JMetricsCollector, j_reg)
    samples = t_export.parse_exposition(t_export.prometheus_text(r))

    def total(name):
        return sum(v for (n, _), v in samples.items() if n == name)

    assert total("serving_requests_total") == s.requests == 4
    assert samples[("serving_emissions_total",
                    (("modality", "lm"),))] == s.total_tokens == 4
    assert samples[("serving_emissions_total",
                    (("modality", "voxel"),))] == s.total_voxels == 96
    assert total("serving_finished_total") == s.completed == 3
    assert total("serving_escalated_total") == s.escalated == 1
    assert total("serving_decode_steps_total") == s.decode_steps == 5
    assert samples[("serving_queue_depth", ())] == 1.0
    assert samples[("serving_occupied_slots", ())] == 2.0
    txt = s.format()
    assert "3/4 completed (1 escalated)" in txt
    assert "4 tokens" in txt and "5 decode steps" in txt
    assert "96 voxels" in txt
    assert txt == js.format()
    assert dataclasses.astuple(s) == pytest.approx(dataclasses.astuple(js),
                                                   nan_ok=True)
    assert t_export.prometheus_text(r) == j_export.prometheus_text(jr)


# ---------------------------------------------------------------------------
# serving integration: bitwise invariance, verifier-clean lifecycle logs
# ---------------------------------------------------------------------------


def _run_lm(model, params, prompts, trace, tracer=None):
    srv = BayesianLMServer(model, params, ServerConfig(
        max_slots=2, max_prompt_len=8, max_new_tokens=4, trace=trace),
        device="cpu", tracer=tracer)
    rids = [srv.submit(p) for p in prompts]
    srv.run()
    return [(list(srv.result(r).generated),
             list(srv.result(r).uncertainty)) for r in rids]


def _builds() -> float:
    return t_reg.REGISTRY.value("step_builds_total")


def test_tracing_is_bitwise_invisible(small):
    """Tokens and uncertainties are bit-identical with tracing on vs off,
    the traced run builds no step, and both match the reference server's
    run on the same weights and prompts (tokens equal, rel-unc within
    TOL)."""
    cfg, model, params = small
    prompts = _prompts(cfg, 4)
    off = _run_lm(model, params, prompts, trace=False)
    b0 = _builds()
    t_trace.TRACER.configure(capacity=65536)
    on = _run_lm(model, params, prompts, trace=True)
    t_trace.TRACER.disable()
    assert _builds() == b0
    assert off == on                          # exact float equality
    from repro.serving import BayesianLMServer as JServer
    from repro.serving import ServerConfig as JServerConfig
    jcfg = j_registry.smoke_config("qwen2-1.5b", n_layers=2)
    jm = j_build_model(jcfg)
    jsrv = JServer(jm, jm.init(jax.random.PRNGKey(0)), JServerConfig(
        max_slots=2, max_prompt_len=8, max_new_tokens=4))
    rids = [jsrv.submit(p) for p in prompts]
    jsrv.run()
    for (gen, unc), r in zip(on, rids):
        st = jsrv.result(r)
        assert gen == st.generated
        np.testing.assert_allclose(unc, st.uncertainty, rtol=TOL, atol=TOL)


def test_server_trace_replays_through_verifier(small):
    cfg, model, params = small
    t_trace.TRACER.configure(capacity=65536)
    _run_lm(model, params, _prompts(cfg, 4), trace=True)
    t_trace.TRACER.disable()
    events = t_trace.TRACER.events()
    assert len(events) > 0
    names = {e["name"] for e in events}
    assert {"enqueue", "admit", "prefill", "step", "decode", "token",
            "finish"} <= names
    prefills = [e["attrs"] for e in events if e["name"] == "prefill"]
    assert len(prefills) == 4 and all(
        p == {"path": "bucketed", "bucket": 8, "length": 6}
        for p in prefills)
    verify_obs = _load_verify_obs()
    assert verify_obs.verify_trace_events(events) == []
    # the exposition side of the verifier, on the port's registry
    assert verify_obs.verify_metrics_text(
        t_export.prometheus_text(t_reg.REGISTRY)) == []


def test_queue_rejection_counted_and_traced(small):
    cfg, model, params = small
    before = t_reg.REGISTRY.value("serving_queue_rejections_total")
    tracer = t_trace.Tracer(capacity=256, enabled=True)
    srv = BayesianLMServer(model, params, ServerConfig(
        max_slots=2, max_queue=2, max_prompt_len=8, max_new_tokens=4),
        device="cpu", tracer=tracer)
    prompts = _prompts(cfg, 3)
    srv.submit(prompts[0])
    srv.submit(prompts[1])
    with pytest.raises(QueueFullError):
        srv.submit(prompts[2])
    assert t_reg.REGISTRY.value("serving_queue_rejections_total") \
        == before + 1
    rejects = [e for e in tracer.events() if e["name"] == "reject"]
    assert len(rejects) == 1 and rejects[0]["attrs"]["kind"] == "lm"
    srv.run()                                 # drain for cleanliness
    assert verify_clean(tracer.events())


def verify_clean(events) -> bool:
    return _load_verify_obs().verify_trace_events(events) == []


# ---------------------------------------------------------------------------
# profile annotations
# ---------------------------------------------------------------------------


def test_profile_annotate_guarded():
    was = t_profile.enabled()
    try:
        t_profile.disable()
        assert isinstance(t_profile.annotate("x"), contextlib.nullcontext)
        t_profile.enable()
        assert isinstance(t_profile.annotate("x"),
                          torch.profiler.record_function)
    finally:
        (t_profile.enable if was else t_profile.disable)()


def test_profile_adds_no_retraces(small):
    """Profiler ranges on: no step is built and the tokens do not move."""
    cfg, model, params = small
    prompts = _prompts(cfg, 2)
    want = _run_lm(model, params, prompts, trace=False)   # warm every step
    b0 = _builds()
    was = t_profile.enabled()
    try:
        t_profile.enable()
        got = _run_lm(model, params, prompts, trace=False)
    finally:
        (t_profile.enable if was else t_profile.disable)()
    assert _builds() == b0
    assert got == want
