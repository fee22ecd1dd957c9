"""The port's mixed-modality pool against the JAX package's, on the CPU:
voxel-chunk work items riding the LM slot pool, bucketed prefill with its
build bound, and the shared admission and escalation surface.

Within the port, bit for bit: a scan served through the pool equals the
direct ``predict_volume``. A bucketed prefill equals the exact one within
TOL = 1e-5 here (bit for bit on the card). Across the two packages: the
port's pooled scan against the reference's pooled scan (its XLA tier)
within TOL_MOMENTS = 2e-4 (the port's IVIM tests' bar, the reference's own
fused-vs-per-op tolerance); statuses, chunk counts and escalations equal.

Models: ``smoke_config("qwen2-1.5b", n_layers=2)``, fp32, the reference's
weights from ``PRNGKey(0)`` carried over by ``transformer.params_from_jax``;
uIVIM-NET at ``IvimConfig(n_masks=4, scale=2.0)`` from ``PRNGKey(0)``
carried over by ``ivim.model.params_from_jax``; voxels and prompts from
numpy seeds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as j_registry
from repro.core import plan as j_plan
from repro.core import scheduler as j_scheduler
from repro.ivim import model as j_ivim
from repro.models import build_model as j_build_model
from repro.serving import BayesianLMServer as JServer
from repro.serving import ServerConfig as JServerConfig
from repro_torch.configs import registry as t_registry
from repro_torch.core import plan as t_plan
from repro_torch.core import scheduler as t_scheduler
from repro_torch.ivim import model as t_ivim
from repro_torch.models import model as t_model
from repro_torch.models import transformer as t_transformer
from repro_torch.obs import registry as t_reg
from repro_torch.serving import (BayesianLMServer, QueueFullError,
                                 ServerConfig, VoxelScanRequest, engine,
                                 step_fns)

TOL = 1e-5
TOL_MOMENTS = 2e-4
CPU = "cpu"


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
    jplan = j_ivim.pack_for_serving(jcfg, params, state)
    tcfg = t_ivim.IvimConfig(n_masks=4, scale=2.0)
    model = t_ivim.params_from_jax(tcfg, jax.tree.map(np.asarray, params),
                                   jax.tree.map(np.asarray, state),
                                   device=CPU)
    return jplan, t_ivim.pack_for_serving(model), tcfg.width


def _voxels(shape, seed):
    return np.random.default_rng(seed).uniform(0.2, 1.1, shape) \
        .astype(np.float32)


def _prompts(cfg, n, length=6, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (n, length))


def _server(model, params, **kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("max_prompt_len", 8)
    kw.setdefault("max_new_tokens", 4)
    return BayesianLMServer(model, params, ServerConfig(**kw), device=CPU)


def _equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


# ---------------------------------------------------------------------------
# voxel-chunk admission: pooled == direct, bitwise
# ---------------------------------------------------------------------------


def test_pooled_volume_bitwise_matches_direct(small, ivim):
    """predict_volume through the pool (one voxel-chunk work item, one
    chunk per engine step) returns moments bit-identical to the direct
    streamed path — both run the one plan_chunk_runner over the same
    chunk_bounds partition — and the scan never touches the KV pool."""
    _, model, params = small
    _, plan, width = ivim
    vol = torch.from_numpy(_voxels((5, 3, 2, width), 3))
    direct = engine.predict_volume(plan, vol, chunk=7, device=CPU)
    srv = _server(model, params)
    b0 = t_reg.REGISTRY.value("step_builds_total")
    pooled = engine.predict_volume(plan, vol, chunk=7, server=srv)
    assert t_reg.REGISTRY.value("step_builds_total") == b0   # reused
    _equal(pooled, direct)
    assert pooled[0].shape == (5, 3, 2, 4)
    assert srv.occupied_slots == 0 and srv.queue_depth == 0
    assert bool((srv._caches[0]["b0"]["kpos"] == -1).all())
    assert srv.metrics.summary().total_voxels == 30


def test_pooled_scan_matches_reference(lm, small, ivim):
    """The port's pooled scan against the reference's pooled scan on the
    same weights and voxels: moments within TOL_MOMENTS, the same chunk
    count and per-chunk flags, under LM traffic in the same pool."""
    jcfg, tcfg, jp, _ = lm
    _, model, params = small
    jplan, plan, width = ivim
    x = _voxels((23, width), 4)
    prompts = _prompts(tcfg, 2)
    kw = dict(max_slots=2, max_prompt_len=8, max_new_tokens=4)
    jsrv = JServer(j_build_model(jcfg), jp, JServerConfig(**kw))
    tsrv = _server(model, params)
    out = {}
    for name, srv, arr in (("ref", jsrv, jnp.asarray(x)),
                           ("port", tsrv, torch.from_numpy(x))):
        r0 = srv.submit(prompts[0])
        extra = dict(backend="xla") if name == "ref" else {}
        rs = srv.submit_scan(jplan if name == "ref" else plan, arr, chunk=5,
                             **extra)
        r1 = srv.submit(prompts[1])
        srv.run()
        out[name] = (srv.result(rs), srv.result(r0), srv.result(r1))
    (ts, t0, t1), (js, j0, j1) = out["port"], out["ref"]
    assert ts.status == js.status == "done"
    assert len(ts.chunk_results) == len(js.chunk_results) == 5
    assert ts.flags == js.flags
    for got, want in zip(ts.scan_moments(), js.scan_moments()):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=TOL_MOMENTS, atol=TOL_MOMENTS)
    assert (t0.generated, t1.generated) == (j0.generated, j1.generated)


def test_mixed_traffic_one_pool(small, ivim):
    """LM requests and a scan share the queue, the slots and the metrics
    stream — and neither modality perturbs the other's results."""
    cfg, model, params = small
    _, plan, width = ivim
    x = torch.from_numpy(_voxels((11, width), 5))
    want_m, want_s = engine.predict_packed(plan, x, chunk=4, device=CPU)
    prompts = _prompts(cfg, 2)
    solo = _server(model, params)
    want_gen = []
    for p in prompts:
        r = solo.submit(p)
        solo.run()
        want_gen.append(solo.result(r).generated)

    srv = _server(model, params, max_slots=2)
    r0 = srv.submit(prompts[0])
    rs = srv.submit_scan(plan, x, chunk=4)
    r1 = srv.submit(prompts[1])
    summary = srv.run()
    st = srv.result(rs)
    assert st.kind == "voxel" and st.status == "done"
    assert isinstance(st.request, VoxelScanRequest)
    _equal(st.scan_moments(), (want_m, want_s))
    assert srv.result(r0).generated == want_gen[0]
    assert srv.result(r1).generated == want_gen[1]
    assert summary.lm_requests == 2 and summary.voxel_requests == 1
    assert summary.total_voxels == 11 and summary.total_tokens == 8
    assert summary.voxels_per_s > 0
    assert max(srv.metrics.voxel_occupancy_samples) == 1
    tl = srv.metrics.timelines
    assert tl[rs].modality == "voxel" and tl[r0].modality == "lm"
    with pytest.raises(ValueError):
        srv.result(r0).scan_moments()           # an LM item is no scan


def test_scan_admission_requires_matching_schedule(small):
    """A plan whose mask count does not map onto the pool layout is
    rejected at submit time, not at chunk time."""
    _, model, params = small
    icfg = t_ivim.IvimConfig(n_masks=8, scale=2.0)     # pool has 4
    plan = t_ivim.pack_for_serving(t_ivim.init(
        icfg, torch.Generator().manual_seed(0), device=CPU))
    srv = _server(model, params)
    with pytest.raises(ValueError, match="n_masks must match"):
        srv.submit_scan(plan, torch.zeros((4, icfg.width)))


def test_scan_backpressure_shared_queue(small, ivim):
    """Scans count against the same max_queue as LM requests."""
    cfg, model, params = small
    _, plan, width = ivim
    before = t_reg.REGISTRY.value("serving_queue_rejections_total")
    srv = _server(model, params, max_queue=2)
    srv.submit(_prompts(cfg, 1)[0])
    srv.submit_scan(plan, torch.zeros((4, width)), chunk=2)
    with pytest.raises(QueueFullError):
        srv.submit_scan(plan, torch.zeros((4, width)), chunk=2)
    assert t_reg.REGISTRY.value("serving_queue_rejections_total") \
        == before + 1
    with pytest.raises(ValueError):
        srv.submit_scan(plan, torch.zeros((4, width, 2)))  # not [n, D]


# ---------------------------------------------------------------------------
# preemption: chunks never complete out of order
# ---------------------------------------------------------------------------


def test_voxel_preempt_requeue_in_order(small, ivim):
    """Deprioritize preempts a flagged scan *between* chunks and resumes it
    at the next unprocessed chunk — chunk results stay in scan order, and
    the reassembled moments still equal the direct path bit for bit."""
    cfg, model, params = small
    _, plan, width = ivim
    x = torch.from_numpy(_voxels((10, width), 7))
    want = engine.predict_packed(plan, x, chunk=3, device=CPU)
    srv = _server(model, params, max_slots=1, max_queue=8,
                  uncertainty_threshold=0.0, escalation_patience=1,
                  escalation_policy="deprioritize", deprioritize_penalty=5)
    rs = srv.submit_scan(plan, x, chunk=3)
    r1 = srv.submit(_prompts(cfg, 1)[0])
    summary = srv.run()
    st = srv.result(rs)
    assert st.preempts >= 1 and st.escalated and st.status == "done"
    assert len(st.chunk_results) == len(st.request.bounds) == 4
    _equal(st.scan_moments(), want)
    assert srv.result(r1).status == "done"
    assert summary.completed == 2 and summary.escalated >= 1


def test_voxel_terminate_policy(small, ivim):
    """terminate stops a flagged scan early with partial chunk_results, and
    scan_moments refuses to reassemble the partial scan."""
    _, model, params = small
    _, plan, width = ivim
    srv = _server(model, params, max_slots=1, uncertainty_threshold=0.0,
                  escalation_patience=2, escalation_policy="terminate")
    rs = srv.submit_scan(plan, torch.from_numpy(_voxels((9, width), 9)),
                         chunk=2)
    srv.run()
    st = srv.result(rs)
    assert st.status == "escalated" and st.escalated
    assert len(st.chunk_results) == 2 < len(st.request.bounds)
    with pytest.raises(ValueError):
        st.scan_moments()


def test_chunk_bounds():
    for n, chunk in ((10, 4), (4, 8), (12, 4)):
        assert t_scheduler.chunk_bounds(n, chunk) == \
            j_scheduler.chunk_bounds(n, chunk)
    assert t_scheduler.chunk_bounds(10, 4) == ((0, 4), (4, 8), (8, 10))
    for n, chunk in ((0, 4), (4, 0)):
        with pytest.raises(ValueError):
            t_scheduler.chunk_bounds(n, chunk)


# ---------------------------------------------------------------------------
# bucketed prefill
# ---------------------------------------------------------------------------


def _prefill_builds(max_seq):
    return {k: v for k, v in t_plan.build_counts.items()
            if k[0] == "prefill" and k[-1] == max_seq}


def test_prefill_retrace_bound(small):
    """8 distinct prompt lengths prefill through at most |buckets| builds
    (counted in core.plan.build_counts) — and none on the exact path."""
    cfg, model, params = small
    fns = step_fns(model, device=CPU)
    assert fns.prefill_spec is not None
    max_seq = 13
    before = _prefill_builds(max_seq)
    exact_before = fns.counts["prefill_exact"]
    rng = np.random.default_rng(0)
    for ln in range(1, 9):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, ln))
                                .astype(np.int32))
        fns.prefill(params, toks, max_seq=max_seq)
    new = {k: v - before.get(k, 0) for k, v in _prefill_builds(
        max_seq).items() if v > before.get(k, 0)}
    buckets = t_plan.prefill_buckets(max_seq)
    assert sum(new.values()) <= len(buckets) and len(new) <= len(buckets)
    assert all(k[3] in buckets for k in new)
    assert fns.counts["prefill_exact"] == exact_before


def test_bucketed_prefill_matches_exact(small):
    """Padded bucket prefill against the exact per-length prefill —
    posterior, uncertainty and the trimmed caches — and a bucketed pool
    against an exact one. Bit for bit on the card (tests/test_torch_cuda.py
    and chip_smoke.py, the flash kernel's masked keys add exact zeros); on
    the CPU the plain attention's softmax and ``p v`` sum a padded key row
    in another order (one fp32 ulp at some lengths), so here: tokens and
    positions equal, values within TOL."""
    cfg, model, params = small
    fb = step_fns(model, device=CPU)
    fe = step_fns(model, prefill_buckets=(), device=CPU)
    assert fb.prefill_spec is not None and fe.prefill_spec is None
    for ln in (3, 5, 8):
        toks = torch.from_numpy(np.repeat(
            _prompts(cfg, 1, length=ln, seed=ln), 4, 0))
        got = fb.prefill(params, toks, max_seq=12)
        want = fe.prefill(params, toks, max_seq=12)
        for g, w in zip(got[:2], want[:2]):
            torch.testing.assert_close(g, w, rtol=TOL, atol=TOL)
        for seg_b, seg_e in zip(got[2], want[2]):
            for b in seg_b:
                assert torch.equal(seg_b[b]["kpos"], seg_e[b]["kpos"])
                for name in ("k", "v"):
                    torch.testing.assert_close(seg_b[b][name],
                                               seg_e[b][name], rtol=TOL,
                                               atol=TOL)
    runs = []
    for buckets in (None, ()):
        srv = _server(model, params, prefill_buckets=buckets)
        rids = [srv.submit(p) for p in _prompts(cfg, 3, length=5, seed=6)]
        srv.run()
        runs.append([srv.result(r) for r in rids])
    for b, e in zip(*runs):
        assert b.generated == e.generated
        np.testing.assert_allclose(b.uncertainty, e.uncertainty, rtol=TOL,
                                   atol=TOL)


def test_prefill_bucket_selection():
    for max_seq, buckets in ((12, None), (16, (4, 8)), (160, None)):
        assert t_plan.prefill_buckets(max_seq, buckets) == \
            j_plan.prefill_buckets(max_seq, buckets)
    assert t_plan.prefill_buckets(12) == (1, 2, 4, 8, 12)
    assert t_plan.prefill_bucket(5, 12) == 8
    assert t_plan.prefill_bucket(12, 12) == 12
    assert t_plan.prefill_bucket(9, 16, (4, 8)) is None   # uncovered
    for bad in ((), (0, 4)):
        with pytest.raises(ValueError):
            t_plan.prefill_buckets(16, bad)


def test_custom_bucket_fallback_to_exact(small):
    """Lengths no custom bucket covers fall back to the exact path (and
    only those lengths take it)."""
    cfg, model, params = small
    fns = step_fns(model, prefill_buckets=(4,), device=CPU)
    before = fns.counts["prefill_exact"]
    for ln in (6, 3):           # 6 > 4: the exact path; 3 <= 4: bucketed
        toks = torch.from_numpy(np.repeat(
            _prompts(cfg, 1, length=ln, seed=2), 4, 0))
        fns.prefill(params, toks, max_seq=12)
        assert fns.counts["prefill_exact"] == before + 1


# ---------------------------------------------------------------------------
# loud config validation
# ---------------------------------------------------------------------------


def test_server_config_validation():
    for kw in (dict(max_slots=4, max_queue=3), dict(max_slots=0),
               dict(max_prompt_len=0), dict(prefill_buckets=(0, 4)),
               dict(escalation_policy="retry"), dict(kv_dtype="fp8")):
        with pytest.raises(ValueError):
            ServerConfig(**kw)
        with pytest.raises(ValueError):
            JServerConfig(**kw)
    with pytest.raises(ValueError):
        step_fns(t_registry.smoke_config("qwen2-1.5b", n_layers=2),
                 prefill_buckets=(-1,), device=CPU)
    assert ServerConfig(prefill_buckets=()).prefill_buckets == ()
    assert ServerConfig(prefill_buckets=[4, 8]).prefill_buckets == (4, 8)
    assert ServerConfig().max_seq == JServerConfig().max_seq == 48
    assert [f.name for f in dataclasses.fields(ServerConfig)] == \
        [f.name for f in dataclasses.fields(JServerConfig)]
