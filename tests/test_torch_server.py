"""The port's continuous-batching server (``repro_torch.serving.server``)
against the JAX package's, on the CPU: slots, queue, validation, the slot
layout and the pool's cache-row helpers, no step built twice, the server
against the one-shot engine, the escalation policies, and the port's server
against the reference's server on the same weights, prompts and
``ServerConfig`` — a dense pool, an int8 KV pool and a hybrid
(recurrentgemma) pool, under the flag, terminate and deprioritize
policies, the two servers stepped in lockstep with their pools compared
after every step.

Models: ``smoke_config("qwen2-1.5b", n_layers=2)`` (``kv_dtype="int8"`` for
the int8 pool) and ``smoke_config("recurrentgemma-2b")``, fp32, the
reference's weights from ``PRNGKey(0)`` carried over by
``transformer.params_from_jax``; prompts and cache contents from numpy
seeds. Tolerances: TOL = 1e-5 on uncertainties and cached values (the
port's LM tests' bar); generated tokens, positions, statuses and the order
of admissions equal. An int8 cached vector may sit one int8 step from the
reference's where fp32 k/v computed in another order round to the
neighbouring step at a tie (tests/test_torch_quantized.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as j_registry
from repro.core import scheduler as j_scheduler
from repro.models import build_model as j_build_model
from repro.models import transformer as j_transformer
from repro.obs import trace as j_trace
from repro.serving import BayesianLMServer as JServer
from repro.serving import ServerConfig as JServerConfig
from repro_torch.configs import registry as t_registry
from repro_torch.core.scheduler import SlotSchedule
from repro_torch.models import model as t_model
from repro_torch.models import transformer as t_transformer
from repro_torch.obs import registry as t_reg
from repro_torch.obs import trace as t_trace
from repro_torch.serving import (BayesianLMServer, QueueFullError,
                                 ServeConfig, ServerConfig, serve_uncertain)

TOL = 1e-5
CPU = "cpu"

#: pool name -> (arch, smoke overrides, ServerConfig overrides, prompt
#: lengths): the hybrid pool's 16-slot local-attention ring is shorter
#: than its 24-position pool, so decode wraps the ring and a preempted
#: request re-prefills past the window
POOLS = {
    "dense": ("qwen2-1.5b", dict(n_layers=2), {}, (6, 4, 7, 5)),
    "int8": ("qwen2-1.5b", dict(n_layers=2), dict(kv_dtype="int8"),
             (6, 4, 7, 5)),
    "hybrid": ("recurrentgemma-2b", {},
               dict(max_prompt_len=16, max_new_tokens=8), (14, 9, 15, 12)),
}
#: policy -> ServerConfig overrides; threshold 0 flags every token, so the
#: policies act deterministically
POLICIES = {
    "flag": {},
    "terminate": dict(uncertainty_threshold=0.0, escalation_patience=2,
                      escalation_policy="terminate"),
    "deprioritize": dict(uncertainty_threshold=0.0, escalation_patience=1,
                         escalation_policy="deprioritize",
                         deprioritize_penalty=5),
}


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.numpy()
    return np.asarray(t)


def _leaves(caches):
    """Cache leaves by path, the port's and the reference's alike."""
    return {(si, b, name): _np(leaf) for si, seg in enumerate(caches)
            for b, leaves in seg.items() for name, leaf in leaves.items()}


def _caches_close(got, want):
    """Every leaf equal in shape and dtype; kpos equal; floats within TOL;
    int8 k/v dequantized within one int8 step plus TOL."""
    g, w = _leaves(got), _leaves(want)
    assert g.keys() == w.keys()
    for key in g:
        assert g[key].shape == w[key].shape and g[key].dtype == w[key].dtype
        name = key[2]
        if name == "kpos":
            np.testing.assert_array_equal(g[key], w[key])
        elif g[key].dtype == np.int8:
            sc = w[key[:2] + (name[0] + "scale",)][..., None]
            diff = np.abs(g[key].astype(np.float32) - w[key]) * sc
            assert np.all(diff <= sc + TOL), key
        else:
            np.testing.assert_allclose(g[key], w[key], rtol=TOL, atol=TOL,
                                       err_msg=str(key))


@pytest.fixture(scope="module")
def pair():
    """(jcfg, tcfg, jax params, port params) per pool kind."""
    out = {}

    def get(kind):
        if kind not in out:
            arch, kw, srv_kw, _ = POOLS[kind]
            jcfg = j_registry.smoke_config(arch, **kw)
            tcfg = t_registry.smoke_config(arch, **kw)
            jp = j_build_model(jcfg).init(jax.random.PRNGKey(0))
            tp = t_transformer.params_from_jax(
                tcfg, jax.tree.map(np.asarray, jp), device=CPU)
            out[kind] = (jcfg, tcfg, jp, tp)
        return out[kind]
    return get


@pytest.fixture(scope="module")
def small(pair):
    _, tcfg, _, tp = pair("dense")
    return tcfg, t_model.build_model(tcfg), tp


def _prompts(cfg, n, length=6, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (n, length))


def _server(model, params, **kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("max_prompt_len", 8)
    kw.setdefault("max_new_tokens", 4)
    return BayesianLMServer(model, params, ServerConfig(**kw), device=CPU)


# ---------------------------------------------------------------------------
# slots
# ---------------------------------------------------------------------------


def test_slot_reuse_after_completion(small):
    """4 requests through 2 slots: all complete, and the pool never holds
    more than max_slots concurrently (freed slots are re-admitted into)."""
    cfg, model, params = small
    srv = _server(model, params)
    rids = [srv.submit(p) for p in _prompts(cfg, 4)]
    summary = srv.run()
    assert summary.completed == 4
    for r in rids:
        st = srv.result(r)
        assert st.status == "done"
        assert len(st.generated) == 4 and len(st.uncertainty) == 4
    assert max(srv.metrics.occupancy_samples) <= 2
    assert summary.peak_queue_depth >= 1
    assert srv.occupied_slots == 0 and srv.queue_depth == 0
    # every slot was released: the whole pool is observably empty again
    assert bool((srv._caches[0]["b0"]["kpos"] == -1).all())
    st0 = srv.pop_result(rids[0])
    assert st0.status == "done" and rids[0] not in srv.states


def test_queue_backpressure(small):
    cfg, model, params = small
    srv = _server(model, params, max_queue=3)
    prompts = _prompts(cfg, 4)
    for p in prompts[:3]:
        srv.submit(p)
    with pytest.raises(QueueFullError):
        srv.submit(prompts[3])
    srv.run()
    rid = srv.submit(prompts[3])
    assert srv.queue_depth == 1
    with pytest.raises(ValueError):
        srv.pop_result(rid)                 # still queued, not evictable
    srv.cancel(rid)                         # a queued item withdraws
    assert srv.queue_depth == 0 and rid not in srv.states
    assert srv.step() is False              # the tombstone is skipped
    with pytest.raises(ValueError):
        srv.cancel(rid)


def test_prompt_length_validation(small):
    cfg, model, params = small
    srv = _server(model, params, max_prompt_len=4)
    for bad, kw in ((np.zeros(5, np.int32), {}), (np.zeros(0, np.int32), {}),
                    (np.zeros(3, np.int32), dict(max_new_tokens=0)),
                    (np.zeros(3, np.int32), dict(max_new_tokens=99)),
                    (np.zeros((2, 2), np.int32), {})):
        with pytest.raises(ValueError):
            srv.submit(bad, **kw)
    with pytest.raises(ValueError, match="mask_samples"):
        BayesianLMServer(t_model.build_model(dataclasses.replace(
            cfg, mask_samples=0)), params, device=CPU)


# ---------------------------------------------------------------------------
# mask-group / slot invariants
# ---------------------------------------------------------------------------


def test_slot_schedule_layout():
    sch = SlotSchedule(n_masks=4, max_slots=3)
    ref = j_scheduler.SlotSchedule(n_masks=4, max_slots=3)
    assert sch.rows == ref.rows == 12
    np.testing.assert_array_equal(sch.mask_ids(), np.repeat(np.arange(4), 3))
    np.testing.assert_array_equal(sch.mask_ids(), ref.mask_ids())
    for slot in range(3):
        np.testing.assert_array_equal(sch.rows_for_slot(slot),
                                      ref.rows_for_slot(slot))
    np.testing.assert_array_equal(sch.rows_for_slot(1), [1, 4, 7, 10])
    np.testing.assert_array_equal(sch.row_values(np.array([5, 6, 7])),
                                  [5, 6, 7] * 4)
    sch.admits(SlotSchedule(4, 3))
    with pytest.raises(ValueError):
        sch.admits(SlotSchedule(8, 3))
    with pytest.raises(ValueError):
        SlotSchedule(0, 3)


def test_mask_group_cache_invariants(small):
    """After admission, a request's slot group holds its prompt positions in
    every mask row; untouched slots stay empty (kpos == -1)."""
    cfg, model, params = small
    srv = _server(model, params, max_slots=3)
    srv.submit(_prompts(cfg, 1, length=5)[0])
    srv.step()                                   # admit + first decode
    sch = srv.schedule
    rows = sch.rows_for_slot(0).numpy()
    kpos = srv._caches[0]["b0"]["kpos"][0].numpy()   # [rows, max_seq]
    for r in rows[1:]:
        np.testing.assert_array_equal(kpos[rows[0]], kpos[r])
    assert set(kpos[rows[0]][kpos[rows[0]] >= 0].tolist()) == set(range(6))
    for s in (1, 2):
        for r in sch.rows_for_slot(s).numpy():
            assert (kpos[r] == -1).all()


def test_cache_row_helpers(small):
    cfg, _, _ = small
    pool = t_transformer.init_cache(cfg, 4, 8, device=CPU)
    fresh = [{b: {n: torch.full(shape, 7, dtype=dt) for n, (shape, dt)
                  in leaves.items()} for b, leaves in seg.items()}
             for seg in t_transformer.cache_specs(cfg, 2, 8)]
    rows = torch.tensor([1, 3])
    merged = t_transformer.cache_scatter_rows(pool, fresh, rows)
    got = t_transformer.cache_gather_rows(merged, rows)
    for key, leaf in _leaves(got).items():
        np.testing.assert_array_equal(leaf, _leaves(fresh)[key])
    assert bool((merged[0]["b0"]["kpos"][0, 0] == -1).all())
    assert bool((pool[0]["b0"]["kpos"] == -1).all())   # pool left as it was
    reset = t_transformer.cache_reset_rows(
        merged, torch.tensor([False, True, False, False]))
    assert bool((reset[0]["b0"]["kpos"][0, 1] == -1).all())
    assert bool((reset[0]["b0"]["k"][0, 1] == 0).all())
    assert torch.equal(reset[0]["b0"]["kpos"][0, 3],
                       merged[0]["b0"]["kpos"][0, 3])


@pytest.mark.parametrize("kind", list(POOLS))
def test_cache_row_helpers_match_reference(pair, kind):
    """scatter, gather and reset on every leaf kind (k, v, kpos; the int8
    kscale/vscale; the recurrent h and conv) equal the reference's, on the
    same numpy contents."""
    jcfg, tcfg, _, _ = pair(kind)
    kv = POOLS[kind][2].get("kv_dtype", "")
    jcfg = dataclasses.replace(jcfg, kv_dtype=kv or jcfg.kv_dtype)
    tcfg = dataclasses.replace(tcfg, kv_dtype=kv or tcfg.kv_dtype)
    rng = np.random.default_rng(3)
    specs = j_transformer.cache_specs(jcfg, 2, 8)

    def draw(s):
        if np.issubdtype(s.dtype, np.integer):
            return rng.integers(-1, 8, s.shape).astype(s.dtype)
        return rng.normal(size=s.shape).astype(s.dtype)

    fresh_np = jax.tree.map(draw, specs)
    pool_np = jax.tree.map(lambda a: np.asarray(a),
                           j_transformer.init_cache(jcfg, 5, 8))
    names = {k[2] for k in _leaves(pool_np)}
    want_names = {"int8": {"k", "v", "kpos", "kscale", "vscale"},
                  "hybrid": {"k", "v", "kpos", "h", "conv"}}
    assert want_names.get(kind, {"k", "v", "kpos"}) == names

    def to_port(tree):
        return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)

    rows = np.array([4, 1], np.int32)
    mask = np.array([False, True, False, False, True])
    t_pool = t_transformer.init_cache(tcfg, 5, 8, device=CPU)
    _caches_close(t_pool, pool_np)
    t_merged = t_transformer.cache_scatter_rows(t_pool, to_port(fresh_np),
                                                torch.from_numpy(rows))
    j_merged = j_transformer.cache_scatter_rows(
        jax.tree.map(jnp.asarray, pool_np), jax.tree.map(jnp.asarray,
                                                         fresh_np),
        jnp.asarray(rows))
    for got, want in (
            (t_merged, j_merged),
            (t_transformer.cache_gather_rows(t_merged, torch.tensor([1, 4])),
             j_transformer.cache_gather_rows(j_merged, jnp.asarray([1, 4]))),
            (t_transformer.cache_reset_rows(t_merged, torch.from_numpy(mask)),
             j_transformer.cache_reset_rows(j_merged, jnp.asarray(mask)))):
        g, w = _leaves(got), _leaves(want)
        assert g.keys() == w.keys()
        for key in g:
            assert g[key].dtype == w[key].dtype
            np.testing.assert_array_equal(g[key], w[key], err_msg=str(key))


# ---------------------------------------------------------------------------
# builds (the port's twin of the reference's retraces)
# ---------------------------------------------------------------------------


def test_jitted_steps_do_not_retrace(small):
    """The decode step is built at most once for the config, a bucketed
    prefill at most once per bucket — and never again for repeat traffic
    or a second server with the same shapes (the steps are shared through
    one cached StepFns per config)."""
    cfg, model, params = small
    srv = _server(model, params)
    b0 = t_reg.REGISTRY.value("step_builds_total")
    srv.submit(_prompts(cfg, 1)[0])
    srv.run()                                 # the first request may build
    assert t_reg.REGISTRY.value("step_builds_total") - b0 <= 2
    b1 = t_reg.REGISTRY.value("step_builds_total")
    fns = srv.steps
    calls = dict(fns.counts)
    for p in _prompts(cfg, 5):                # same shapes: zero builds
        srv.submit(p)
    srv.run()
    srv2 = _server(model, params)
    assert srv2.steps is fns
    srv2.submit(_prompts(cfg, 1)[0])
    srv2.run()
    assert t_reg.REGISTRY.value("step_builds_total") == b1
    assert fns.counts["decode_fused"] > calls.get("decode_fused", 0)
    assert fns.counts["prefill_bucketed"] == \
        calls.get("prefill_bucketed", 0) + 6


# ---------------------------------------------------------------------------
# equivalence with the one-shot engine
# ---------------------------------------------------------------------------


def test_server_matches_one_shot(small):
    """Same request batch through the server and serve_uncertain: identical
    tokens, per-token uncertainties within TOL."""
    cfg, model, params = small
    prompts = _prompts(cfg, 3, length=7, seed=3)
    gen, unc, _ = serve_uncertain(model, params, torch.from_numpy(prompts),
                                  ServeConfig(max_new_tokens=5), device=CPU)
    srv = _server(model, params, max_slots=3, max_new_tokens=5)
    rids = [srv.submit(p) for p in prompts]
    srv.run()
    for i, r in enumerate(rids):
        st = srv.result(r)
        assert gen[i, 7:].tolist() == st.generated
        np.testing.assert_allclose(unc[i].numpy(), st.uncertainty,
                                   rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# uncertainty-aware policies
# ---------------------------------------------------------------------------


def test_escalation_terminate_policy(small):
    cfg, model, params = small
    srv = _server(model, params, max_new_tokens=6,
                  **POLICIES["terminate"])
    rid = srv.submit(_prompts(cfg, 1)[0])
    summary = srv.run()
    st = srv.result(rid)
    assert st.status == "escalated" and st.escalated
    assert len(st.generated) == 2          # stopped at patience, not at 6
    assert summary.escalated == 1


def test_escalation_deprioritize_policy(small):
    """An escalating request yields its slot to queued traffic and still
    finishes later at a worse priority, on the tokens it would have
    generated uninterrupted."""
    cfg, model, params = small
    before = t_reg.REGISTRY.value("serving_preemptions_total")
    srv = _server(model, params, max_slots=1, max_queue=8,
                  **POLICIES["deprioritize"])
    prompts = _prompts(cfg, 2)
    r0 = srv.submit(prompts[0])
    r1 = srv.submit(prompts[1])
    summary = srv.run()
    s0, s1 = srv.result(r0), srv.result(r1)
    assert summary.completed == 2
    assert s0.preempts >= 1 and s0.effective_priority >= 5
    assert t_reg.REGISTRY.value("serving_preemptions_total") > before
    assert len(s0.generated) == 4 and len(s1.generated) == 4
    gen, _, _ = serve_uncertain(model, params,
                                torch.from_numpy(prompts[:1]),
                                ServeConfig(max_new_tokens=4), device=CPU)
    assert gen[0, 6:].tolist() == s0.generated


def test_priority_admission_order(small):
    """With one slot busy, the lower priority value is admitted first."""
    cfg, model, params = small
    srv = _server(model, params, max_slots=1)
    prompts = _prompts(cfg, 3)
    r0 = srv.submit(prompts[0])
    srv.step()
    r_lo = srv.submit(prompts[1], priority=5)
    r_hi = srv.submit(prompts[2], priority=-5)
    srv.run()
    tl = srv.metrics.timelines
    assert tl[r_hi].admit_t < tl[r_lo].admit_t
    assert all(srv.result(r).status == "done" for r in (r0, r_lo, r_hi))


# ---------------------------------------------------------------------------
# the port's server against the reference's server
# ---------------------------------------------------------------------------


def _lifecycle(events):
    """(name, kind, req_id) of every record that names a request."""
    return [(e["name"], e["kind"], e["attrs"].get("req_id"))
            for e in events if e["name"] not in ("step", "decode")]


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("kind", list(POOLS))
def test_server_matches_reference_server(pair, kind, policy):
    """Same weights, prompts and ServerConfig through both servers, stepped
    in lockstep: equal tokens, statuses, escalations, preemptions and
    lifecycle records (the admission order among them), rel-unc within
    TOL, and the pooled caches — every leaf, occupied and empty rows —
    compared after every step."""
    jcfg, tcfg, jp, tp = pair(kind)
    _, _, srv_kw, lengths = POOLS[kind]
    kw = dict(max_slots=2, max_queue=8, max_prompt_len=8, max_new_tokens=4)
    kw.update(srv_kw)
    kw.update(POLICIES[policy])
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, tcfg.vocab_size, n) for n in lengths]
    new = [kw["max_new_tokens"], 2, kw["max_new_tokens"], 3]
    j_tr = j_trace.Tracer(enabled=True, clock=t_trace.ManualClock())
    t_tr = t_trace.Tracer(enabled=True, clock=t_trace.ManualClock())
    jsrv = JServer(j_build_model(jcfg), jp, JServerConfig(**kw), tracer=j_tr)
    tsrv = BayesianLMServer(t_model.build_model(tcfg), tp, ServerConfig(**kw),
                            device=CPU, tracer=t_tr)
    rids = []
    for p, m, prio in zip(prompts, new, (0, 1, 0, 2)):
        rids.append(tsrv.submit(p, max_new_tokens=m, priority=prio))
        assert jsrv.submit(p, max_new_tokens=m, priority=prio) == rids[-1]
    steps = 0
    while True:
        busy = jsrv.step()
        assert tsrv.step() == busy
        if not busy:
            break
        steps += 1
        _caches_close(tsrv._caches, jsrv._caches)
        assert tsrv._slots == jsrv._slots
    assert steps > 0
    for r in rids:
        t_st, j_st = tsrv.result(r), jsrv.result(r)
        assert (t_st.status, t_st.escalated, t_st.preempts,
                t_st.effective_priority, t_st.flags) == \
            (j_st.status, j_st.escalated, j_st.preempts,
             j_st.effective_priority, j_st.flags)
        assert t_st.generated == j_st.generated
        np.testing.assert_allclose(t_st.uncertainty, j_st.uncertainty,
                                   rtol=TOL, atol=TOL)
    assert _lifecycle(t_tr.events()) == _lifecycle(j_tr.events())
    if policy == "deprioritize":
        assert any(tsrv.result(r).preempts for r in rids)
    if policy == "terminate":
        assert all(tsrv.result(r).status == "escalated" for r in rids)
    t_sum, j_sum = tsrv.metrics.summary(), jsrv.metrics.summary()
    assert (t_sum.completed, t_sum.escalated, t_sum.total_tokens,
            t_sum.decode_steps, t_sum.peak_queue_depth) == \
        (j_sum.completed, j_sum.escalated, j_sum.total_tokens,
         j_sum.decode_steps, j_sum.peak_queue_depth)
    # the same executors on both sides: the dense pool's fused decode and
    # bucketed prefill; per-op decode and exact prefill for the int8 KV and
    # the hybrid pools, which have no fused lowering
    assert (tsrv.steps.fused_spec is None) == (kind != "dense") \
        == (jsrv.steps.fused_spec is None)
    assert (tsrv.steps.prefill_spec is None) == (kind != "dense") \
        == (jsrv.steps.prefill_spec is None)
    # drained: every row released, no cached position left (rows decoding
    # at pos -1 leave their k/v only on kpos -1 slots, as in the reference)
    for key, leaf in _leaves(tsrv._caches).items():
        assert key[2] != "kpos" or (leaf == -1).all(), key
