"""The paper's schedule and pricing surface of the port against the JAX
package's, on the CPU: the Masksembles layers (mask-as-multiply, the
unpacked baseline), ``pack_masked_ffn``/``packed_ffn_apply``, the batch- and
sampling-level loops of ``core.scheduler`` (paper §V-D, Fig. 5, Table II),
``SlotSchedule.decode_traffic``, ``grid_sweep`` (Fig. 8),
``PackedPlan.fused_spec``, ``decode_modeled_latency``, ``obs.crosscheck``
and ``obs.trace.get_tracer``; then the elastic remesh planner and the
straggler monitor the router builds on.

Inputs are numpy draws from fixed seeds, or the reference's own
initialisers carried across by ``masksembles.params_from_jax``.
Tolerances: TOL = 1e-5 on products (fp32 sums in another order across
the two frameworks); TOL_SCHED = (rtol 1e-5, atol 1e-6) between the two
loop orders inside one package, the reference's own bar
(tests/test_core_packing.py); TOL_PACKED = 2e-5 for packed against
mask-as-multiply (the same test file's bar). Pricing is compared within
TOL_MODEL = 1e-9 under the reference's TPU spec mapped onto the port's
field names (never written into the port). Gathers, masks, plans and
integer traffic are compared exactly.
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as j_registry
from repro.core import latency_model as j_lat
from repro.core import masks as j_masks
from repro.core import masksembles as j_ms
from repro.core import packing as j_pack
from repro.core import plan as j_plan
from repro.core import scheduler as j_sched
from repro.distributed import elastic as j_elastic
from repro.distributed import straggler as j_straggler
from repro.ivim import model as j_ivim
from repro.kernels.fused_plan import ref as j_fref
from repro.obs import crosscheck as j_cc
from repro_torch import obs as t_obs
from repro_torch.configs import registry as t_registry
from repro_torch.core import latency_model as t_lat
from repro_torch.core import masks as t_masks
from repro_torch.core import masksembles as t_ms
from repro_torch.core import packing as t_pack
from repro_torch.core import plan as t_plan
from repro_torch.core import scheduler as t_sched
from repro_torch.distributed import elastic, straggler
from repro_torch.ivim import model as t_ivim
from repro_torch.kernels.fused_plan import ref as t_fref
from repro_torch.obs import trace as t_trace

TOL = 1e-5
TOL_SCHED = dict(rtol=1e-5, atol=1e-6)
TOL_PACKED = 2e-5
TOL_MODEL = 1e-9
CPU = "cpu"


def _v5e_as_port_spec():
    """The reference's own TPU spec, read here and mapped onto the port's
    field names — it is never written into the port."""
    v = dataclasses.asdict(j_lat.V5E)
    return t_lat.DeviceSpec(
        name=v["name"], peak_flops=v["peak_flops_bf16"], hbm_bw=v["hbm_bw"],
        link_bw=v["ici_bw_per_link"], hbm_bytes=v["hbm_bytes"],
        onchip_bytes=v["vmem_bytes"], tile=v["mxu"],
        kernel_fill_us=v["kernel_fill_us"])


def _ffn(width, n, d_in, d_out, seed=0):
    """One masked FFN's weights and masks, as numpy."""
    rng = np.random.default_rng(seed)
    w1 = (0.3 * rng.normal(size=(d_in, width))).astype(np.float32)
    b1 = (0.1 * rng.normal(size=(width,))).astype(np.float32)
    w2 = (0.3 * rng.normal(size=(width, d_out))).astype(np.float32)
    b2 = (0.1 * rng.normal(size=(d_out,))).astype(np.float32)
    masks = j_masks.generate_masks(j_masks.MaskSpec(
        width=width, n_masks=n, scale=2.0, seed=seed))
    return w1, b1, w2, b2, masks


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# A.1 the Masksembles layers
# ---------------------------------------------------------------------------


def test_masked_ffn_init_shapes_masks_and_scale():
    """The port's initialisers: shapes, dtypes, the reference's masks bit
    for bit (both build them with numpy from the spec's seed), He scale,
    zero biases, and a mask width that does not match d_out refused."""
    spec = t_masks.MaskSpec(width=64, n_masks=4, scale=2.0, seed=3)
    p = t_ms.masked_ffn_init(torch.Generator().manual_seed(0), 40, 64, 7,
                             spec)
    assert p["fc1"]["w"].shape == (40, 64) and p["fc2"]["w"].shape == (64, 7)
    assert p["fc1"]["masks"].shape == (4, 64)
    assert all(t.dtype == torch.float32 for layer in p.values()
               for t in layer.values())
    want = j_masks.generate_masks(j_masks.MaskSpec(width=64, n_masks=4,
                                                   scale=2.0, seed=3))
    np.testing.assert_array_equal(p["fc1"]["masks"].numpy(),
                                  want.astype(np.float32))
    assert float(p["fc1"]["b"].abs().max()) == 0.0
    assert abs(float(p["fc1"]["w"].std()) - np.sqrt(2.0 / 40)) < 0.02
    half = t_ms.masked_dense_init(torch.Generator().manual_seed(0), 5, 64,
                                  spec, dtype=torch.bfloat16)
    assert half["w"].dtype == half["masks"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="mask width"):
        t_ms.masked_dense_init(torch.Generator().manual_seed(0), 5, 63, spec)


def test_masked_ffn_apply_matches_reference():
    """The reference's initialiser, carried across: dense_apply,
    masked_dense_apply (with and without the activation) and
    masked_ffn_apply within TOL, under the training form's contiguous mask
    groups and the inference expansion's every-mask rows."""
    spec = j_masks.MaskSpec(width=48, n_masks=4, scale=2.0, seed=1)
    jp = j_ms.masked_ffn_init(jax.random.PRNGKey(0), 13, 48, 6, spec)
    tp = t_ms.params_from_jax(jax.tree.map(np.asarray, jp), device=CPU)
    np.testing.assert_array_equal(tp["fc1"]["masks"].numpy(),
                                  np.asarray(jp["fc1"]["masks"]))
    x = np.random.default_rng(2).normal(size=(12, 13)).astype(np.float32)
    ids = t_ms.mask_ids_for_batch(12, 4)
    np.testing.assert_array_equal(ids.numpy(),
                                  np.asarray(j_ms.mask_ids_for_batch(12, 4)))
    h = np.random.default_rng(3).normal(size=(12, 48)).astype(np.float32)
    pairs = (
        (t_ms.dense_apply(tp["fc2"], _t(h)),
         j_ms.dense_apply(jp["fc2"], jnp.asarray(h))),
        (t_ms.masked_dense_apply(tp["fc1"], _t(x), ids),
         j_ms.masked_dense_apply(jp["fc1"], jnp.asarray(x),
                                 jnp.asarray(ids.numpy()))),
        (t_ms.masked_dense_apply(tp["fc1"], _t(x), ids, activation=None),
         j_ms.masked_dense_apply(jp["fc1"], jnp.asarray(x),
                                 jnp.asarray(ids.numpy()), activation=None)),
        (t_ms.masked_ffn_apply(tp, _t(x), ids),
         j_ms.masked_ffn_apply(jp, jnp.asarray(x), jnp.asarray(ids.numpy()))))
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)
    x_rep, rep_ids = t_ms.repeat_for_samples(_t(x), 4)
    jx_rep, jrep_ids = j_ms.repeat_for_samples(jnp.asarray(x), 4)
    np.testing.assert_array_equal(x_rep.numpy(), np.asarray(jx_rep))
    np.testing.assert_array_equal(rep_ids.numpy(), np.asarray(jrep_ids))
    np.testing.assert_allclose(
        t_ms.masked_ffn_apply(tp, x_rep, rep_ids).numpy(),
        np.asarray(j_ms.masked_ffn_apply(jp, jx_rep, jrep_ids)),
        rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# A.2 packing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width,n,d_in,batch",
                         [(64, 4, 11, 9), (32, 8, 3, 1), (50, 2, 17, 5)])
def test_packed_ffn_matches_reference(width, n, d_in, batch):
    """pack_masked_ffn gathers the reference's units bit for bit;
    packed_ffn_apply (all samples, sample-major, and each sample alone)
    matches the reference within TOL and the mask-as-multiply form within
    TOL_PACKED — mask-zero skipping changes no number beyond rounding."""
    w1, b1, w2, b2, masks = _ffn(width, n, d_in, 5)
    jpk = j_pack.pack_masked_ffn(*map(jnp.asarray, (w1, b1, w2, b2)), masks)
    tpk = t_pack.pack_masked_ffn(*map(_t, (w1, b1, w2, b2)), masks)
    for k in ("w1p", "b1p", "w2p", "b2", "kept_idx"):
        np.testing.assert_array_equal(tpk[k].numpy(), np.asarray(jpk[k]),
                                      err_msg=k)
    keep = int(masks[0].sum())
    assert tpk["w1p"].shape == (n, d_in, keep) and keep < width
    x = np.random.default_rng(42).normal(size=(batch, d_in)) \
        .astype(np.float32)
    got = t_pack.packed_ffn_apply(tpk, _t(x))
    assert got.shape == (n, batch, 5)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(j_pack.packed_ffn_apply(jpk, jnp.asarray(x))),
        rtol=TOL, atol=TOL)
    mask_f = torch.from_numpy(masks.astype(np.float32))
    tp = {"fc1": {"w": _t(w1), "b": _t(b1), "masks": mask_f},
          "fc2": {"w": _t(w2), "b": _t(b2)}}
    x_rep, ids = t_ms.repeat_for_samples(_t(x), n)
    masked = t_ms.masked_ffn_apply(tp, x_rep, ids).reshape(n, batch, 5)
    torch.testing.assert_close(got, masked, rtol=TOL_PACKED, atol=TOL_PACKED)
    for i in range(n):
        one = t_pack.packed_ffn_apply(tpk, _t(x), sample=i)
        np.testing.assert_allclose(
            one.numpy(),
            np.asarray(j_pack.packed_ffn_apply(jpk, jnp.asarray(x),
                                               sample=i)),
            rtol=TOL, atol=TOL)
        torch.testing.assert_close(one, got[i], rtol=TOL_PACKED,
                                   atol=TOL_PACKED)


# ---------------------------------------------------------------------------
# A.3 the scheduler
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,chunk,batch",
                         [("batch", 64, 50), ("sampling", 16, 50),
                          ("sampling", 16, 64), ("sampling", 64, 7)])
def test_schedule_run_matches_reference(kind, chunk, batch):
    """scheduler.run in either order: the reference's [N, B, ...] layout and
    padding (a batch off the chunk is zero-padded and trimmed), values
    within TOL of the reference, and within TOL_SCHED of the port's other
    order."""
    w1, b1, w2, b2, masks = _ffn(32, 4, 9, 6)
    jpk = j_pack.pack_masked_ffn(*map(jnp.asarray, (w1, b1, w2, b2)), masks)
    tpk = t_pack.pack_masked_ffn(*map(_t, (w1, b1, w2, b2)), masks)
    x = np.random.default_rng(7).normal(size=(batch, 9)).astype(np.float32)

    def t_apply(p, xb, i):
        return t_pack.packed_ffn_apply(p, xb, sample=i)

    def j_apply(p, xb, i):
        return j_pack.packed_ffn_apply(p, xb, sample=i)

    sched = t_sched.Schedule(kind, chunk=chunk)
    got = t_sched.run(sched, t_apply, tpk, _t(x), 4)
    want = j_sched.run(j_sched.Schedule(kind, chunk=chunk), j_apply, jpk,
                       jnp.asarray(x), 4)
    assert got.shape == tuple(want.shape) == (4, batch, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    other = t_sched.Schedule("batch" if kind == "sampling" else "sampling",
                             chunk=16)
    torch.testing.assert_close(got, t_sched.run(other, t_apply, tpk, _t(x),
                                                4), **TOL_SCHED)
    torch.testing.assert_close(got, t_pack.packed_ffn_apply(tpk, _t(x)),
                               **TOL_SCHED)
    assert t_sched.weight_load_counts(sched, batch, 4) == \
        j_sched.weight_load_counts(j_sched.Schedule(kind, chunk=chunk),
                                   batch, 4)


def test_weight_load_counts_match_paper():
    # paper §V-D: sampling-level N x ceil(B/chunk) loads vs batch-level N
    assert t_sched.weight_load_counts(t_sched.Schedule("batch"), batch=64,
                                      n_samples=4) == 4
    assert t_sched.weight_load_counts(
        t_sched.Schedule("sampling", chunk=16), batch=64, n_samples=4) == 16


def test_traffic_and_decode_traffic_match_reference():
    """TrafficModel.arithmetic_intensity, traffic_model under both orders
    (batch-level moves fewer weight bytes for the same FLOPs) and
    SlotSchedule.decode_traffic (the reference's bf16 default and an int8
    weight width) equal the reference's numbers."""
    for kind in ("batch", "sampling"):
        t = t_sched.traffic_model(t_sched.Schedule(kind), 256, 8, 104, 52,
                                  104, 2)
        j = j_sched.traffic_model(j_sched.Schedule(kind), 256, 8, 104, 52,
                                  104)
        assert (t.weight_bytes, t.act_bytes, t.flops, t.weight_loads) == \
            (j.weight_bytes, j.act_bytes, j.flops, j.weight_loads)
        np.testing.assert_allclose(t.arithmetic_intensity,
                                   j.arithmetic_intensity, rtol=TOL_MODEL)
    tb = t_sched.traffic_model(t_sched.Schedule("batch"), 256, 8, 104, 52,
                               104)
    ts = t_sched.traffic_model(t_sched.Schedule("sampling"), 256, 8, 104, 52,
                               104)
    assert tb.weight_bytes < ts.weight_bytes and tb.flops == ts.flops
    assert tb.arithmetic_intensity > ts.arithmetic_intensity
    tsch, jsch = t_sched.SlotSchedule(4, 8), j_sched.SlotSchedule(4, 8)
    for kw in ({}, dict(bytes_per_el=4), dict(weight_bytes_per_el=1)):
        t = tsch.decode_traffic(1536, 4480, 1536, **kw)
        j = jsch.decode_traffic(1536, 4480, 1536, **kw)
        assert dataclasses.astuple(t) == dataclasses.astuple(j), kw
        assert t.weight_loads == 4


# ---------------------------------------------------------------------------
# A.4-A.5 pricing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch,d_in,keep,d_out,n",
                         [(4096, 104, 52, 104, 8), (100, 11, 17, 1, 4),
                          (5, 300, 129, 7, 2)])
def test_grid_sweep_matches_reference(batch, d_in, keep, d_out, n):
    """grid_sweep under the reference's spec: the same blocks, latencies
    within TOL_MODEL and on-chip bytes equal to the reference's VMEM bytes
    (the same formula, ``tile`` for ``mxu``); under the H100 the bytes pad
    to its 16-wide tile and are held to its 228 KB."""
    got = t_lat.grid_sweep(batch, d_in, keep, d_out, n, _v5e_as_port_spec())
    want = j_lat.grid_sweep(batch, d_in, keep, d_out, n, j_lat.V5E)
    assert [r["block_batch"] for r in got] == \
        [r["block_batch"] for r in want]
    for g, w in zip(got, want):
        assert set(g) == {"block_batch", "latency_s", "onchip_bytes",
                          "fits_onchip"}
        np.testing.assert_allclose(g["latency_s"], w["latency_s"],
                                   rtol=TOL_MODEL)
        assert (g["onchip_bytes"], g["fits_onchip"]) == \
            (w["vmem_bytes"], w["fits_vmem"])
    h100 = t_lat.grid_sweep(batch, d_in, keep, d_out, n)
    for r in h100:
        pad = [-(-v // 16) * 16 for v in (d_in, keep, d_out)]
        bm = r["block_batch"]
        assert r["onchip_bytes"] == 2 * (bm * pad[0] + pad[0] * pad[1]
                                         + pad[1] * pad[2] + bm * pad[1])
        assert r["fits_onchip"] == (r["onchip_bytes"] <= 228 * 1024)


@pytest.fixture(scope="module")
def ivim_plans():
    jcfg = j_ivim.IvimConfig(n_masks=4, scale=2.0)
    params, state = j_ivim.init(jcfg, jax.random.PRNGKey(0))
    tcfg = t_ivim.IvimConfig(n_masks=4, scale=2.0)
    model = t_ivim.params_from_jax(tcfg, jax.tree.map(np.asarray, params),
                                   jax.tree.map(np.asarray, state),
                                   device=CPU)
    return j_ivim.pack_for_serving(jcfg, params, state), \
        t_ivim.pack_for_serving(model)


def test_fused_spec_matches_reference(ivim_plans):
    """PackedPlan.fused_spec is the fused lowering's spec: the reference's
    steps and widths, at fp32 and int8; an op with no fused form raises
    FusedPlanUnsupported in both packages."""
    jplan, tplan = ivim_plans
    for prec in ("fp32", "int8"):
        j = jplan.with_precision(j_plan.Precision(prec)).fused_spec()
        t = tplan.with_precision(t_plan.Precision(prec)).fused_spec()
        assert (t.n_rows, t.n_masks, t.groups, t.d_in, t.d_out) == \
            (j.n_rows, j.n_masks, j.groups, j.d_in, j.d_out)
        assert [dataclasses.astuple(s) for s in t.steps] == \
            [dataclasses.astuple(s) for s in j.steps]
        assert t == t_plan.lower_fused(
            tplan.with_precision(t_plan.Precision(prec)))[0]
    unknown = dataclasses.make_dataclass("Unknown", [("name", str, "")])
    with pytest.raises(t_fref.FusedPlanUnsupported):
        t_plan.PackedPlan(ops=(unknown(),), params={}, n_masks=2).fused_spec()
    with pytest.raises(j_fref.FusedPlanUnsupported):
        j_plan.PackedPlan(ops=(unknown(),), params={}, n_masks=2).fused_spec()


@pytest.mark.parametrize("packed", (False, True))
def test_decode_modeled_latency_matches_reference(packed):
    """decode_modeled_latency over the same decode spec: within TOL_MODEL
    of the reference under its spec, fused and per-op, bf16 and fp32
    weights; on the H100 the fused step is priced below the per-op one
    (2L + 2 launches against one)."""
    kw = dict(n_layers=2, packed_ffn_serving=packed)
    jspec = j_plan.lower_fused_decode(j_registry.smoke_config("qwen2-1.5b",
                                                              **kw))
    tspec = t_plan.lower_fused_decode(t_registry.smoke_config("qwen2-1.5b",
                                                              **kw))
    spec = _v5e_as_port_spec()
    for fused in (True, False):
        for bpe in (2, 4):
            np.testing.assert_allclose(
                t_plan.decode_modeled_latency(tspec, 12, 9, device=spec,
                                              bytes_per_el=bpe, fused=fused),
                j_plan.decode_modeled_latency(jspec, 12, 9, tpu=j_lat.V5E,
                                              bytes_per_el=bpe, fused=fused),
                rtol=TOL_MODEL)
    fused_s = t_plan.decode_modeled_latency(tspec, 32, 160)
    perop_s = t_plan.decode_modeled_latency(tspec, 32, 160, fused=False)
    assert 0 < fused_s < perop_s
    tm = t_plan.decode_traffic(tspec, 32, 160)
    np.testing.assert_allclose(
        fused_s, max(tm.flops / t_lat.H100.peak_flops,
                     tm.total_bytes / t_lat.H100.hbm_bw)
        + t_lat.H100.kernel_fill_us * 1e-6, rtol=TOL_MODEL)


# ---------------------------------------------------------------------------
# A.6 obs: crosscheck and get_tracer
# ---------------------------------------------------------------------------


def _fidelity_pair(t_tm, j_tm, **kw):
    t_stages = kw.pop("t_stages", None)
    j_stages = kw.pop("j_stages", None)
    got = t_obs.crosscheck.model_fidelity(
        step_traffic=t_tm, device=_v5e_as_port_spec(), stages=t_stages, **kw)
    want = j_cc.model_fidelity(step_traffic=j_tm, tpu=j_lat.V5E,
                               stages=j_stages, **kw)
    return got, want


def test_model_fidelity_matches_reference(ivim_plans):
    """model_fidelity on the same modeled traffic and measured time: the
    reference's block, key for key within TOL_MODEL, with ``device`` where
    the reference writes ``tpu`` — for an IVIM slab (unit voxel) and a
    decode step with its stages (unit token); roofline_seconds alike."""
    jplan, tplan = ivim_plans
    got, want = _fidelity_pair(
        tplan.traffic(4096, 2, fused=True, moments=True),
        jplan.traffic(4096, 2, fused=True, moments=True),
        measured_wall_s=0.031, n_units=393216, units_per_step=4096,
        unit="voxel")
    kw = dict(n_layers=2)
    jspec = j_plan.lower_fused_decode(j_registry.smoke_config("qwen2-1.5b",
                                                              **kw))
    tspec = t_plan.lower_fused_decode(t_registry.smoke_config("qwen2-1.5b",
                                                              **kw))
    got2, want2 = _fidelity_pair(
        t_plan.decode_traffic(tspec, 8, 24), j_plan.decode_traffic(jspec, 8,
                                                                   24),
        t_stages=t_plan.decode_stage_traffic(tspec, 8, 24),
        j_stages=j_plan.decode_stage_traffic(jspec, 8, 24),
        measured_wall_s=1.7, n_units=422, units_per_step=2)
    for g, w in ((got, want), (got2, want2)):
        assert g.pop("device") == w.pop("tpu") == "tpu-v5e"
        assert g.keys() == w.keys()
        for k in g:
            if k == "stages":
                assert g[k].keys() == w[k].keys()
                for name in g[k]:
                    for f, v in g[k][name].items():
                        np.testing.assert_allclose(v, w[k][name][f],
                                                   rtol=TOL_MODEL)
            elif isinstance(g[k], str):
                assert g[k] == w[k]
            else:
                np.testing.assert_allclose(g[k], w[k], rtol=TOL_MODEL,
                                           err_msg=k)
    assert "stages" in got2 and got2["unit"] == "token"
    h = t_obs.crosscheck.model_fidelity(
        measured_wall_s=0.5, n_units=10, units_per_step=2,
        step_traffic=t_plan.decode_traffic(tspec, 8, 24))
    assert h["device"] == t_lat.H100.name
    assert h["ratio_measured_to_modeled"] > 0
    np.testing.assert_allclose(
        t_obs.crosscheck.roofline_seconds(t_plan.decode_traffic(tspec, 8, 24),
                                          _v5e_as_port_spec()),
        j_cc.roofline_seconds(j_plan.decode_traffic(jspec, 8, 24),
                              j_lat.V5E), rtol=TOL_MODEL)


def test_get_tracer_and_lazy_crosscheck():
    assert t_trace.get_tracer() is t_trace.TRACER
    assert t_obs.crosscheck is sys.modules["repro_torch.obs.crosscheck"]
    with pytest.raises(AttributeError):
        t_obs.nonexistent  # noqa: B018


# ---------------------------------------------------------------------------
# elastic + straggler (the twins of tests/test_distributed.py's)
# ---------------------------------------------------------------------------


def test_remesh_prefers_model_axis():
    plan = elastic.plan_remesh({"pod": 2, "data": 16, "model": 16},
                               n_alive=384)
    assert plan.new_shape["model"] == 16          # TP groups preserved
    assert not plan.reshard_required
    assert plan.new_size <= 384


def test_remesh_degrades_gracefully():
    plan = elastic.plan_remesh({"data": 16, "model": 16}, n_alive=24)
    assert 16 <= plan.new_size <= 24


def test_remesh_matches_reference():
    """Every field of the plan equals the reference's over a grid of mesh
    shapes and survivor counts, the router's {"pod": n} meshes among
    them."""
    shapes = ({"pod": 3, "data": 1, "model": 1}, {"pod": 2, "data": 1,
                                                  "model": 1},
              {"pod": 2, "data": 16, "model": 16}, {"data": 16, "model": 16},
              {"data": 8, "model": 4}, {"pod": 4, "data": 2, "model": 2})
    for shape in shapes:
        size = int(np.prod(list(shape.values())))
        for alive in range(1, size + 1, max(1, size // 17)):
            got = elastic.plan_remesh(shape, alive)
            want = j_elastic.plan_remesh(shape, alive)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            assert got.new_size == want.new_size


def test_remesh_no_survivors_raises_value_error():
    with pytest.raises(ValueError, match="nothing left to remesh"):
        elastic.plan_remesh({"pod": 2, "data": 4, "model": 2}, n_alive=0)


def test_grad_accum_preserves_global_batch():
    accum = elastic.grad_accum_for_batch(global_batch=256, old_dp=32,
                                         new_dp=24, old_accum=1)
    assert accum * 24 >= 32


def test_grad_accum_rejects_inconsistent_schedule():
    with pytest.raises(ValueError, match="not divisible"):
        elastic.grad_accum_for_batch(global_batch=100, old_dp=32,
                                     new_dp=24, old_accum=1)
    with pytest.raises(ValueError, match=">= 1"):
        elastic.grad_accum_for_batch(global_batch=256, old_dp=32,
                                     new_dp=0, old_accum=1)


def test_grad_accum_invariant_grid():
    """The post-remesh schedule never consumes fewer micro-batches than the
    pre-remesh one, stays minimal, and equals the reference's count."""
    for old_dp, old_accum in [(32, 1), (32, 4), (8, 2), (16, 3)]:
        total_micro = old_dp * old_accum
        for new_dp in [1, 2, 3, 5, 7, 8, 24, 31, 32]:
            accum = elastic.grad_accum_for_batch(
                global_batch=total_micro * 4, old_dp=old_dp,
                new_dp=new_dp, old_accum=old_accum)
            assert new_dp * accum >= total_micro > new_dp * (accum - 1)
            assert accum == j_elastic.grad_accum_for_batch(
                total_micro * 4, old_dp, new_dp, old_accum)


def test_straggler_detection_and_escalation():
    mon = straggler.StragglerMonitor(window=20, patience=2)
    for i in range(10):
        assert mon.report(i, 1.0).severity == "ok"
    assert mon.report(10, 1.7).severity == "slow"
    assert mon.report(11, 4.0).severity == "straggler"
    assert not mon.should_escalate
    assert mon.report(12, 4.2).severity == "straggler"
    assert mon.should_escalate


def test_straggler_min_samples_warmup():
    mon = straggler.StragglerMonitor(window=20, patience=1, min_samples=5)
    for i, dt in enumerate([5.0, 0.1, 9.0, 0.2, 3.0]):
        assert mon.report(i, dt).severity == "ok"
        assert not mon.should_escalate
    with pytest.raises(ValueError):
        straggler.StragglerMonitor(window=8, min_samples=0)


def test_straggler_escalation_does_not_latch():
    mon = straggler.StragglerMonitor(window=20, patience=2, min_samples=5)
    for i in range(8):
        mon.report(i, 1.0)
    assert mon.report(8, 5.0).severity == "straggler"
    assert not mon.should_escalate
    mon.report(9, 5.0)
    assert mon.should_escalate
    mon.report(10, 1.0)
    assert not mon.should_escalate
    mon.report(11, 5.0)
    assert not mon.should_escalate


def test_straggler_monitor_matches_reference():
    """The same seeded step-time stream through both monitors: every report
    and every escalation decision equal, across the window's turnover."""
    rng = np.random.default_rng(0)
    times = np.where(rng.random(300) < 0.2, rng.uniform(2, 8, 300),
                     rng.uniform(0.5, 1.5, 300))
    kw = dict(window=16, straggler_factor=3.0, patience=2, min_samples=4)
    t_mon = straggler.StragglerMonitor(**kw)
    j_mon = j_straggler.StragglerMonitor(**kw)
    escalations = 0
    for i, dt in enumerate(times.tolist()):
        assert dataclasses.asdict(t_mon.report(i, dt)) == \
            dataclasses.asdict(j_mon.report(i, dt))
        assert t_mon.should_escalate == j_mon.should_escalate
        escalations += t_mon.should_escalate
    assert escalations > 0
