"""uIVIM-NET through the port against the JAX package: the same weights
(crossed over by ``params_from_jax``) and the same numpy voxels go through
both, at the clinical width 11 and the dense width 104, with 1 and 4 masks.
The port runs its plain versions on the CPU; the reference runs its XLA
tier. Tolerances: 1e-5 for one forward pass, 1e-6 for the packed weights
after BN folding, 2e-4 for moments (the reference's own fused-vs-per-op
tolerance)."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.core import masks as j_masks
from repro.core import plan as j_plan
from repro.core import uncertainty as j_unc
from repro.ivim import model as j_model
from repro.ivim import physics as j_physics
from repro.serving import engine as j_engine
from repro_torch.core import plan as t_plan
from repro_torch.ivim import data as t_data
from repro_torch.ivim import model as t_model
from repro_torch.ivim import physics as t_physics
from repro_torch.kernels.fused_plan import ops as t_fops
from repro_torch.serving import engine as t_engine

TOL_FWD = 1e-5
TOL_PACK = 1e-6
TOL_MOMENTS = 2e-4
B_VALUES = {11: j_physics.CLINICAL_B_VALUES, 104: j_physics.DENSE_B_VALUES}
CONFIGS = [(11, 1), (11, 4), (104, 1), (104, 4)]
CPU = "cpu"


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@functools.lru_cache(maxsize=None)
def _jax_model(width, n):
    """Reference-shaped ``(params, state)`` trees drawn with numpy — He
    weights, non-trivial biases and BN statistics (so folding is
    exercised), the reference's own masks — plus 37 voxels."""
    cfg = j_model.IvimConfig(b_values=B_VALUES[width], n_masks=n)
    rng = np.random.default_rng(width * 10 + n)

    def draw(shape, lo=None, scale=None):
        v = rng.uniform(size=shape) + lo if lo is not None else \
            rng.normal(size=shape) * scale
        return v.astype(np.float32)

    g = len(j_model.PARAM_NAMES)
    params = {fc: {"w": draw((g, width, d_out), scale=np.sqrt(2 / width)),
                   "b": draw((g, d_out), scale=0.1)}
              for fc, d_out in (("fc1", width), ("fc2", width), ("enc", 1))}
    state = {}
    for slot in ("bn1", "bn2"):
        state[slot] = {"mean": draw((g, width), scale=0.2),
                       "var": draw((g, width), lo=0.5)}
        params[slot] = {"gamma": draw((g, width), lo=0.5),
                        "beta": draw((g, width), scale=0.1)}
    for i, slot in enumerate(("mask1", "mask2")):
        params[slot] = j_masks.generate_masks(j_masks.MaskSpec(
            width, n, cfg.scale, seed=cfg.mask_seed + i)).astype(np.float32)
    x = rng.uniform(0.2, 1.1, size=(37, width)).astype(np.float32)
    return cfg, params, state, x


def _port_model(width, n):
    cfg, params, state, x = _jax_model(width, n)
    tcfg = t_model.IvimConfig(b_values=B_VALUES[width], n_masks=n)
    return t_model.params_from_jax(tcfg, params, state, device=CPU), \
        torch.from_numpy(x)


@functools.lru_cache(maxsize=None)
def _jax_outputs(width, n):
    cfg, params, state, x = _jax_model(width, n)
    plan = j_plan.compile_ivim(cfg, params, state)
    samples = jax.jit(lambda v: j_plan.execute(plan, v, backend="xla"))(x)
    volume = x[:30].reshape(3, 5, 2, width)
    out = {"samples": samples,
           "moments": j_unc.predictive_moments(samples),
           "fused_moments": j_plan.execute_fused(plan, x, moments=True,
                                                 backend="xla"),
           "volume": j_engine.predict_volume(plan, volume, chunk=8,
                                             backend="xla")}
    return {"plan": plan, **jax.tree.map(np.asarray, out)}


@pytest.mark.parametrize("width,n", CONFIGS)
def test_params_from_jax_round_trip(width, n):
    cfg, params, state, _ = _jax_model(width, n)
    model, _ = _port_model(width, n)
    got_p, got_s = model.trees()
    flat_want = jax.tree_util.tree_leaves_with_path((params, state))
    flat_got = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.detach().numpy(), (got_p, got_s)))
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (_, g), (_, w) in zip(flat_got, flat_want):
        assert g.dtype == np.float32 and np.array_equal(g, w)
    with torch.no_grad():                   # the module owns copies
        model.bn1_mean.add_(1.0)
    assert not np.array_equal(model.bn1_mean.numpy(), state["bn1"]["mean"])


@pytest.mark.parametrize("width,n", CONFIGS)
def test_apply_and_predict_match(width, n):
    cfg, params, state, x = _jax_model(width, n)
    model, tx = _port_model(width, n)
    model.eval()
    apply = jax.jit(lambda p, s, v: j_model.apply(cfg, p, s, v)[0])
    predict = jax.jit(lambda p, s, v: (j_model.apply_all_samples(cfg, p, s, v),
                                       j_model.predict(cfg, p, s, v)))
    samples, moments = predict(params, state, x)
    with torch.no_grad():
        _close(model(tx), apply(params, state, x), TOL_FWD)
    _close(t_model.apply_all_samples(model, tx), samples, TOL_FWD)
    for got, want in zip(t_model.predict(model, tx), moments):
        _close(got, want, TOL_FWD)


def test_train_mode_batchnorm_matches():
    """Training-mode BN: batch statistics, and the running buffers updated
    as the reference's new state."""
    cfg, params, state, x = _jax_model(11, 4)
    model, tx = _port_model(11, 4)
    model.train()
    want, new_state = jax.jit(lambda p, s, v: j_model.apply(
        cfg, p, s, v, train=True))(params, state, x)
    with torch.no_grad():
        _close(model(tx), want, TOL_FWD)
    for i in (1, 2):
        _close(getattr(model, f"bn{i}_mean"), new_state[f"bn{i}"]["mean"],
               TOL_FWD)
        _close(getattr(model, f"bn{i}_var"), new_state[f"bn{i}"]["var"],
               TOL_FWD)


@pytest.mark.parametrize("width,n", CONFIGS)
def test_compile_ivim_matches(width, n):
    jplan = _jax_outputs(width, n)["plan"]
    model, _ = _port_model(width, n)
    tplan = t_model.pack_for_serving(model)
    assert [dataclasses.astuple(o) for o in tplan.ops] == \
        [dataclasses.astuple(o) for o in jplan.ops]
    assert (tplan.n_masks, tplan.groups, tplan.out_ranges) == \
        (jplan.n_masks, jplan.groups, jplan.out_ranges)
    for op in ("body", "head"):
        assert sorted(tplan.params[op]) == sorted(jplan.params[op])
        for k, want in jplan.params[op].items():
            got = tplan.params[op][k]
            assert tuple(got.shape) == want.shape and got.is_contiguous()
            assert not got.requires_grad
            _close(got, want, TOL_PACK)
    for fused, moments in ((False, False), (True, False), (True, True)):
        tt = tplan.traffic(4096, 4, fused=fused, moments=moments)
        jt = jplan.traffic(4096, 4, fused=fused, moments=moments)
        assert (tt.weight_bytes, tt.act_bytes, tt.flops, tt.weight_loads) \
            == (jt.weight_bytes, jt.act_bytes, jt.flops, jt.weight_loads)
    assert t_plan.lower_fused(tplan)[0].n_rows == tplan.sample_axis == 4 * n
    assert tplan.slot_schedule(3) == t_plan.sched_lib.SlotSchedule(n, 3)


@pytest.mark.parametrize("width,n", CONFIGS)
def test_executors_match(width, n):
    want = _jax_outputs(width, n)
    model, tx = _port_model(width, n)
    plan = t_model.pack_for_serving(model)
    _close(t_plan.execute(plan, tx, device=CPU), want["samples"],
           TOL_MOMENTS)
    _close(t_model.packed_apply(plan, tx, fused=True, device=CPU),
           want["samples"], TOL_MOMENTS)
    fused = t_plan.execute_fused(plan, tx, moments=True, device=CPU)
    for got, jf, jm in zip(fused, want["fused_moments"], want["moments"]):
        _close(got, jf, TOL_MOMENTS)
        _close(got, jm, TOL_MOMENTS)
    for mode in (True, False, None):       # chunk 16 does not divide 37
        got = t_engine.predict_packed(plan, tx, chunk=16, fused=mode,
                                      device=CPU)
        for g, w in zip(got, want["moments"]):
            _close(g, w, TOL_MOMENTS)
    vol = tx[:30].reshape(3, 5, 2, width)
    got = t_engine.predict_volume(plan, vol, chunk=8, device=CPU)
    for g, w in zip(got, want["volume"]):
        assert tuple(g.shape) == (3, 5, 2, 4)
        _close(g, w, TOL_MOMENTS)


def _hand_plans(activation):
    """The same hand-built PackedPlan in both packages, with the op kinds
    the IVIM compiler does not emit: a SharedDense prefix, a pair with a
    shared bias (relu: the masked_ffn path; gelu: the batched-product
    path), a bare Activation and a shared OutputHead."""
    rng = np.random.default_rng(7)
    n, d, dp, hid, d2, do = 3, 6, 8, 10, 7, 2
    masks = j_masks.generate_masks(j_masks.MaskSpec(hid, n, 2.0))
    k = int(masks[0].sum())

    def w(*shape):
        return (rng.normal(size=shape) * 0.5).astype(np.float32)

    params = {"pre": {"w": w(d, dp), "b": w(dp)},
              "pair": {"w1p": w(n, dp, k), "b1p": w(n, k), "w2p": w(n, k, d2),
                       "b2": w(d2)},
              "head": {"w": w(d2, do), "b": w(do)}}

    def ops(lib):
        return (lib.SharedDense("pre", d_in=d, d_out=dp, activation="tanh"),
                lib.PackedPair("pair", d_in=dp, hidden=hid, keep=k, d_out=d2,
                               activation=activation),
                lib.Activation("silu"),
                lib.OutputHead("head", d_in=d2, d_out=do,
                               activation="sigmoid", per_mask=False))

    jplan = j_plan.PackedPlan(ops=ops(j_plan), params=params, n_masks=n)
    tplan = t_plan.PackedPlan(ops=ops(t_plan), n_masks=n,
                              params=t_plan.tree_map(torch.from_numpy, params))
    return jplan, tplan, rng.uniform(size=(11, d)).astype(np.float32)


@pytest.mark.parametrize("activation", ("relu", "gelu"))
def test_hand_built_plan_matches(activation):
    jplan, tplan, x = _hand_plans(activation)
    tx = torch.from_numpy(x)
    want = j_plan.execute(jplan, x, backend="xla")
    _close(t_plan.execute(tplan, tx, device=CPU), want, TOL_FWD)
    _close(t_plan.execute_fused(tplan, tx, device=CPU),
           j_plan.execute_fused(jplan, x, backend="xla"), TOL_FWD)
    for got, w in zip(t_plan.execute_fused(tplan, tx, moments=True,
                                           device=CPU),
                      j_unc.predictive_moments(want)):
        _close(got, w, TOL_MOMENTS)


def test_compile_masked_ffn_matches():
    rng = np.random.default_rng(8)
    w1, b1, w2, b2 = (rng.normal(size=s).astype(np.float32) * 0.4
                      for s in ((9, 24), (24,), (24, 5), (5,)))
    masks = j_masks.generate_masks(j_masks.MaskSpec(24, 4, 2.0))
    jplan = j_plan.compile_masked_ffn(w1, b1, w2, b2, masks)
    tplan = t_plan.compile_masked_ffn(*map(torch.from_numpy, (w1, b1, w2, b2)),
                                      masks)
    for k, want in jplan.params["pair"].items():
        got = tplan.params["pair"][k]
        assert got.is_contiguous() and np.array_equal(got.numpy(), want)
    x = rng.uniform(size=(6, 9)).astype(np.float32)
    _close(t_plan.execute(tplan, torch.from_numpy(x), device=CPU),
           j_plan.execute(jplan, x, backend="xla"), TOL_FWD)


def test_packed_paths_match_unpacked_model():
    model, tx = _port_model(104, 4)
    plan = t_model.pack_for_serving(model)
    want = t_model.apply_all_samples(model, tx)
    for fused in (False, True):
        _close(t_model.packed_apply(plan, tx, fused=fused, device=CPU), want,
               TOL_MOMENTS)
    folded = t_model.fold_bn(model)
    assert "bn1" not in folded and folded["fc1"]["w"].shape == (4, 104, 104)


def test_stream_lowers_once():
    model, tx = _port_model(11, 4)
    plan = t_model.pack_for_serving(model)
    key = ("plan", t_plan.lower_fused(plan)[0], torch.device(CPU), True)
    before = t_plan.build_counts[key]
    t_engine.predict_packed(plan, tx, chunk=5, fused=True, device=CPU)
    assert t_plan.build_counts[key] == before + 1
    t_engine.predict_packed(plan, tx, chunk=5, fused=True, device=CPU)
    assert t_plan.build_counts[key] == before + 1     # built once a plan


def test_runner_falls_back_only_on_unsupported(monkeypatch):
    model, tx = _port_model(11, 4)
    plan = t_model.pack_for_serving(model)
    xc = tx[:8]
    want = t_engine.plan_chunk_runner(plan, fused=False, device=CPU)(xc)

    def guard(fp, x):
        raise t_fops.FusedPlanUnsupported("residency guard (test)")

    monkeypatch.setattr(t_fops, "fused_moments", guard)
    before = dict(t_engine.fallback_counts)
    runner = t_engine.plan_chunk_runner(plan, device=CPU)
    for _ in range(2):                      # decided once, then per-op
        for g, w in zip(runner(xc), want):
            _close(g, w, 0.0)
    assert t_engine.fallback_counts["call"] == before.get("call", 0) + 1
    with pytest.raises(t_fops.FusedPlanUnsupported):
        t_engine.plan_chunk_runner(plan, fused=True, device=CPU)(xc)
    with pytest.raises(t_fops.FusedPlanUnsupported):
        t_engine.predict_packed(plan, xc, fused=True, device=CPU)

    def broken(fp, x):
        raise RuntimeError("launch failed (test)")

    monkeypatch.setattr(t_fops, "fused_moments", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        t_engine.plan_chunk_runner(plan, device=CPU)(xc)
    with pytest.raises(RuntimeError, match="launch failed"):
        t_engine.predict_packed(plan, xc, device=CPU)

    def no_lowering(plan):
        raise t_fops.FusedPlanUnsupported("no fused form (test)")

    monkeypatch.setattr(t_plan, "lower_fused", no_lowering)
    runner = t_engine.plan_chunk_runner(plan, device=CPU)
    assert t_engine.fallback_counts["build"] == before.get("build", 0) + 1
    for g, w in zip(runner(xc), want):
        _close(g, w, 0.0)


def test_physics_and_data():
    assert t_physics.DENSE_B_VALUES == j_physics.DENSE_B_VALUES
    assert t_physics.CLINICAL_B_VALUES == j_physics.CLINICAL_B_VALUES
    rng = np.random.default_rng(0)
    p = [rng.uniform(lo, hi, size=20).astype(np.float32) for lo, hi in
         ((5e-4, 3e-3), (0.01, 0.1), (0.0, 0.4), (0.8, 1.2))]
    b = np.asarray(j_physics.DENSE_B_VALUES, np.float32)
    _close(t_physics.ivim_signal(torch.from_numpy(b),
                                 *map(torch.from_numpy, p)),
           j_physics.ivim_signal(b, *p), 1e-6)
    cfg = t_data.SyntheticConfig(n_voxels=64, b_values=b.tolist(), seed=3)
    ds = t_data.make_dataset(cfg, device=CPU)
    again = t_data.make_dataset(cfg, device=CPU)
    assert ds["signals"].shape == ds["clean"].shape == (64, 104)
    assert torch.equal(ds["signals"], again["signals"])
    assert torch.all(ds["signals"][:, 0] == 1.0)      # b=0 normalisation
    r = t_physics.DEFAULT_RANGES
    assert float(ds["params"]["D"].min()) >= r.d_min
    assert float(ds["params"]["f"].max()) <= r.f_max
