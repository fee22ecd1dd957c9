"""The paper's design flow through the port against the JAX package, on the
CPU: train uIVIM-NET (``ivim/data.Batcher``, ``ivim/train``), evaluate it
over the SNR sweep (``ivim/evaluate``), and emit the Phase-3 plan
(``core/transform``, ``core/plan.compile_mlp`` and ``modeled_latency``,
``core/latency_model``). The same numpy inputs, and the reference's
parameters carried over by ``params_from_jax``, go through both.

Tolerances, each stated where it is used:
  * batches: bit-identical (the same host permutation, the same rows);
  * ``reconstruct`` and ``loss_fn``: 1e-6 (one fp32 forward pass);
  * five Adam steps: loss 1e-5 relative; every Adam moment and every
    parameter 1e-5 — except the directions that batch-statistics BN makes
    invisible (TRAIN_NULL below), whose gradients are float noise that Adam
    normalises to steps of about ``lr``: those are held to 2·steps·lr;
  * the SNR sweep: 1e-5 relative on RMSE, per-parameter RMSE and rel-unc;
  * plan execution: 1e-5; the latency model under the reference's own spec:
    1e-9 relative (the same formulas in double precision).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import latency_model as j_lat
from repro.core import plan as j_plan
from repro.core import transform as j_transform
from repro.ivim import data as j_data
from repro.ivim import evaluate as j_eval
from repro.ivim import model as j_model
from repro.ivim import train as j_train
from repro_torch.core import latency_model as t_lat
from repro_torch.core import plan as t_plan
from repro_torch.core import transform as t_transform
from repro_torch.ivim import data as t_data
from repro_torch.ivim import evaluate as t_eval
from repro_torch.ivim import model as t_model
from repro_torch.ivim import train as t_train
from repro_torch.kernels.moments import ops as t_mo_ops

CPU = "cpu"
TOL_FWD = 1e-6
TOL_STEP = 1e-5
TOL_SWEEP = 1e-5
TOL_PLAN = 1e-5
TOL_MODEL = 1e-9


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _dataset(n_voxels=600, seed=0, snr=20.0):
    return j_data.make_dataset(j_data.SyntheticConfig(
        n_voxels=n_voxels, snr=snr, seed=seed))


# ---------------------------------------------------------------------------
# data and loss
# ---------------------------------------------------------------------------


def test_batcher_bit_identical_to_reference():
    sig = np.array(_dataset(1000)["signals"])
    jb = j_data.Batcher({"signals": sig}, 128, seed=7)
    tb = t_data.Batcher({"signals": torch.from_numpy(sig)}, 128, seed=7)
    assert tb.batches_per_epoch == jb.batches_per_epoch == 7
    for step in range(2 * tb.batches_per_epoch + 4):    # crosses two epochs
        got, want = tb.batch(step), np.asarray(jb.batch(step))
        assert got.dtype == torch.float32
        assert np.array_equal(got.numpy(), want), step
    with pytest.raises(ValueError, match="batch_size"):
        t_data.Batcher({"signals": torch.from_numpy(sig[:5])}, 8)


def test_reconstruct_and_loss_match_reference():
    jcfg = j_model.IvimConfig(n_masks=4, scale=2.0)
    tcfg = t_model.IvimConfig(n_masks=4, scale=2.0)
    rng = np.random.default_rng(0)
    pred = np.stack([rng.uniform(lo, hi, 50) for lo, hi in jcfg.out_ranges],
                    -1).astype(np.float32)
    np.testing.assert_allclose(
        t_model.reconstruct(tcfg, torch.from_numpy(pred)).numpy(),
        np.asarray(j_model.reconstruct(jcfg, jnp.asarray(pred))),
        rtol=TOL_FWD, atol=TOL_FWD)
    params, state = j_model.init(jcfg, jax.random.PRNGKey(0))
    x = np.array(_dataset(128)["signals"])
    want, want_state = j_train.loss_fn(jcfg, params, state, jnp.asarray(x))
    model = t_model.params_from_jax(tcfg, _np(params), _np(state), device=CPU)
    got = t_train.loss_fn(model, torch.from_numpy(x))
    np.testing.assert_allclose(got.item(), float(want), rtol=TOL_FWD)
    got.backward()                        # masks are buffers: no gradient
    assert all(p.grad is not None for p in model.parameters())
    for i in (1, 2):                      # BN ran on batch statistics
        for k in ("mean", "var"):
            np.testing.assert_allclose(
                getattr(model, f"bn{i}_{k}").numpy(),
                np.asarray(want_state[f"bn{i}"][k]), rtol=TOL_FWD,
                atol=TOL_FWD)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

#: Directions the loss cannot see in training: the biases ahead of each BN
#: (the batch mean removes them) and fc1's row for the b=0 input, which is
#: 1.0 in every voxel (signals are divided by the measured S(b=0)), so it
#: acts as a second bias. Their gradients are float noise (~1e-9) that
#: Adam's m / (sqrt(v) + eps) turns into steps of about lr, in whichever
#: direction the noise points in each framework.
TRAIN_NULL = {"fc1.b": (...,), "fc2.b": (...,), "fc1.w": (0,)}


@pytest.mark.parametrize("lr", [1e-3, 3e-3])
def test_train_step_matches_reference(lr):
    steps = 5
    null_bound = 2 * steps * lr
    jcfg = j_model.IvimConfig(n_masks=4, scale=2.0)
    tcfg = t_model.IvimConfig(n_masks=4, scale=2.0)
    params, state = j_model.init(jcfg, jax.random.PRNGKey(0))
    sig = np.array(_dataset(600)["signals"])
    assert (sig[:, 0] == 1.0).all()
    jb = j_data.Batcher({"signals": sig}, 128, seed=0)
    tb = t_data.Batcher({"signals": torch.from_numpy(sig)}, 128, seed=0)
    jstep, jinit = j_train.make_train_step(jcfg, j_train.TrainConfig(lr=lr))
    tstep, tinit = t_train.make_train_step(tcfg, t_train.TrainConfig(lr=lr))
    model = t_model.params_from_jax(tcfg, _np(params), _np(state), device=CPU)
    jopt, topt = jinit(params), tinit(model)
    for i in range(steps):
        params, state, jopt, jloss = jstep(params, state, jopt, jb.batch(i))
        tloss = tstep(model, topt, tb.batch(i))
        np.testing.assert_allclose(tloss.item(), float(jloss), rtol=TOL_STEP)
    assert topt["count"] == int(jopt["count"]) == steps
    for slot in ("mask1", "mask2"):       # the reference's masks: no update
        assert not np.asarray(jopt["mu"][slot]).any()
        np.testing.assert_array_equal(getattr(model, slot).numpy(),
                                      np.asarray(params[slot]))
    for name, p in model.named_parameters():
        a, b = name.split(".")
        for key, got in (("mu", topt["mu"][name]), ("nu", topt["nu"][name])):
            np.testing.assert_allclose(got.numpy(),
                                       np.asarray(jopt[key][a][b]),
                                       rtol=TOL_STEP, atol=TOL_STEP)
        got, want = p.detach().numpy().copy(), np.asarray(params[a][b]).copy()
        if name in TRAIN_NULL:
            idx = (slice(None),) + TRAIN_NULL[name]      # [4, ...] stacked
            assert np.abs(topt["mu"][name].numpy()[idx]).max() < 1e-6
            assert np.abs(got[idx] - want[idx]).max() <= null_bound
            got[idx] = want[idx] = 0.0
        np.testing.assert_allclose(got, want, rtol=TOL_STEP, atol=TOL_STEP,
                                   err_msg=name)
    for i in (1, 2):
        # the running mean sums the batch means, null directions included
        np.testing.assert_allclose(getattr(model, f"bn{i}_mean").numpy(),
                                   np.asarray(state[f"bn{i}"]["mean"]),
                                   rtol=0, atol=null_bound)
        np.testing.assert_allclose(getattr(model, f"bn{i}_var").numpy(),
                                   np.asarray(state[f"bn{i}"]["var"]),
                                   rtol=TOL_STEP, atol=TOL_STEP)


def test_train_reduces_loss():
    """The reference's test_training_reduces_loss bar (the last 10 losses
    below 0.8x the first 10) at its system test's settings (clinical
    protocol, N 4, 250 steps, batch 128, lr 3e-3)."""
    cfg = t_model.IvimConfig(n_masks=4, scale=2.0)
    tcfg = t_train.TrainConfig(steps=250, batch_size=128, lr=3e-3, seed=0)
    model, hist = t_train.train(cfg, tcfg, device=CPU)
    assert len(hist) == 250 and np.isfinite(hist).all()
    assert np.mean(hist[-10:]) < 0.8 * np.mean(hist[:10])
    assert all(p.device.type == "cpu" for p in model.parameters())


# ---------------------------------------------------------------------------
# the SNR sweep
# ---------------------------------------------------------------------------


def test_snr_sweep_matches_reference(monkeypatch):
    jcfg = j_model.IvimConfig(n_masks=4, scale=2.0)
    tcfg = t_model.IvimConfig(n_masks=4, scale=2.0)
    params, state = j_model.init(jcfg, jax.random.PRNGKey(1))
    model = t_model.params_from_jax(tcfg, _np(params), _np(state), device=CPU)
    calls = []

    def reference_dataset(cfg, device=None):
        """The reference's scenario for the same config, as tensors."""
        calls.append(cfg.snr)
        ds = j_data.make_dataset(j_data.SyntheticConfig(
            n_voxels=cfg.n_voxels, snr=cfg.snr, b_values=cfg.b_values,
            seed=cfg.seed))
        return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), ds)

    monkeypatch.setattr(t_data, "make_dataset", reference_dataset)
    before = t_mo_ops.moments.launches
    got = t_eval.evaluate_snr_sweep(model, n_voxels=300, device=CPU)
    assert t_mo_ops.moments.launches == before       # CPU: plain version
    want = j_eval.evaluate_snr_sweep(jcfg, params, state, n_voxels=300)
    assert calls == list(j_data.SNR_LEVELS) and sorted(got) == sorted(want)
    for snr, w in want.items():
        g = got[snr]
        np.testing.assert_allclose(g["rmse_recon"], w["rmse_recon"],
                                   rtol=TOL_SWEEP)
        for key in ("rmse_params", "rel_unc"):
            for name in j_model.PARAM_NAMES:
                np.testing.assert_allclose(g[key][name], w[key][name],
                                           rtol=TOL_SWEEP, err_msg=key)
    for req in (None, t_eval.unc_lib.UncertaintyRequirements(tolerance=0.0)):
        jreq = None if req is None else j_eval.unc_lib.UncertaintyRequirements(
            tolerance=0.0)
        grep, wrep = (t_eval.requirement_report(got, req),
                      j_eval.requirement_report(want, jreq))
        assert grep.satisfied == wrep.satisfied
        assert len(grep.failures) == len(wrep.failures)


# ---------------------------------------------------------------------------
# Phase 3: compile_mlp, execute, the latency model and plan_hardware
# ---------------------------------------------------------------------------

MLPS = {
    "pair_pair_head": ((7, 16, 16, 2), (1, 2), 4, 2.0),
    "shared_prefix": ((9, 12, 16, 16, 3), (2, 3), 4, 2.0),
    "pair_absorbs_head": ((6, 14, 2), (1,), 4, 2.0),
    "flow": ((11, 32, 32, 1), (1, 2), 4, 2.0),
}


def _mlp(widths, dropout_after, n_masks, scale, seed=0):
    spec = j_transform.MlpSpec(widths=widths, dropout_after=dropout_after,
                               final_activation="sigmoid")
    jm = j_transform.convert(spec, n_masks=n_masks, scale=scale,
                             key=jax.random.PRNGKey(seed))
    return jm, t_transform.params_from_jax(jm, device=CPU)


@pytest.mark.parametrize("name", sorted(MLPS))
def test_compile_mlp_matches_reference(name):
    jm, tm = _mlp(*MLPS[name])
    jp, tp = j_plan.compile_mlp(jm), t_plan.compile_mlp(tm)
    assert [type(op).__name__ for op in tp.ops] == \
        [type(op).__name__ for op in jp.ops]
    for t_op, j_op in zip(tp.ops, jp.ops):
        assert dataclasses.asdict(t_op) == dataclasses.asdict(j_op)
    assert (tp.n_masks, tp.groups) == (jp.n_masks, jp.groups)
    for op in tp.ops:                     # the gathers are exact
        for k, v in tp.params.get(getattr(op, "name", ""), {}).items():
            np.testing.assert_array_equal(
                v.numpy(), np.asarray(jp.params[op.name][k]))
    x = np.random.default_rng(2).normal(size=(9, tm.spec.widths[0])) \
        .astype(np.float32)
    want = j_plan.execute(jp, jnp.asarray(x), backend="xla")
    got = t_plan.execute(tp, torch.from_numpy(x), device=CPU)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL_PLAN,
                               atol=TOL_PLAN)
    own = tm.apply_all_samples(tm.params, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), own.numpy(), rtol=TOL_PLAN,
                               atol=TOL_PLAN)


def test_compile_mlp_unsupported_chain_raises():
    """An unmasked hidden layer after a masked run: both packages refuse."""
    jm, tm = _mlp((5, 8, 8, 8, 8, 2), (1, 2), 4, 2.0)
    with pytest.raises(NotImplementedError):
        j_plan.compile_mlp(jm)
    with pytest.raises(NotImplementedError, match="unmasked hidden layer"):
        t_plan.compile_mlp(tm)


def test_masked_mlp_matches_reference():
    jm, tm = _mlp(*MLPS["flow"])
    x = np.random.default_rng(1).normal(size=(16, 11)).astype(np.float32)
    np.testing.assert_allclose(
        tm.apply(tm.params, torch.from_numpy(x)).numpy(),
        np.asarray(jm.apply(jm.params, jnp.asarray(x))), rtol=TOL_PLAN,
        atol=TOL_PLAN)
    got = tm.predict(tm.params, torch.from_numpy(x))
    want = jm.predict(jm.params, jnp.asarray(x))
    for g, w in zip(got, want):
        assert g.shape == (16, 1)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL_PLAN,
                                   atol=TOL_PLAN)


def test_convert_masks_equal_reference():
    """The port's own conversion draws other weights (a torch.Generator)
    but the same masks, from the same seeds."""
    spec = t_transform.MlpSpec(widths=(11, 32, 32, 1), dropout_after=(1, 2))
    tm = t_transform.convert(spec, 4, 2.0, torch.Generator().manual_seed(0),
                             mask_seed=3, device=CPU)
    jm = j_transform.convert(j_transform.MlpSpec((11, 32, 32, 1), (1, 2)),
                             4, 2.0, jax.random.PRNGKey(0), mask_seed=3)
    assert sorted(tm.params) == sorted(jm.params)
    for name, layer in tm.params.items():
        assert sorted(layer) == sorted(jm.params[name])
        assert layer["w"].shape == jm.params[name]["w"].shape
        if "masks" in layer:
            np.testing.assert_array_equal(layer["masks"].numpy(),
                                          np.asarray(jm.params[name]["masks"]))
    with pytest.raises(ValueError, match="not a hidden layer"):
        t_transform.MlpSpec(widths=(3, 4, 2), dropout_after=(2,))
    assert list(t_transform.grid_search_space()) == \
        list(j_transform.grid_search_space())


def _v5e_as_port_spec():
    """The reference's own TPU spec, read here and mapped onto the port's
    field names — it is never written into the port."""
    v = dataclasses.asdict(j_lat.V5E)
    return t_lat.DeviceSpec(
        name=v["name"], peak_flops=v["peak_flops_bf16"], hbm_bw=v["hbm_bw"],
        link_bw=v["ici_bw_per_link"], hbm_bytes=v["hbm_bytes"],
        onchip_bytes=v["vmem_bytes"], tile=v["mxu"],
        kernel_fill_us=v["kernel_fill_us"])


def test_latency_model_formulas_match_reference():
    spec = _v5e_as_port_spec()
    for m, k, n in ((512, 11, 17), (64, 104, 52), (7, 300, 129)):
        for bpe in (2, 4):
            for res in (False, True):
                np.testing.assert_allclose(
                    t_lat.matmul_time(m, k, n, spec, bpe, res),
                    j_lat.matmul_time(m, k, n, j_lat.V5E, bpe, res),
                    rtol=TOL_MODEL)
    for packed in (False, True):
        for level in (False, True):
            np.testing.assert_allclose(
                t_lat.masked_ffn_latency(512, 8, 104, 104, 52, 104,
                                         packed=packed, batch_level=level,
                                         spec=spec),
                j_lat.masked_ffn_latency(512, 8, 104, 104, 52, 104,
                                         packed=packed, batch_level=level,
                                         spec=j_lat.V5E), rtol=TOL_MODEL)
    got = t_lat.roofline_terms(3e12, 4e9, 5e8, spec)
    want = j_lat.roofline_terms(3e12, 4e9, 5e8, j_lat.V5E)
    for f in ("compute_s", "memory_s", "collective_s", "bound_s"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=TOL_MODEL)
    assert got.dominant == want.dominant


@pytest.mark.parametrize("name", sorted(MLPS))
def test_modeled_latency_and_traffic_match_reference(name):
    jm, tm = _mlp(*MLPS[name])
    jp, tp = j_plan.compile_mlp(jm), t_plan.compile_mlp(tm)
    spec = _v5e_as_port_spec()
    for batch in (64, 512):
        for kw in (dict(), dict(packed=False, batch_level=False),
                   dict(fused=True), dict(fused=True, moments=False),
                   dict(bytes_per_el=4)):
            np.testing.assert_allclose(
                tp.modeled_latency(batch, spec=spec, **kw),
                jp.modeled_latency(batch, spec=j_lat.V5E, **kw),
                rtol=TOL_MODEL, err_msg=str(kw))
        for bpe in (2, 4):
            for kw in (dict(), dict(fused=True), dict(fused=True,
                                                      moments=True)):
                assert dataclasses.asdict(tp.traffic(batch, bpe, **kw)) == \
                    dataclasses.asdict(jp.traffic(batch, bpe, **kw))


def test_plan_hardware_on_h100():
    """The reference's Phase-3 assertions (tests/test_system.py) hold
    under the H100 spec, and the plan executes as the model does."""
    jm, tm = _mlp(*MLPS["flow"])
    hp = t_transform.plan_hardware(tm, batch=512)
    assert hp.modeled_speedup > 1.0
    assert hp.schedule.kind == "batch"
    assert hp.traffic.weight_loads == tm.n_masks == 4
    jhp = j_transform.plan_hardware(jm, batch=512)
    assert dataclasses.asdict(hp.traffic) == dataclasses.asdict(jhp.traffic)
    assert hp.modeled_latency_s == hp.plan.modeled_latency(512)
    assert hp.modeled_baseline_s == hp.plan.modeled_latency(
        512, packed=False, batch_level=False)
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(512, 11))
                         .astype(np.float32))
    np.testing.assert_allclose(
        t_plan.execute(hp.plan, x, device=CPU).numpy(),
        tm.apply_all_samples(tm.params, x).numpy(), rtol=TOL_PLAN,
        atol=TOL_PLAN)
    assert t_lat.H100.peak_flops == 989e12 and t_lat.H100.hbm_bw == 3.35e12
