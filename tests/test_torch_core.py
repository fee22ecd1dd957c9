"""Port parity of the core modules: masks and packing are exact (the same
units packed in the same order), scheduling and uncertainty math agree with
the JAX package on the same numpy inputs."""

import numpy as np
import pytest
import torch

from repro.core import masks as j_masks
from repro.core import masksembles as j_mse
from repro.core import packing as j_packing
from repro.core import scheduler as j_sched
from repro.core import uncertainty as j_unc
from repro_torch.core import masks as t_masks
from repro_torch.core import masksembles as t_mse
from repro_torch.core import packing as t_packing
from repro_torch.core import scheduler as t_sched
from repro_torch.core import uncertainty as t_unc


@pytest.mark.parametrize("scale", (1.0, 2.0))
@pytest.mark.parametrize("n_masks", (1, 4, 8))
@pytest.mark.parametrize("width", (11, 104))
def test_generate_masks_exact(width, n_masks, scale):
    for seed in (0, 1):
        want = j_masks.generate_masks(j_masks.MaskSpec(width, n_masks, scale,
                                                       seed))
        got = t_masks.generate_masks(t_masks.MaskSpec(width, n_masks, scale,
                                                      seed))
        assert got.dtype == want.dtype and np.array_equal(got, want)


def _masks(width=24, n=4, scale=2.0, seed=0):
    return j_masks.generate_masks(j_masks.MaskSpec(width, n, scale, seed))


def test_kept_indices_exact():
    for width, n in ((11, 4), (104, 8), (24, 1)):
        m = _masks(width, n)
        want = j_packing.kept_indices(m)
        assert np.array_equal(t_packing.kept_indices(m), want)
        assert np.array_equal(t_packing.kept_indices(torch.from_numpy(m)),
                              want)
    with pytest.raises(ValueError, match="non-uniform"):
        t_packing.kept_indices(np.array([[1, 0], [1, 1]], bool))


def test_packers_exact():
    rng = np.random.default_rng(0)
    idx_in = j_packing.kept_indices(_masks(24, 4, seed=0))
    idx_out = j_packing.kept_indices(_masks(24, 4, seed=1))
    w = rng.normal(size=(24, 24)).astype(np.float32)
    w3 = rng.normal(size=(3, 24, 7)).astype(np.float32)
    cases = [
        (j_packing.pack_out_dim(w, idx_out), t_packing.pack_out_dim(
            torch.from_numpy(w), idx_out)),
        (j_packing.pack_in_dim(w, idx_in), t_packing.pack_in_dim(
            torch.from_numpy(w), idx_in)),
        (j_packing.pack_pair_dims(w, idx_in, idx_out),
         t_packing.pack_pair_dims(torch.from_numpy(w), idx_in, idx_out)),
        (j_packing.gather_units(w3, idx_in, axis=1),
         t_packing.gather_units(torch.from_numpy(w3), idx_in, axis=1)),
        (j_packing.pack_out_dim(w[0], idx_out), t_packing.pack_out_dim(
            torch.from_numpy(w[0]), idx_out)),
    ]
    for want, got in cases:
        assert tuple(got.shape) == want.shape
        assert got.is_contiguous()          # the kernels take dense operands
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_mask_assignment_matches():
    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    for b, n in ((10, 4), (8, 8), (5, 1)):
        assert np.array_equal(
            t_mse.mask_ids_for_batch(b, n).numpy(),
            np.asarray(j_mse.mask_ids_for_batch(b, n)))
    xr_t, ids_t = t_mse.repeat_for_samples(torch.from_numpy(x), 3)
    xr_j, ids_j = j_mse.repeat_for_samples(x, 3)
    assert np.array_equal(xr_t.numpy(), np.asarray(xr_j))
    assert np.array_equal(ids_t.numpy(), np.asarray(ids_j))
    g = torch.Generator().manual_seed(0)
    p = t_mse.dense_init(g, 6, 3)
    assert p["w"].shape == (6, 3) and not p["b"].any()


@pytest.mark.parametrize("n,chunk", [(10, 3), (3, 10), (5, 1), (8, 8),
                                     (4097, 4096), (1, 1)])
def test_chunk_bounds_match(n, chunk):
    got = t_sched.chunk_bounds(n, chunk)
    assert got == j_sched.chunk_bounds(n, chunk)
    assert got[0][0] == 0 and got[-1][1] == n
    assert all(hi - lo == chunk for lo, hi in got[:-1])


def test_chunk_bounds_rejects_empty():
    for n, chunk in ((0, 4), (4, 0)):
        with pytest.raises(ValueError):
            t_sched.chunk_bounds(n, chunk)


def test_schedules_and_traffic_match():
    for kind in ("batch", "sampling"):
        js, ts = j_sched.Schedule(kind, 16), t_sched.Schedule(kind, 16)
        assert t_sched.weight_load_counts(ts, 100, 8) == \
            j_sched.weight_load_counts(js, 100, 8)
        want = j_sched.traffic_model(js, 100, 8, 11, 6, 6, 4)
        got = t_sched.traffic_model(ts, 100, 8, 11, 6, 6, 4)
        assert (got.weight_bytes, got.act_bytes, got.flops,
                got.weight_loads) == (want.weight_bytes, want.act_bytes,
                                      want.flops, want.weight_loads)
    with pytest.raises(ValueError):
        t_sched.Schedule("nope")
    with pytest.raises(ValueError):
        t_sched.SlotSchedule(0, 3)


def test_predictive_moments_match():
    rng = np.random.default_rng(0)
    s = rng.normal(size=(8, 33, 4)).astype(np.float32)
    s[:, :, 0] *= 1e-3              # small means: rel-unc near the eps floor
    jm, js = j_unc.predictive_moments(s)
    tm, ts = t_unc.predictive_moments(torch.from_numpy(s))
    np.testing.assert_allclose(tm.numpy(), jm, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(ts.numpy(), js, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(
        t_unc.relative_uncertainty(torch.from_numpy(s)).numpy(),
        j_unc.relative_uncertainty(s), rtol=1e-4)
    p, q = s[0], s[1]
    np.testing.assert_allclose(
        t_unc.rmse(torch.from_numpy(p), torch.from_numpy(q)).item(),
        float(j_unc.rmse(p, q)), rtol=1e-6)
    np.testing.assert_allclose(
        t_unc.rmse(torch.from_numpy(p), torch.from_numpy(q), axis=0).numpy(),
        j_unc.rmse(p, q, axis=0), rtol=1e-6)
    assert t_unc.REL_UNC_EPS == j_unc.REL_UNC_EPS


def test_check_requirements_match():
    rmse = {5.0: 0.3, 15.0: 0.2, 50.0: 0.25}
    unc = {5.0: 0.5, 15.0: 0.4, 50.0: 0.1}
    for req_kw in ({}, {"max_rel_uncertainty": 0.05}, {"tolerance": 0.5}):
        want = j_unc.check_requirements(
            j_unc.UncertaintyRequirements(**req_kw), rmse, unc)
        got = t_unc.check_requirements(
            t_unc.UncertaintyRequirements(**req_kw), rmse, unc)
        assert (got.satisfied, got.failures) == (want.satisfied,
                                                 want.failures)
