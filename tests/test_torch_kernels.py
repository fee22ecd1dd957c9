"""The port's kernel modules: the plain versions against the JAX package
(its reference tier, and the Pallas kernels in interpret mode at tiny
sizes), the fused chain's descriptor and residency guard, and device
dispatch. The kernels themselves are held to these plain versions on the
card by tests/test_torch_cuda.py and ``chip_smoke.py``."""

import numpy as np
import pytest
import torch

from repro.kernels.fused_plan import ops as j_fops
from repro.kernels.fused_plan import ref as j_fref
from repro.kernels.masked_ffn import ops as j_mops
from repro.kernels.masked_ffn import ref as j_mref
from repro_torch.kernels.fused_plan import ops as t_fops
from repro_torch.kernels.fused_plan import ref as t_fref
from repro_torch.kernels.masked_ffn import ops as t_mops
from repro_torch.kernels.masked_ffn import ref as t_mref

TOL_FWD = 1e-5        # one forward pass, fp32, sums in another order
TOL_MOMENTS = 2e-4    # the reference's own fused-vs-per-op tolerance


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _ffn_inputs(b, d, k, d2, n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) * 0.5
            for s in ((b, d), (n, d, k), (n, k), (n, k, d2), (d2,))]


@pytest.mark.parametrize("shape", [(16, 11, 6, 6, 4), (37, 104, 52, 52, 8),
                                   (5, 3, 1, 2, 1)])
def test_masked_ffn_plain_matches_jax(shape):
    args = _ffn_inputs(*shape)
    want = j_mref.masked_ffn_ref(*args)
    got = t_mref.masked_ffn_ref(*map(torch.from_numpy, args))
    _close(got, want, TOL_FWD)
    # the wrapper on CPU tensors is the plain version, and launches nothing
    before = t_mops.masked_ffn.launches
    _close(t_mops.masked_ffn(*map(torch.from_numpy, args)), want, TOL_FWD)
    assert t_mops.masked_ffn.launches == before


def test_masked_ffn_plain_matches_pallas_interpret():
    """Ties the plain version to the Pallas kernel body itself (width 11,
    N=4, B=16), run through the reference's interpret mode."""
    args = _ffn_inputs(16, 11, 6, 6, 4, seed=1)
    want = j_mops.masked_ffn(*args, interpret=True)
    _close(t_mref.masked_ffn_ref(*map(torch.from_numpy, args)), want,
           TOL_FWD)


def _random_params(spec, seed):
    rng = np.random.default_rng(seed)
    params = []
    for i, slot in j_fref.param_slots(spec):
        st = spec.steps[i]
        shape = {"w": ((spec.n_rows,) if st.per_sample else ())
                 + (st.d_in, st.d_out),
                 "b": (st.d_out,), "bp": (spec.n_rows, st.d_out)}[slot]
        params.append(rng.normal(size=shape).astype(np.float32) * 0.5)
    return tuple(params)


def _ivim_spec(width, n_masks, keep=None):
    """The chain ``plan.lower_fused`` makes of a compiled IVIM plan: the
    packed pair's two per-row dense steps (the second with the fused relu)
    and the per-row sigmoid head, 4 groups x n_masks rows."""
    S = j_fref.FusedStep
    k = keep or max(1, width // 2)
    steps = (S("dense", "relu", per_sample=True, sample_bias=True,
               d_in=width, d_out=k),
             S("dense", "relu", per_sample=True, sample_bias=True,
               d_in=k, d_out=k),
             S("dense", "sigmoid", per_sample=True, sample_bias=True,
               d_in=k, d_out=1))
    spec = j_fref.FusedSpec(steps, 4 * n_masks, n_masks, 4, width, 1)
    return spec, _random_params(spec, width + n_masks)


def _to_port_spec(spec):
    steps = tuple(t_fref.FusedStep(
        s.kind, s.activation, s.per_sample, s.shared_bias, s.sample_bias,
        s.d_in, s.d_out) for s in spec.steps)
    return t_fref.FusedSpec(steps, spec.n_rows, spec.n_masks, spec.groups,
                            spec.d_in, spec.d_out)


def _mixed_spec(n_masks=3, groups=2):
    """Shared prefix (dense + tanh, shared bias), a bare gelu step, per-row
    dense with shared and per-row bias, a shared dense in the body."""
    S = j_fref.FusedStep
    steps = (S("dense", "tanh", shared_bias=True, d_in=7, d_out=12),
             S("act", "gelu"),
             S("dense", None, per_sample=True, shared_bias=True,
               sample_bias=True, d_in=12, d_out=9),
             S("act", "silu"),
             S("dense", "relu", shared_bias=True, d_in=9, d_out=5),
             S("dense", "sigmoid", per_sample=True, d_in=5, d_out=3))
    spec = j_fref.FusedSpec(steps, n_masks * groups, n_masks, groups, 7, 3)
    return spec, _random_params(spec, 2)


SPECS = {
    "ivim11_n4": lambda: _ivim_spec(11, 4, keep=6),
    "ivim104_n8": lambda: _ivim_spec(104, 8, keep=52),
    "mixed": _mixed_spec,
}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_fused_plain_matches_jax(name):
    spec, params = SPECS[name]()
    params = tuple(np.array(p) for p in params)
    x = np.random.default_rng(3).uniform(size=(13, spec.d_in)).astype(
        np.float32)
    tspec = _to_port_spec(spec)
    tparams = tuple(map(torch.from_numpy, params))
    tx = torch.from_numpy(x)
    _close(t_fref.fused_plan_ref(tspec, tx, tparams),
           j_fref.fused_plan_ref(spec, x, params), TOL_FWD)
    jm, js = j_fref.fused_moments_ref(spec, x, params)
    tm, ts = t_fref.fused_moments_ref(tspec, tx, tparams)
    _close(tm, jm, TOL_MOMENTS)
    _close(ts, js, TOL_MOMENTS)
    # the wrappers on CPU tensors are the plain versions
    fp = t_fops.pack(tspec, tparams)
    _close(t_fops.fused_samples(fp, tx), j_fref.fused_plan_ref(
        spec, x, params), TOL_FWD)
    _close(t_fops.fused_moments(fp, tx)[1], js, TOL_MOMENTS)


def test_fused_plain_matches_pallas_interpret():
    """The mixed spec through the reference's Pallas kernel in interpret
    mode, both modes, at a tiny size."""
    spec, params = _mixed_spec(n_masks=2, groups=2)
    x = np.random.default_rng(4).uniform(size=(6, 7)).astype(np.float32)
    tspec, tparams = _to_port_spec(spec), tuple(map(torch.from_numpy, params))
    tx = torch.from_numpy(x)
    _close(t_fref.fused_plan_ref(tspec, tx, tparams),
           j_fops.fused_plan(spec, x, params, interpret=True), TOL_FWD)
    jm, js = j_fops.fused_plan(spec, x, params, moments=True, interpret=True)
    tm, ts = t_fref.fused_moments_ref(tspec, tx, tparams)
    _close(tm, jm, TOL_MOMENTS)
    _close(ts, js, TOL_MOMENTS)


def test_fused_descriptor_layout():
    spec, params = _mixed_spec()
    tspec = _to_port_spec(spec)
    lay = t_fops._layout(tspec)
    assert lay.desc[1] == 2                  # prefix: the dense + gelu steps
    assert lay.desc[7] == 13                 # widest tile 12 -> odd stride
    # staged row: the two body dense steps' weights and biases
    assert lay.row_floats == 12 * 9 + 9 + 9 + 9 * 5 + 5 + 5 * 3
    fp = t_fops.pack(tspec, tuple(map(torch.from_numpy, params)))
    assert fp.flat.numel() == sum(p.size for p in params)
    with pytest.raises(ValueError, match="spec wants"):
        t_fops.pack(tspec, tuple(torch.zeros(1) for _ in params))
    # an int8 step: its weight in the int8 buffer, its scale in the bf16
    # one, 15 descriptor fields a step (the last two: int8 flag, scale
    # offset); an unknown weight dtype raises
    q = t_fref.FusedSpec((t_fref.FusedStep("dense", w_dtype="int8", d_in=3,
                                           d_out=2, shared_bias=True),),
                         1, 1, 1, 3, 2)
    assert t_fref.param_slots(q) == ((0, "w"), (0, "ws"), (0, "b"))
    qlay = t_fops._layout(q)
    assert qlay.shapes == ((3, 2), (1, 2), (2,))
    assert len(qlay.desc) == 9 + 15 and list(qlay.desc[-2:]) == [1, 0]
    with pytest.raises(ValueError, match="unknown weight dtype"):
        t_fref.FusedSpec((t_fref.FusedStep("dense", w_dtype="fp8", d_in=1,
                                           d_out=1),), 1, 1, 1, 1, 1)
    with pytest.raises(t_fref.FusedPlanUnsupported):
        t_fref.FusedSpec((t_fref.FusedStep("act", "relu"),), 1, 1, 1, 1, 1)


def test_residency_guard():
    """The design's own shared-memory budget: one row's staged parameters
    plus three activation tiles (and the Welford tiles) against 227 KB."""
    S = t_fref.FusedStep
    dense = _to_port_spec(_ivim_spec(104, 8, keep=52)[0])
    need = t_fops.check_residency(dense, t_fops.BLOCK_B_MOMENTS, True)
    row = 104 * 52 + 52 + 52 * 52 + 52 + 52 + 1       # 8,269 floats
    assert need == 4 * (row + 3 * 16 * 105 + 2 * 16 * 1)
    assert need <= t_fops.SMEM_LIMIT
    wide = t_fref.FusedSpec(
        (S("dense", "relu", per_sample=True, d_in=240, d_out=240),), 2, 2,
        1, 240, 240)
    assert t_fops.smem_bytes(wide, 16, True) > t_fops.SMEM_LIMIT
    with pytest.raises(t_fref.FusedPlanUnsupported, match="shared memory"):
        t_fops.check_residency(wide, t_fops.BLOCK_B_MOMENTS, True)


def test_bind_resolves_each_entry_once(monkeypatch):
    """``_build.bind`` sets a C entry's signature when it first resolves it
    and returns the same function object after that, its signature not set
    again (here on the C library's ``strlen``, which needs no card)."""
    import ctypes

    from repro_torch.kernels import _build
    loads = []

    def load(name):
        loads.append(name)
        return ctypes.CDLL(None)

    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(_build, "_BOUND", {})
    fn = _build.bind("c", "strlen", [ctypes.c_char_p], ctypes.c_size_t)
    sig = fn.argtypes
    assert fn(b"hopper") == 6
    again = _build.bind("c", "strlen", [ctypes.c_char_p], ctypes.c_size_t)
    assert again is fn and fn.argtypes is sig and loads == ["c"]
    assert fn.restype is ctypes.c_size_t
