"""The port's kernel modules: the plain versions against the JAX package
(its reference tier, and the Pallas kernels in interpret mode at tiny
sizes), the fused chain's descriptor and residency guard, and device
dispatch. The kernels themselves are held to these plain versions on the
card by tests/test_torch_cuda.py and ``chip_smoke.py``."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import masks as j_masks
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


@pytest.mark.parametrize("width,n_masks,b", [(24, 4, 10), (52, 8, 37)])
def test_masked_ffn_unpacked_entry_matches_jax(width, n_masks, b):
    """``masked_ffn_all_samples`` (a one-pair plan, packed by mask-zero
    skipping) and the oracle ``unpacked_masked_ffn_ref`` against the
    reference's two functions, on its own Masksembles masks."""
    masks = j_masks.generate_masks(j_masks.MaskSpec(width=width,
                                                    n_masks=n_masks,
                                                    scale=2.0))
    rng = np.random.default_rng(width)
    x, w1, b1, w2, b2 = (rng.normal(size=s).astype(np.float32) * 0.3
                         for s in ((b, 6), (6, width), (width,),
                                   (width, 5), (5,)))
    args = (x, w1, b1, w2, b2)
    want = j_mref.unpacked_masked_ffn_ref(*args, masks.astype(np.float32))
    _close(j_mops.masked_ffn_all_samples(*args, masks), want, TOL_FWD)
    targs = tuple(map(torch.from_numpy, args))
    tmasks = torch.from_numpy(masks.astype(np.float32))
    _close(t_mref.unpacked_masked_ffn_ref(*targs, tmasks), want, TOL_FWD)
    before = t_mops.masked_ffn.launches
    got = t_mops.masked_ffn_all_samples(*targs, masks, device="cpu")
    assert got.shape == (n_masks, b, 5)
    assert t_mops.masked_ffn.launches == before
    _close(got, want, TOL_FWD)
    _close(got, j_mops.masked_ffn_all_samples(*args, masks), TOL_FWD)


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
    # input/prefix tile: max(d_in 7, the prefix's 12 features); ping-pong
    # tiles: the widest step output, 12; both to a multiple of 8 rows
    assert (lay.pfx_rows, lay.buf_rows) == (16, 16)
    assert list(lay.desc[7:11]) == [16, 16, lay.slot_floats, 0]
    # staged row: the body dense steps' weights and biases, a weight as
    # stored with zero rows up to round8(d_in) ([round8(d_in)][d_out]
    # floats) and a bias as round4(d_out), each 16-byte aligned
    assert lay.slot_floats == 16 * 9 + 12 + 12 + 16 * 5 + 8 + 8 * 3
    steps = lay.desc[11:].reshape(-1, 16)
    assert list(steps[2, 10:13]) == [0, 144, 156]     # sw, sb, sbp
    assert list(steps[4, 10:12]) == [168, 248] and steps[5, 10] == 256
    fp = t_fops.pack(tspec, tuple(map(torch.from_numpy, params)))
    assert fp.flat.numel() == sum(p.size for p in params)
    with pytest.raises(ValueError, match="spec wants"):
        t_fops.pack(tspec, tuple(torch.zeros(1) for _ in params))
    # an int8 step: its weight in the int8 buffer, its scale in the bf16
    # one, 16 descriptor fields a step (the last two: int8 flag, scale
    # offset); an unknown weight dtype raises
    q = t_fref.FusedSpec((t_fref.FusedStep("dense", w_dtype="int8", d_in=3,
                                           d_out=2, shared_bias=True),),
                         1, 1, 1, 3, 2)
    assert t_fref.param_slots(q) == ((0, "w"), (0, "ws"), (0, "b"))
    qlay = t_fops._layout(q)
    assert qlay.shapes == ((3, 2), (1, 2), (2,))
    assert len(qlay.desc) == 11 + 16 and list(qlay.desc[-2:]) == [1, 0]
    # an int8 body (the clinical IVIM row): biases first in the slot, then
    # each int8 weight as stored at a 16-byte offset (sq, bytes); the
    # weights widen into the dequant buffer at sw
    ivim = _int8_port_spec(_to_port_spec(_ivim_spec(11, 1, keep=6)[0]))
    ilay = t_fops._layout(ivim)
    isteps = ilay.desc[11:].reshape(-1, 16)
    assert [list(r[10:15]) for r in isteps] == [
        [0, 0, 0, 80, 1], [96, 0, 8, 160, 1], [144, 0, 16, 208, 1]]
    assert (ilay.slot_floats, ilay.deq_floats) == (224 // 4, 16 * 6 + 8 * 6
                                                   + 8 * 1)
    with pytest.raises(ValueError, match="unknown weight dtype"):
        t_fref.FusedSpec((t_fref.FusedStep("dense", w_dtype="fp8", d_in=1,
                                           d_out=1),), 1, 1, 1, 1, 1)
    with pytest.raises(t_fref.FusedPlanUnsupported):
        t_fref.FusedSpec((t_fref.FusedStep("act", "relu"),), 1, 1, 1, 1, 1)


def _int8_port_spec(spec):
    return dataclasses.replace(spec, steps=tuple(
        dataclasses.replace(st, w_dtype="int8") if st.kind == "dense"
        else st for st in spec.steps))


def test_residency_guard():
    """The design's own shared-memory budget: mbarriers, one staged row
    slot, an int8 chain's dequant buffer, and three activation tiles
    [round8(rows)][T + 8] against 227 KB; the Welford state is in
    registers."""
    S = t_fref.FusedStep
    dense = _to_port_spec(_ivim_spec(104, 8, keep=52)[0])
    T = t_fops.moments_block(dense)
    assert T == t_fops.BLOCK_B_MOMENTS == 64
    slot = 104 * 52 + 52 + 56 * 52 + 52 + 56 * 1 + 4    # 8,484 floats
    tiles = (104 + 2 * 56) * (T + 8)
    bars = 8                                          # 32 bytes of mbarriers
    assert t_fops.check_residency(dense, T) == 4 * (bars + slot + tiles)
    assert t_fops.check_residency(dense, t_fops.BLOCK_B_SAMPLES) == \
        4 * (bars + slot + (104 + 2 * 56) * (t_fops.BLOCK_B_SAMPLES + 8))
    # a 128 -> 128 -> 1 row slot beside its three 128-row tiles still fits
    mid = t_fref.FusedSpec(
        (S("dense", "relu", per_sample=True, d_in=128, d_out=128),
         S("dense", "sigmoid", per_sample=True, d_in=128, d_out=1)), 2, 2,
        1, 128, 1)
    assert t_fops.check_residency(mid, T) == \
        4 * (8 + 128 * 128 + 128 * 1 + (128 + 2 * 128) * (T + 8))
    # a wide output shrinks the moments tile: T·d_out Welford registers
    assert t_fops.moments_block(t_fref.FusedSpec(
        (S("dense", None, per_sample=True, d_in=2, d_out=100),), 2, 2, 1, 2,
        100)) == 8
    wide = t_fref.FusedSpec(
        (S("dense", "relu", per_sample=True, d_in=240, d_out=240),), 2, 2,
        1, 240, 240)
    assert t_fops.smem_bytes(wide, 4) > t_fops.SMEM_LIMIT
    with pytest.raises(t_fref.FusedPlanUnsupported, match="shared memory"):
        t_fops.check_residency(wide, t_fops.moments_block(wide))
    too_wide = t_fref.FusedSpec(
        (S("dense", None, per_sample=True, d_in=2, d_out=300),), 2, 2, 1, 2,
        300)
    with pytest.raises(t_fref.FusedPlanUnsupported, match="outputs a voxel"):
        t_fops.moments_block(too_wide)


def _served_plan(name):
    """The plans the port serves fused: the dense IVIM plan at fp32 and
    int8, the clinical-width 1-mask plan, the design flow's MLP plan."""
    from repro_torch.core import plan as t_plan
    from repro_torch.core import transform as t_transform
    from repro_torch.ivim import model as t_ivim
    from repro_torch.ivim import physics as t_physics
    gen = torch.Generator().manual_seed(0)
    if name == "mlp_11_32_32_1":
        mlp = t_transform.convert(
            t_transform.MlpSpec((11, 32, 32, 1), (1, 2)), 4, 2.0, gen,
            device="cpu")
        return t_plan.compile_mlp(mlp)
    cfg = (t_ivim.IvimConfig(n_masks=1, scale=2.0) if name == "ivim_clinical"
           else t_ivim.IvimConfig(b_values=t_physics.DENSE_B_VALUES,
                                  n_masks=8, scale=2.0))
    plan = t_ivim.pack_for_serving(t_ivim.init(cfg, gen, device="cpu"))
    if name == "ivim_dense_int8":
        plan = plan.with_precision(t_plan.Precision("int8"))
    return plan


@pytest.mark.parametrize("name", ["ivim_dense", "ivim_dense_int8",
                                  "ivim_clinical", "mlp_11_32_32_1"])
def test_served_plans_pass_residency(name):
    """Every plan that ran fused before still does, at the new block sizes:
    moments at its block, samples at BLOCK_B_SAMPLES."""
    from repro_torch.core import plan as t_plan
    spec, _ = t_plan.lower_fused(_served_plan(name))
    T = t_fops.moments_block(spec)
    assert T == t_fops.BLOCK_B_MOMENTS
    assert t_fops.check_residency(spec, T) <= t_fops.SMEM_LIMIT
    assert t_fops.check_residency(spec, t_fops.BLOCK_B_SAMPLES) <= \
        t_fops.SMEM_LIMIT


@pytest.mark.parametrize("sample_major", [True, False])
def test_masked_ffn_orders_match_pallas_interpret(sample_major):
    """Both grid orders of the port's masked_ffn on CPU tensors (the plain
    version, no launch) against the reference's Pallas kernel in interpret
    mode in the same order, over three 8-voxel batch tiles."""
    args = _ffn_inputs(20, 11, 6, 6, 4, seed=5)
    want = j_mops.masked_ffn(*args, block_b=8, sample_major=sample_major,
                             interpret=True)
    before = t_mops.masked_ffn.launches
    got = t_mops.masked_ffn(*map(torch.from_numpy, args),
                            sample_major=sample_major)
    assert t_mops.masked_ffn.launches == before
    _close(got, want, TOL_FWD)


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
