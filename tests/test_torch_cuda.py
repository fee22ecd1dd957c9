"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here takes the ``cuda`` fixture, which skips without a card: a
CUDA kernel has no CPU mode. On a machine with an H100 run them with

    python -m pytest -q tests/test_torch_cuda.py

This file imports no JAX (the card's machine has none); the CPU parity of
the plain versions against the JAX package is tests/test_torch_kernels.py.
Tolerances: 1e-4 for a kernel's forward values (fp32 sums in another order
than cuBLAS), 2e-4 for moments (the reference's fused-vs-per-op bar) and
for the int8 bodies (the reference's int8 bar: the dequantized weights are
exact, so only the order of the sums differs); the
decode kernel's bf16 k/v outputs within one bf16 ulp of the plain version's
plus 1e-5 of the tensor's largest value (fp32 values that differ by sums
taken in another order, each rounded to bf16). The moments kernel is held
to the reference's own kernel-vs-ref bar (tests/test_kernels.py: mean rtol
1e-5 / atol 1e-6, std rtol 1e-4 / atol 1e-5), bf16 to one bf16 ulp.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.core import masks as masks_lib
from repro_torch.core import plan as plan_lib
from repro_torch.ivim import model as ivim_model
from repro_torch.kernels import _build
from repro_torch.kernels.fused_decode import ops as dops
from repro_torch.models import layers, model as lm_model, transformer
from repro_torch.kernels.fused_plan import ops as fops
from repro_torch.kernels.fused_plan import ref as fref
from repro_torch.kernels.masked_ffn import ops as mops
from repro_torch.kernels.masked_ffn import ref as mref
from repro_torch.kernels.moments import ops as moops
from repro_torch.kernels.moments import ref as moref
from repro_torch.serving import engine, server

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402  (its tables and helpers; it imports no torch)

TOL_FWD = 1e-4
TOL_MOMENTS = 2e-4
TOL_INT8 = 2e-4


@pytest.fixture
def cuda():
    """The card, or a skip."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _rand(gen, *shape, scale=0.5):
    return torch.randn(*shape, generator=gen) * scale


@pytest.mark.parametrize("shape", [
    (4097, 11, 11, 11, 4),        # ragged batch, clinical width
    (4096, 104, 52, 52, 32),      # the dense IVIM pair
    (45, 150, 70, 70, 2),         # D > 128 and K, D2 > 64: the tiled walks
    (1, 3, 1, 2, 1)])
def test_masked_ffn_kernel_matches_plain(cuda, shape):
    b, d, k, d2, n = shape
    gen = torch.Generator().manual_seed(0)
    args = [_rand(gen, *s).to(cuda) for s in
            ((b, d), (n, d, k), (n, k), (n, k, d2), (d2,))]
    before = mops.masked_ffn.launches
    got = mops.masked_ffn(*args)
    assert mops.masked_ffn.launches == before + 1
    torch.testing.assert_close(got, mref.masked_ffn_ref(*args),
                               rtol=TOL_FWD, atol=TOL_FWD)


S = fref.FusedStep


def _ivim(width, n, k):
    return fref.FusedSpec(
        (S("dense", "relu", per_sample=True, sample_bias=True, d_in=width,
           d_out=k),
         S("dense", "relu", per_sample=True, sample_bias=True, d_in=k,
           d_out=k),
         S("dense", "sigmoid", per_sample=True, sample_bias=True, d_in=k,
           d_out=1)), 4 * n, n, 4, width, 1)


SPECS = {
    "ivim11_n4": _ivim(11, 4, 6),
    "ivim104_n8": _ivim(104, 8, 52),
    # shared prefix + bare activations + shared bias + a shared body step
    "mixed": fref.FusedSpec(
        (S("dense", "tanh", shared_bias=True, d_in=7, d_out=12),
         S("act", "gelu"),
         S("dense", None, per_sample=True, shared_bias=True,
           sample_bias=True, d_in=12, d_out=9),
         S("act", "silu"),
         S("dense", "relu", shared_bias=True, d_in=9, d_out=5),
         S("dense", "sigmoid", per_sample=True, d_in=5, d_out=3)),
        6, 3, 2, 7, 3),
    # nothing per row: every row equal, std 0
    "all_shared": fref.FusedSpec(
        (S("dense", "relu", shared_bias=True, d_in=5, d_out=4),), 3, 3, 1,
        5, 4),
}


def _params(spec, gen, device):
    out = []
    for i, slot in fref.param_slots(spec):
        st = spec.steps[i]
        shape = {"w": ((spec.n_rows,) if st.per_sample else ())
                 + (st.d_in, st.d_out),
                 "b": (st.d_out,), "bp": (spec.n_rows, st.d_out)}[slot]
        out.append(_rand(gen, *shape).to(device))
    return tuple(out)


@pytest.mark.parametrize("batch", (4097, 1))
@pytest.mark.parametrize("name", sorted(SPECS))
def test_fused_kernels_match_plain(cuda, name, batch):
    spec = SPECS[name]
    gen = torch.Generator().manual_seed(1)
    params = _params(spec, gen, cuda)
    x = torch.rand((batch, spec.d_in), generator=gen).to(cuda)
    fp = fops.pack(spec, params)
    before = (fops.fused_samples.launches, fops.fused_moments.launches)
    torch.testing.assert_close(fops.fused_samples(fp, x),
                               fref.fused_plan_ref(spec, x, params),
                               rtol=TOL_FWD, atol=TOL_FWD)
    for got, want in zip(fops.fused_moments(fp, x),
                         fref.fused_moments_ref(spec, x, params)):
        torch.testing.assert_close(got, want, rtol=TOL_MOMENTS,
                                   atol=TOL_MOMENTS)
    assert (fops.fused_samples.launches, fops.fused_moments.launches) == \
        (before[0] + 1, before[1] + 1)


def test_wrappers_refuse_bad_operands(cuda):
    gen = torch.Generator().manual_seed(2)
    args = [_rand(gen, *s).to(cuda) for s in
            ((8, 4), (2, 4, 3), (2, 3), (2, 3, 2), (2,))]
    with pytest.raises(TypeError, match="float32"):
        mops.masked_ffn(args[0].double(), *args[1:])
    with pytest.raises(ValueError, match="one CUDA device"):
        mops.masked_ffn(args[0], args[1].cpu(), *args[2:])
    with pytest.raises(ValueError, match="not contiguous"):
        mops.masked_ffn(args[0].t().contiguous().t(), *args[1:])
    with pytest.raises(ValueError, match="do not chain"):
        mops.masked_ffn(args[0][:, :3].contiguous(), *args[1:])
    spec = SPECS["mixed"]
    fp = fops.pack(spec, _params(spec, gen, cuda))
    with pytest.raises(ValueError, match="spec wants"):
        fops.fused_moments(fp, torch.rand(4, 6, device=cuda))


def _wide_plan(device):
    """A masked FFN whose one row of packed weights (921 KB) exceeds a
    block's shared memory: the fused kernels refuse it, the per-op kernel
    walks its K and D in chunks."""
    gen = torch.Generator().manual_seed(3)
    masks = masks_lib.generate_masks(masks_lib.MaskSpec(480, 2, 1.0))
    return plan_lib.compile_masked_ffn(
        _rand(gen, 240, 480, scale=0.1).to(device),
        _rand(gen, 480).to(device), _rand(gen, 480, 240, scale=0.1).to(device),
        _rand(gen, 240).to(device), masks)


def test_residency_guard_falls_back_per_op(cuda):
    plan = _wide_plan(cuda)
    x = torch.rand(300, 240, device=cuda)
    launches = fops.fused_moments.launches
    with pytest.raises(fops.FusedPlanUnsupported, match="shared memory"):
        plan_lib.execute_fused(plan, x, moments=True, device=cuda)
    assert fops.fused_moments.launches == launches
    calls = engine.fallback_counts["call"]
    runner = engine.plan_chunk_runner(plan, device=cuda)
    got = runner(x)
    assert engine.fallback_counts["call"] == calls + 1
    want = engine.plan_chunk_runner(plan, fused=False, device=cuda)(x)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    samples = plan_lib.execute(plan, x.cpu(), device="cpu")
    torch.testing.assert_close(want[0].cpu(), samples.mean(0),
                               rtol=TOL_MOMENTS, atol=TOL_MOMENTS)


def test_volume_on_card_matches_unpacked(cuda):
    """The main path at a small size: fused and per-op legs against the
    unpacked model, one launch per chunk each."""
    cfg = ivim_model.IvimConfig(n_masks=4)
    model = ivim_model.init(cfg, torch.Generator().manual_seed(4),
                            device=cuda)
    plan = ivim_model.pack_for_serving(model)
    volume = torch.rand((5, 7, 3, cfg.width), device=cuda) + 0.2
    want = ivim_model.predict(model, volume.reshape(-1, cfg.width))
    for fused, counter in ((True, fops.fused_moments),
                           (False, mops.masked_ffn)):
        before = counter.launches
        mean, std = engine.predict_volume(plan, volume, chunk=16,
                                          fused=fused, device=cuda)
        assert counter.launches == before + int(np.ceil(105 / 16))
        for g, w in zip((mean, std), want):
            torch.testing.assert_close(g.reshape(-1, 4), w,
                                       rtol=TOL_MOMENTS, atol=TOL_MOMENTS)


# ---------------------------------------------------------------------------
# the fused decode step
# ---------------------------------------------------------------------------


def _within_bf16_ulp(got: torch.Tensor, want: torch.Tensor) -> None:
    """One bf16 ulp of the plain value, plus fp32 noise at the tensor's
    scale (1e-5 x max |want|): the two fp32 values round to bf16 apart, and
    near zero the noise of sums taken in another order exceeds an ulp."""
    got, want = got.float(), want.float()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1e-30)))
                     - 7)
    err = (got - want).abs()
    assert bool((err <= ulp + 1e-5 * want.abs().max()).all()), \
        float(err.max())


def _decode_inputs(cfg, device, *, b=3, plen=5, max_seq=9, expand=True,
                   pack=False, kv_bf16=False, inactive=False, active=None,
                   seed=0):
    """One pool decode step's kernel operands: a prefilled mask-major pool
    of b requests (n * b rows) at position ``plen``; with ``active`` only
    the first ``active`` slots decode and the rest ride at pos -1, as the
    server's inactive slots do."""
    params = transformer.init(cfg, torch.Generator(device).manual_seed(seed),
                              device=device)
    if pack:
        params = transformer.pack_ffn_params(cfg, params)
        cfg = dataclasses.replace(cfg, packed_ffn_serving=True)
    if kv_bf16:
        cfg = dataclasses.replace(cfg, kv_dtype="bfloat16")
    n = cfg.mask_samples if expand else 1
    rows = n * b
    gen = torch.Generator().manual_seed(seed + 1)
    toks = torch.randint(0, cfg.vocab_size, (rows, plen), generator=gen)
    toks = toks.to(device)
    ids = torch.arange(n, device=device).repeat_interleave(b) \
        if expand else None
    _, caches = transformer.prefill(cfg, params, {"tokens": toks},
                                    max_seq=max_seq, mask_ids=ids)
    spec = plan_lib.lower_fused_decode(cfg, expand_masks=expand)
    flat = plan_lib._decode_flat_params(spec, cfg, params, rows, expand)
    fc = plan_lib._decode_flat_caches(cfg, caches)
    pos = torch.full((rows,), plen, dtype=torch.int32, device=device)
    if inactive:
        pos[1] = -1
    if active is not None:                 # row r belongs to slot r % b
        pos[torch.arange(rows, device=device) % b >= active] = -1
    rot = next(s.rot_dim for s in spec.steps if s.kind == "attn")
    x = layers.embed_tokens(params["embed"], toks[:, -1])
    cos, sin = layers.rope_cos_sin(pos, rot, cfg.rope_theta)
    return spec, (x, flat, fc, pos, cos, sin)


_SMOKE = registry.smoke_config
DECODE_CASES = {
    "masked": (_SMOKE("qwen2-1.5b", n_layers=2), {}),
    "packed": (_SMOKE("qwen2-1.5b", n_layers=2), {"pack": True}),
    "n1": (_SMOKE("qwen2-1.5b", n_layers=2), {"expand": False, "b": 5}),
    "layernorm_gelu_mlp": (_SMOKE("granite-20b", n_layers=2), {}),
    "partial_rotary": (_SMOKE("stablelm-12b", n_layers=2), {}),
    "window": (_SMOKE("qwen2-1.5b", local_window=4,
                      segments_override=((("local_attn",), 2),)),
               {"plen": 6, "max_seq": 10}),
    "ragged": (_SMOKE("qwen2-1.5b", n_layers=1, d_model=40, head_dim=10,
                      d_ff=72, vocab_size=100), {"plen": 6, "max_seq": 7}),
    "inactive_row": (_SMOKE("qwen2-1.5b", n_layers=2), {"inactive": True}),
    "kv_bf16": (_SMOKE("qwen2-1.5b", n_layers=2), {"kv_bf16": True}),
    "long_cache": (_SMOKE("qwen2-1.5b", n_layers=1),
                   {"b": 2, "plen": 280, "max_seq": 300}),
    # qwen2-1.5b's GQA group (12 heads on 2 KV heads) at smoke depth, at
    # its head width and at MAX_HEAD_DIM
    "gqa6_dh128": (_SMOKE("qwen2-1.5b", n_layers=2, n_heads=12,
                          n_kv_heads=2, head_dim=128), {}),
    "gqa6_dh256": (_SMOKE("qwen2-1.5b", n_layers=2, n_heads=12,
                          n_kv_heads=2, head_dim=dops.MAX_HEAD_DIM), {}),
    # a group whose attention state outgrows one task (48 heads on one KV
    # head at dh 256: two head chunks a row), and packed FFN jobs past the
    # kernel's job table (20 masks: 40 gate/up jobs)
    "gqa48_dh256": (_SMOKE("qwen2-1.5b", n_layers=1, n_heads=48,
                           n_kv_heads=1, head_dim=dops.MAX_HEAD_DIM),
                    {"b": 1}),
    "packed_20_masks": (_SMOKE("qwen2-1.5b", n_layers=1, mask_samples=20),
                        {"pack": True, "b": 1}),
    # an odd vocabulary: LM head rows 2-byte aligned in bf16 (no tensor map:
    # copied by the threads), as qwen2-1.5b's packed FFN rows (4,779 kept
    # units) are
    "odd_vocab": (_SMOKE("qwen2-1.5b", n_layers=1, vocab_size=101), {}),
    # the server's pool: 8 slots (32 rows), 1, 3 or all 8 of them active
    **{f"pool_{k}_of_8": (_SMOKE("qwen2-1.5b", n_layers=2),
                          {"b": 8, "active": k, "max_seq": 12})
       for k in (1, 3, 8)},
}


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("name", sorted(DECODE_CASES))
def test_fused_decode_kernel_matches_plain(cuda, name, dtype):
    cfg, kw = DECODE_CASES[name]
    cfg = dataclasses.replace(cfg, dtype=getattr(torch, dtype))
    spec, args = _decode_inputs(cfg, cuda, **kw)
    before = dops.fused_decode.launches
    got = dops.fused_decode(spec, *args)
    assert dops.fused_decode.launches == before + 1
    stages = dops.stage_ms(spec, args[0].shape[0], cuda)
    assert set(stages) == set(dops.stage_names(spec))
    assert all(t >= 0 for t in stages.values())
    want = dops.fused_decode_ref(spec, *args)
    for g, w in zip(got[:2], want[:2]):
        torch.testing.assert_close(g, w, rtol=TOL_FWD, atol=TOL_FWD)
    for g, w in zip(got[2:], want[2:]):
        assert g.dtype == args[0].dtype
        if g.dtype == torch.bfloat16:
            _within_bf16_ulp(g, w)
        else:
            torch.testing.assert_close(g, w, rtol=TOL_FWD, atol=TOL_FWD)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_fused_decode_kernel_repeats(cuda, dtype):
    """Two launches on the same operands agree within TOL_FWD: the split
    sums meet in atomics, in another order each launch."""
    cfg, kw = DECODE_CASES["gqa6_dh128"]
    cfg = dataclasses.replace(cfg, dtype=getattr(torch, dtype))
    spec, args = _decode_inputs(cfg, cuda, **kw)
    first = [t.clone() for t in dops.fused_decode(spec, *args)]
    again = dops.fused_decode(spec, *args)
    for g, a in zip(first[:2], again[:2]):
        torch.testing.assert_close(a, g, rtol=TOL_FWD, atol=TOL_FWD)
    for g, a in zip(first[2:], again[2:]):
        if g.dtype == torch.bfloat16:
            _within_bf16_ulp(a, g)
        else:
            torch.testing.assert_close(a, g, rtol=TOL_FWD, atol=TOL_FWD)


def test_serve_uncertain_on_card_fused_matches_per_op(cuda):
    """The LM path at smoke size: one fused launch per decode step, and the
    fused leg agrees with the per-op leg (tokens equal, rel-unc within the
    reference's posterior tolerance)."""
    cfg = _SMOKE("qwen2-1.5b", n_layers=2)
    model = lm_model.build_model(cfg)
    params = model.init(torch.Generator(cuda).manual_seed(0), device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (3, 6),
                         generator=torch.Generator().manual_seed(1))
    outs = {}
    for fused in (None, False):
        before = dops.fused_decode.launches
        outs[fused] = engine.serve_uncertain(
            model, params, toks, engine.ServeConfig(max_new_tokens=5,
                                                    fused=fused),
            device=cuda)
        assert dops.fused_decode.launches - before == \
            (5 if fused is None else 0)
    assert server.step_fns(model, device=cuda).fused_live()
    torch.testing.assert_close(outs[None][0], outs[False][0], rtol=0, atol=0)
    torch.testing.assert_close(outs[None][1], outs[False][1], rtol=1e-4,
                               atol=1e-5)


def test_fused_decode_refuses_bad_operands(cuda):
    cfg, kw = DECODE_CASES["masked"]
    spec, (x, flat, fc, pos, cos, sin) = _decode_inputs(cfg, cuda, **kw)
    with pytest.raises(ValueError, match="pos must be int32"):
        dops.fused_decode(spec, x, flat, fc, pos.long(), cos, sin)
    with pytest.raises(ValueError, match="cache must be"):
        dops.fused_decode(spec, x, flat, (fc[0].cpu(),) + fc[1:], pos, cos,
                          sin)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        dops.fused_decode(spec, x.double(), flat, fc, pos, cos, sin)


# ---------------------------------------------------------------------------
# the int8 bodies (Precision("int8"))
# ---------------------------------------------------------------------------


def test_int8_quantizers_on_card_match_cpu(cuda):
    """The serving quantizers give the same int8 values and scales on the
    card as on the CPU (and so as the reference's, tests/
    test_torch_quantized.py): the scale is a true division there too."""
    gen = torch.Generator().manual_seed(6)
    w = _rand(gen, 32, 104, 52) * torch.rand(32, 1, 52, generator=gen) * 9
    kv = _rand(gen, 32, 2, 160, 128, scale=3.0)
    for fn, x in ((plan_lib._quantize_weight, w), (layers.quantize_kv, kv)):
        for got, want in zip(fn(x.to(cuda)), fn(x)):
            assert got.dtype == want.dtype
            assert torch.equal(got.cpu(), want), fn.__name__


def _int8_pair(gen, b, d, k, d2, n, device):
    """masked_ffn's int8 operands: the serving quantizer's int8 weights and
    bf16 scales, bf16 biases."""
    x = torch.rand((b, d), generator=gen)
    w1, w2 = _rand(gen, n, d, k), _rand(gen, n, k, d2)
    q1, s1 = plan_lib._quantize_weight(w1)
    q2, s2 = plan_lib._quantize_weight(w2)
    b1 = plan_lib._low_bias(_rand(gen, n, k, scale=0.1))
    b2 = plan_lib._low_bias(_rand(gen, d2, scale=0.1))
    return tuple(t.to(device) for t in (x, q1, b1, q2, b2, s1, s2))


@pytest.mark.parametrize("shape", [
    (4097, 11, 11, 11, 1),        # ragged batch, clinical width, one mask
    (4096, 104, 52, 52, 32),      # the dense IVIM pair
    (45, 150, 70, 70, 2),         # D > 128 and K, D2 > 64: the tiled walks
    (1, 3, 1, 2, 1)])
def test_masked_ffn_int8_kernel_matches_plain(cuda, shape):
    args = _int8_pair(torch.Generator().manual_seed(0), *shape, cuda)
    before = (mops.masked_ffn.launches, mops.masked_ffn.int8_launches)
    got = mops.masked_ffn(*args)
    assert (mops.masked_ffn.launches, mops.masked_ffn.int8_launches) == \
        (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(got, mref.masked_ffn_ref(*args),
                               rtol=TOL_INT8, atol=TOL_INT8)


def _int8_spec(spec):
    return dataclasses.replace(spec, steps=tuple(
        dataclasses.replace(st, w_dtype="int8") if st.kind == "dense"
        else st for st in spec.steps))


def _int8_params(spec, gen, device):
    """An int8 spec's operands: fp32 draws through the serving quantizer."""
    out = []
    for i, slot in fref.param_slots(spec):
        st = spec.steps[i]
        lead = (spec.n_rows,) if st.per_sample else ()
        if slot == "ws":
            continue
        shape = {"w": lead + (st.d_in, st.d_out), "b": (st.d_out,),
                 "bp": (spec.n_rows, st.d_out)}[slot]
        if slot == "w":
            out += plan_lib._quantize_weight(_rand(gen, *shape))
        else:
            out.append(plan_lib._low_bias(_rand(gen, *shape)))
    return tuple(t.to(device) for t in out)


INT8_SPECS = dict(SPECS, ivim11_n1=_ivim(11, 1, 6))


@pytest.mark.parametrize("batch", (4097, 1))
@pytest.mark.parametrize("name", sorted(INT8_SPECS))
def test_fused_int8_kernels_match_plain(cuda, name, batch):
    spec = _int8_spec(INT8_SPECS[name])
    gen = torch.Generator().manual_seed(1)
    params = _int8_params(spec, gen, cuda)
    x = torch.rand((batch, spec.d_in), generator=gen).to(cuda)
    fp = fops.pack(spec, params)
    before = (fops.fused_samples.int8_launches,
              fops.fused_moments.int8_launches)
    torch.testing.assert_close(fops.fused_samples(fp, x),
                               fref.fused_plan_ref(spec, x, params),
                               rtol=TOL_INT8, atol=TOL_INT8)
    for got, want in zip(fops.fused_moments(fp, x),
                         fref.fused_moments_ref(spec, x, params)):
        torch.testing.assert_close(got, want, rtol=TOL_INT8, atol=TOL_INT8)
    assert (fops.fused_samples.int8_launches,
            fops.fused_moments.int8_launches) == \
        (before[0] + 1, before[1] + 1)


class _Recorder:
    """A C entry of a kernel library that records its arguments, then
    calls the real entry."""

    def __init__(self, fn, calls):
        object.__setattr__(self, "_fn", fn)
        object.__setattr__(self, "_calls", calls)

    def __setattr__(self, name, value):        # argtypes / restype
        setattr(self._fn, name, value)

    def __call__(self, *args):
        self._calls.append(args)
        return self._fn(*args)


def test_int8_launches_receive_int8_operands(cuda, monkeypatch):
    """The int8 entries get the int8 weights' and bf16 scales' own storage:
    no wrapper widens an int8 operand (the fp32 buffer of a fused int8
    chain holds its biases only)."""
    calls: list = []
    real_bind = _build.bind

    def bind(name, entry, argtypes):
        return _Recorder(real_bind(name, entry, argtypes), calls)

    monkeypatch.setattr(_build, "bind", bind)
    x, q1, b1, q2, b2, s1, s2 = _int8_pair(torch.Generator().manual_seed(2),
                                           64, 104, 52, 52, 4, cuda)
    mops.masked_ffn(x, q1, b1, q2, b2, s1, s2)
    ptrs = calls.pop()
    assert ptrs[1:7] == tuple(t.data_ptr() for t in (q1, s1, b1, q2, s2, b2))
    assert (q1.dtype, s1.dtype, b1.dtype) == \
        (torch.int8, torch.bfloat16, torch.bfloat16)
    spec = _int8_spec(SPECS["ivim104_n8"])
    params = _int8_params(spec, torch.Generator().manual_seed(3), cuda)
    fp = fops.pack(spec, params)
    xf = torch.rand((64, spec.d_in), device=cuda)
    fops.fused_moments(fp, xf)
    fops.fused_samples(fp, xf)
    slots = fref.param_slots(spec)
    for args in calls:
        assert args[3:6] == (fp.flat.data_ptr(), fp.qflat.data_ptr(),
                             fp.sflat.data_ptr())
    assert fp.qflat.dtype == torch.int8 and fp.sflat.dtype == torch.bfloat16
    assert fp.qflat.numel() == sum(p.numel() for (_, k), p in
                                   zip(slots, params) if k == "w")
    assert fp.flat.numel() == sum(p.numel() for (_, k), p in
                                  zip(slots, params) if k in ("b", "bp"))


def test_int8_launch_errors_raise(cuda):
    """A launch the kernel refuses (a sample axis past the grid's 65,535
    limit) raises, and is not counted."""
    args = _int8_pair(torch.Generator().manual_seed(4), 4, 2, 1, 1, 65536,
                      cuda)
    before = (mops.masked_ffn.launches, mops.masked_ffn.int8_launches)
    with pytest.raises(RuntimeError, match="launch failed"):
        mops.masked_ffn(*args)
    assert (mops.masked_ffn.launches, mops.masked_ffn.int8_launches) == before
    spec = _int8_spec(fref.FusedSpec(
        (S("dense", "relu", per_sample=True, d_in=2, d_out=1),), 65536,
        65536, 1, 2, 1))
    fp = fops.pack(spec, _int8_params(spec, torch.Generator().manual_seed(5),
                                      cuda))
    before = fops.fused_samples.int8_launches
    with pytest.raises(RuntimeError, match="launch failed"):
        fops.fused_samples(fp, torch.rand((4, 2), device=cuda))
    assert fops.fused_samples.int8_launches == before
    with pytest.raises(TypeError, match="bfloat16"):
        mops.masked_ffn(args[0], args[1], args[2].float(), *args[3:])


def _ffn_args(quant, shape, seed, device):
    if quant:
        return _int8_pair(torch.Generator().manual_seed(seed), *shape, device)
    b, d, k, d2, n = shape
    gen = torch.Generator().manual_seed(seed)
    return tuple(_rand(gen, *s).to(device) for s in
                 ((b, d), (n, d, k), (n, k), (n, k, d2), (d2,)))


@pytest.mark.parametrize("quant", (False, True))
def test_masked_ffn_orders_bit_equal(cuda, quant):
    """The batch-level and sampling-level grid orders run one block body:
    bit-equal at the dense IVIM pair, each within its bar of the plain
    version."""
    args = _ffn_args(quant, (4096, 104, 52, 52, 32), 7, cuda)
    before = (mops.masked_ffn.launches, mops.masked_ffn.int8_launches)
    batch_level = mops.masked_ffn(*args)
    sampling_level = mops.masked_ffn(*args, sample_major=False)
    assert (mops.masked_ffn.launches, mops.masked_ffn.int8_launches) == \
        (before[0] + 2, before[1] + 2 * quant)
    assert torch.equal(batch_level, sampling_level)
    tol = TOL_INT8 if quant else TOL_FWD
    torch.testing.assert_close(batch_level, mref.masked_ffn_ref(*args),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("sample_major", (True, False))
@pytest.mark.parametrize("quant", (False, True))
@pytest.mark.parametrize("shape", [
    (100, 13, 7, 5, 3),           # B % T != 0; K and D2 not multiples of 4
    (129, 104, 52, 1, 2),         # one output column; B just past 2 tiles
    (63, 11, 6, 6, 4),            # B < T at the clinical width (int8 rows
    #                               at offsets that are not 4-aligned)
    (300, 130, 66, 67, 2)])       # D, K and D2 one past their chunks
def test_masked_ffn_tile_edges(cuda, shape, quant, sample_major):
    args = _ffn_args(quant, shape, 8, cuda)
    before = (mops.masked_ffn.launches, mops.masked_ffn.int8_launches)
    got = mops.masked_ffn(*args, sample_major=sample_major)
    assert (mops.masked_ffn.launches, mops.masked_ffn.int8_launches) == \
        (before[0] + 1, before[1] + quant)
    tol = TOL_INT8 if quant else TOL_FWD
    torch.testing.assert_close(got, mref.masked_ffn_ref(*args), rtol=tol,
                               atol=tol)


EDGE_SPECS = {
    # widths that are not multiples of 4 and a 2-column (split-K) head
    "ragged_widths": fref.FusedSpec(
        (S("dense", "relu", per_sample=True, sample_bias=True, d_in=13,
           d_out=7),
         S("dense", "tanh", per_sample=True, shared_bias=True, d_in=7,
           d_out=5),
         S("dense", "sigmoid", per_sample=True, d_in=5, d_out=2)),
        9, 3, 3, 13, 2),
    # d_out 100: an 8-voxel moments tile (2 voxels a thread)
    "wide_out": fref.FusedSpec(
        (S("dense", "relu", per_sample=True, sample_bias=True, d_in=6,
           d_out=100),), 2, 2, 1, 6, 100),
    # a 66 KB row slot beside three 128-row tiles: one block an SM
    "wide_rows": fref.FusedSpec(
        (S("dense", "relu", per_sample=True, d_in=128, d_out=128),
         S("dense", "sigmoid", per_sample=True, sample_bias=True, d_in=128,
           d_out=1)), 3, 3, 1, 128, 1),
}


@pytest.mark.parametrize("quant", (False, True))
@pytest.mark.parametrize("batch", (100, 129))
@pytest.mark.parametrize("name", sorted(EDGE_SPECS))
def test_fused_kernels_tile_edges(cuda, name, batch, quant):
    spec = _int8_spec(EDGE_SPECS[name]) if quant else EDGE_SPECS[name]
    gen = torch.Generator().manual_seed(9)
    params = (_int8_params if quant else _params)(spec, gen, cuda)
    x = torch.rand((batch, spec.d_in), generator=gen).to(cuda)
    fp = fops.pack(spec, params)
    before = (fops.fused_samples.launches, fops.fused_moments.launches,
              fops.fused_samples.int8_launches,
              fops.fused_moments.int8_launches)
    tol = TOL_INT8 if quant else TOL_FWD
    torch.testing.assert_close(fops.fused_samples(fp, x),
                               fref.fused_plan_ref(spec, x, params),
                               rtol=tol, atol=tol)
    for got, want in zip(fops.fused_moments(fp, x),
                         fref.fused_moments_ref(spec, x, params)):
        tol = TOL_INT8 if quant else TOL_MOMENTS
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    assert (fops.fused_samples.launches, fops.fused_moments.launches,
            fops.fused_samples.int8_launches,
            fops.fused_moments.int8_launches) == \
        (before[0] + 1, before[1] + 1, before[2] + quant, before[3] + quant)


def test_int8_volume_on_card(cuda):
    """The int8 main path at a small size: fused (one int8 moments launch
    per chunk) and per-op (one int8 masked_ffn launch per chunk) agree
    within 2e-4, and stay within the reference's 2e-2 of fp32."""
    cfg = ivim_model.IvimConfig(n_masks=4)
    model = ivim_model.init(cfg, torch.Generator().manual_seed(4),
                            device=cuda)
    plan = ivim_model.pack_for_serving(model)
    q = plan.with_precision(plan_lib.Precision("int8"))
    volume = torch.rand((5, 7, 3, cfg.width), device=cuda) + 0.2
    chunks = int(np.ceil(105 / 16))
    outs = {}
    for fused, counter in ((True, fops.fused_moments),
                           (False, mops.masked_ffn)):
        before = counter.int8_launches
        outs[fused] = engine.predict_volume(q, volume, chunk=16, fused=fused,
                                            device=cuda)
        assert counter.int8_launches == before + chunks
    for g, w in zip(outs[True], outs[False]):
        torch.testing.assert_close(g, w, rtol=TOL_INT8, atol=TOL_INT8)
    want = engine.predict_volume(plan, volume, chunk=16, device=cuda)
    for g, w in zip(outs[True], want):
        torch.testing.assert_close(g, w, rtol=0, atol=2e-2)


# ---------------------------------------------------------------------------
# the hybrid path's kernels: rglru_scan and flash_attention
# ---------------------------------------------------------------------------

# rglru_scan: fp32, a sequential carry against the plain version's odd/even
# tree of the same products and sums (|a| < 1, so rounding does not grow)
TOL_SCAN = 1e-5
# flash_attention in fp32: sums in another order, the online rescaling
TOL_FLASH_F32 = 1e-5
# ... in bf16: one bf16 ulp of the plain value plus 2^-8 max|v| (p rounded
# to bf16 before the normalisation in the kernel, after it in the plain
# version: the two fp32 sums differ by at most 2^-8 sum_j p_j |v_j|)
FLASH_BF16_V_SHARE = 2.0 ** -8


def _gates(shape, device, seed=0):
    gen = torch.Generator().manual_seed(seed)
    a = 0.85 + 0.149 * torch.rand(shape, generator=gen)
    b = torch.randn(shape, generator=gen) * torch.sqrt(1 - a * a)
    return a.to(device), b.to(device)


@pytest.mark.parametrize("shape", [
    (32, 128, 2560),      # the served shape: 8 requests x 4 masks
    (3, 37, 11),          # ragged B, S and W
    (2, 1, 5),            # one step
    (1, 4099, 130)])      # long S past the unrolled loop, ragged tail
def test_rglru_scan_kernel_matches_plain(cuda, shape):
    from repro_torch.kernels.rglru_scan import ops as sops
    from repro_torch.kernels.rglru_scan import ref as sref
    a, b = _gates(shape, cuda, seed=sum(shape))
    before = sops.rglru_scan.launches
    got = sops.rglru_scan(a, b)
    assert sops.rglru_scan.launches == before + 1
    torch.testing.assert_close(got, sref.rglru_scan_ref(a, b),
                               rtol=TOL_SCAN, atol=TOL_SCAN)


def test_rglru_scan_refuses_bad_operands(cuda):
    from repro_torch.kernels.rglru_scan import ops as sops
    a, b = _gates((2, 8, 6), cuda)
    before = sops.rglru_scan.launches
    with pytest.raises(TypeError, match="float32"):
        sops.rglru_scan(a.bfloat16(), b.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        sops.rglru_scan(a.transpose(1, 2), b.transpose(1, 2))
    with pytest.raises(ValueError, match=r"\[B, S, W\]"):
        sops.rglru_scan(a[0], b[0])
    with pytest.raises(ValueError, match=r"\[B, S, W\]"):
        sops.rglru_scan(a, b[:, :4].contiguous())
    with pytest.raises(ValueError, match="CUDA device"):
        sops.rglru_scan(a, b.cpu())
    assert sops.rglru_scan.launches == before


def _qkv(b, h, hkv, s, dh, dtype, device, seed=0, skv=None):
    gen = torch.Generator().manual_seed(seed)
    return tuple(torch.randn((b, n, sl, dh), generator=gen).to(device, dtype)
                 for n, sl in ((h, s), (hkv, skv or s), (hkv, skv or s)))


def _flash_close(got, want, v):
    assert got.dtype == want.dtype
    err = (got.float() - want.float()).abs()
    if got.dtype == torch.bfloat16:
        ulp = (want.float().abs().clamp_min(1e-30).log2().floor() - 7).exp2()
        assert bool((err <= ulp + FLASH_BF16_V_SHARE
                     * v.float().abs().max()).all()), float(err.max())
    else:
        torch.testing.assert_close(got, want, rtol=TOL_FLASH_F32,
                                   atol=TOL_FLASH_F32)


@pytest.mark.parametrize("dh", (16, 30, 64, 65, 80, 128, 129, 256, 257))
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("causal", (True, False))
def test_flash_attention_kernel_matches_plain(cuda, dh, dtype, causal):
    """Ragged S (129: a third q tile and key tile of one row), GQA 4/2;
    dh 30 rows are no whole number of 16-byte words (element-wise staging)
    nor of float4s (zero-padded head columns); 64/65, 128/129 and 256/257
    sit on both sides of each head-width bucket (257: the wide arm). fp32
    launches are counted apart (``launches_f32``)."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention import ref as far
    q, k, v = _qkv(2, 4, 2, 129, dh, getattr(torch, dtype), cuda, seed=dh)
    before = fa.flash_attention.launches
    before_f32 = fa.flash_attention.launches_f32
    got = fa.flash_attention(q, k, v, causal=causal)
    assert fa.flash_attention.launches == before + 1
    assert fa.flash_attention.launches_f32 == before_f32 + (
        dtype == "float32")
    _flash_close(got, far.flash_attention_ref(q, k, v, causal=causal), v)


@pytest.mark.parametrize("case", [
    (32, 10, 1, 128, 256, True),      # recurrentgemma-2b prefill, MQA
    (32, 12, 2, 128, 128, True),      # qwen2-1.5b prefill
    (2, 8, 1, 1100, 64, True),        # past the plain version's 1024 chunk
    (3, 4, 4, 1, 32, True),           # one position
    (2, 4, 1, 70, 128, False),        # full attention, and Skv != Sq
    (2, 4, 1, 191, 256, True),        # dh 256, Sq = 64 k - 1: ragged q tile,
    (1, 2, 2, 257, 256, True)])       # ... and 64 k + 1: a one-row q tile
def test_flash_attention_kernel_shapes(cuda, case):
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention import ref as far
    b, h, hkv, s, dh, causal = case
    q, k, v = _qkv(b, h, hkv, s, dh, torch.bfloat16, cuda, seed=s)
    _flash_close(fa.flash_attention(q, k, v, causal=causal),
                 far.flash_attention_ref(q, k, v, causal=causal), v)
    if not causal:                    # Skv != Sq is legal without the mask
        q, k, v = _qkv(b, h, hkv, s, dh, torch.float32, cuda, seed=1,
                       skv=s + 31)
        _flash_close(fa.flash_attention(q, k, v, causal=False),
                     far.flash_attention_ref(q, k, v, causal=False), v)


def test_flash_attention_unaligned_operands(cuda):
    """Contiguous operands whose data does not start on 16 bytes take the
    element-wise staging, with the same result bit for bit."""
    from repro_torch.kernels.flash_attention import ops as fa
    q, k, v = _qkv(2, 4, 2, 33, 64, torch.bfloat16, cuda, seed=3)

    def shifted(t):
        out = torch.empty(t.numel() + 1, dtype=t.dtype,
                          device=t.device)[1:].view(t.shape)
        return out.copy_(t)

    qs, ks, vs = map(shifted, (q, k, v))
    assert qs.is_contiguous() and qs.data_ptr() % 16
    torch.testing.assert_close(fa.flash_attention(qs, ks, vs),
                               fa.flash_attention(q, k, v), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("sq,skv", [(129, 300), (300, 129), (64, 1000),
                                    (1000, 64)])
def test_flash_attention_causal_at_unequal_lengths(cuda, sq, skv, dtype):
    """Causal at Sq != Skv, top-left aligned, GQA 4/2: ragged tiles on both
    axes on both sides of the diagonal (rows past Skv see every key; q
    tiles that start past Skv read every key tile), one launch a call."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention import ref as far
    q, k, v = _qkv(2, 4, 2, sq, 80, getattr(torch, dtype), cuda, seed=sq,
                   skv=skv)
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=True)
    assert fa.flash_attention.launches == before + 1
    _flash_close(got, far.flash_attention_ref(q, k, v, causal=True), v)


@pytest.mark.parametrize("dh", (257, 288, 320, 512, 1024))
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("causal", (True, False))
def test_flash_attention_wide_heads(cuda, dh, dtype, causal):
    """Head widths above 256 (the wide arm: output slices of 256 columns):
    257 leaves a one-column slice and takes the element-wise staging, 288
    and 320 a ragged slice (fp32 skips its 32-column groups past dh), 512
    and 1024 whole ones; GQA 4/2, ragged Sq 129 against Skv 100 (full) or
    129 (causal)."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention import ref as far
    q, k, v = _qkv(2, 4, 2, 129, dh, getattr(torch, dtype), cuda, seed=dh,
                   skv=None if causal else 100)
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=causal)
    assert fa.flash_attention.launches == before + 1
    _flash_close(got, far.flash_attention_ref(q, k, v, causal=causal), v)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_flash_attention_wide_unaligned_operands(cuda, dtype):
    """At dh 320, operands whose data does not start on 16 bytes take the
    wide arm's element-wise staging and stores: bit for bit the result of
    aligned ones."""
    from repro_torch.kernels.flash_attention import ops as fa
    q, k, v = _qkv(2, 4, 2, 70, 320, getattr(torch, dtype), cuda, seed=4,
                   skv=90)

    def shifted(t):
        out = torch.empty(t.numel() + 1, dtype=t.dtype,
                          device=t.device)[1:].view(t.shape)
        return out.copy_(t)

    qs, ks, vs = map(shifted, (q, k, v))
    assert qs.data_ptr() % 16
    for causal in (True, False):
        torch.testing.assert_close(fa.flash_attention(qs, ks, vs,
                                                      causal=causal),
                                   fa.flash_attention(q, k, v, causal=causal),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("dh", (288, 320, 512))
@pytest.mark.parametrize("sq,skv", [(129, 300), (300, 129)])
def test_flash_attention_f32_wide_causal_unequal(cuda, dh, sq, skv):
    """The fp32 wide arm at causal Sq != Skv, top-left aligned, GQA 4/2:
    short q tiles against a long key axis and rows past Skv that see every
    key, with every slice's m and l from the same scores."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention import ref as far
    q, k, v = _qkv(2, 4, 2, sq, dh, torch.float32, cuda, seed=dh + sq,
                   skv=skv)
    before = fa.flash_attention.launches_f32
    got = fa.flash_attention(q, k, v, causal=True)
    assert fa.flash_attention.launches_f32 == before + 1
    _flash_close(got, far.flash_attention_ref(q, k, v, causal=True), v)


@pytest.mark.parametrize("dh", (30, 128, 288, 320, 512))
def test_flash_attention_f32_unaligned_operands(cuda, dh):
    """fp32 operands whose data does not start on 16 bytes take the
    element-wise staging and scalar stores, narrow and wide: bit for bit
    the result of aligned ones, causal at Sq != Skv and full."""
    from repro_torch.kernels.flash_attention import ops as fa
    q, k, v = _qkv(2, 4, 2, 70, dh, torch.float32, cuda, seed=dh, skv=90)

    def shifted(t):
        out = torch.empty(t.numel() + 1, dtype=t.dtype,
                          device=t.device)[1:].view(t.shape)
        return out.copy_(t)

    qs, ks, vs = map(shifted, (q, k, v))
    assert qs.data_ptr() % 16
    for causal in (True, False):
        torch.testing.assert_close(fa.flash_attention(qs, ks, vs,
                                                      causal=causal),
                                   fa.flash_attention(q, k, v, causal=causal),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("dims", (
    (32, 12, 2, 128, 128),              # qwen2-1.5b's fp32 prefill
    (32, 10, 1, 128, 256),              # recurrentgemma-2b's
    (2, 8, 8, 512, 320)),               # the wide arm, two slices
    ids=("qwen_fp32", "rg_fp32", "wide_320"))
@pytest.mark.parametrize("causal", (True, False))
def test_flash_attention_f32_reruns_bit_equal(cuda, dims, causal):
    """Both fp32 kernels are deterministic (no atomics; each sum in one
    fixed order): two launches on the same operands are bit-equal."""
    from repro_torch.kernels.flash_attention import ops as fa
    b, h, hkv, s, dh = dims
    q, k, v = _qkv(b, h, hkv, s, dh, torch.float32, cuda, seed=s + dh)
    first = fa.flash_attention(q, k, v, causal=causal)
    assert torch.equal(fa.flash_attention(q, k, v, causal=causal), first)


def test_masked_ffn_all_samples_on_card(cuda):
    """The unpacked entry packs the masks and launches ``masked_ffn`` once;
    it agrees with the unpacked oracle."""
    masks = masks_lib.generate_masks(masks_lib.MaskSpec(width=52, n_masks=8,
                                                        scale=2.0))
    gen = torch.Generator().manual_seed(2)
    x, w1, b1, w2, b2 = (_rand(gen, *s).to(cuda) for s in
                         ((300, 104), (104, 52), (52,), (52, 104), (104,)))
    before = mops.masked_ffn.launches
    got = mops.masked_ffn_all_samples(x, w1, b1, w2, b2, masks)
    assert mops.masked_ffn.launches == before + 1
    want = mref.unpacked_masked_ffn_ref(
        x, w1, b1, w2, b2, torch.from_numpy(masks).float().to(cuda))
    torch.testing.assert_close(got, want, rtol=TOL_FWD, atol=TOL_FWD)


def test_flash_attention_refuses_bad_operands(cuda):
    from repro_torch.kernels.flash_attention import ops as fa
    q, k, v = _qkv(2, 4, 2, 16, 32, torch.float32, cuda)
    before = fa.flash_attention.launches
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError, match="bfloat16"):
        fa.flash_attention(q, k.bfloat16(), v.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(2, 3), k, v)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        fa.flash_attention(q[:, :3].contiguous(), k, v)
    assert fa.flash_attention.launches == before


def test_hybrid_serve_uncertain_on_card(cuda):
    """The hybrid path at smoke size (rec, rec, local_attn, rec): one
    prefill runs 3 rglru_scan and 1 flash_attention launches, the per-op
    decode none (and no fused_decode); tokens equal the CPU's and the
    rel-unc agrees within the reference's posterior bar."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.rglru_scan import ops as sops
    cfg = _SMOKE("recurrentgemma-2b")
    model = lm_model.build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (3, 12),
                         generator=torch.Generator().manual_seed(1))
    counters = (sops.rglru_scan, fa.flash_attention, dops.fused_decode)
    before = [c.launches for c in counters]
    got = engine.serve_uncertain(
        model, _to(params, cuda), toks,
        engine.ServeConfig(max_new_tokens=6), device=cuda)
    assert [c.launches - b for c, b in zip(counters, before)] == [3, 1, 0]
    want = engine.serve_uncertain(model, params, toks,
                                  engine.ServeConfig(max_new_tokens=6),
                                  device="cpu")
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=0, atol=0)
    torch.testing.assert_close(got[1].cpu(), want[1], rtol=1e-4, atol=1e-5)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


@pytest.mark.parametrize("dims,causal", (
    ((16, 16, 16, 500, 80), False),     # hubert: 4 clips x 4 masks, dh 80
    ((32, 32, 8, 128, 128), True),      # phi3.5-moe: 8 prompts x 4 masks
    ((32, 56, 8, 128, 128), True),      # arctic: a GQA group of 7
    ((32, 64, 8, 128, 128), True)),     # qwen2-vl
    ids=("hubert", "phi3.5", "arctic", "qwen2-vl"))
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_flash_attention_backbone_shapes(cuda, dtype, dims, causal):
    """The kernel at the backbones' attention shapes [b, h, hkv, s, dh]:
    hubert-xlarge's non-causal forward (dh 80, a ragged width in the
    kernel's 128 bucket) and the causal prefills at the published head
    counts over 8 KV heads."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention import ref as far
    q, k, v = _qkv(*dims, getattr(torch, dtype), cuda, seed=dims[1])
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=causal)
    assert fa.flash_attention.launches == before + 1
    _flash_close(got, far.flash_attention_ref(q, k, v, causal=causal), v)


#: The dense stacks chip_smoke.py serves whole ([dense_*]), at their
#: published head layouts: stablelm-12b's head width 160 (a ragged width in
#: the flash kernel's 256 bucket; a 40-wide rotary part), granite-20b's 48
#: query heads on one KV head, deepseek-coder-33b's GQA group of 7.
DENSE_STACKS = ("stablelm-12b", "granite-20b", "deepseek-coder-33b")
#: fused_decode's mean_logp error over its magnitude (chip_smoke.py
#: TOL_DECODE_REL: fp32-accurate products; one bf16 part misses it)
TOL_DECODE_REL = 1e-5


@pytest.mark.parametrize("arch", DENSE_STACKS)
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_flash_attention_dense_stack_shapes(cuda, dtype, arch):
    """The kernel at the dense stacks' prefill [8 prompts x 4 masks, H, 128,
    dh] over their published KV heads, causal."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention import ref as far
    cfg = registry.get_config(arch)
    q, k, v = _qkv(32, cfg.n_heads, cfg.n_kv_heads, 128,
                   cfg.resolved_head_dim, getattr(torch, dtype), cuda,
                   seed=cfg.n_heads)
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=True)
    assert fa.flash_attention.launches == before + 1
    _flash_close(got, far.flash_attention_ref(q, k, v, causal=True), v)


@pytest.mark.parametrize("arch", DENSE_STACKS)
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_fused_decode_dense_stack_layer(cuda, dtype, arch):
    """The decode kernel on one layer of each dense stack at its published
    widths (4 masks x 3 requests), against its plain version: the
    posteriors within TOL_FWD and mean_logp within TOL_DECODE_REL of its
    magnitude, the fresh k/v as in test_fused_decode_kernel_matches_plain."""
    cfg = registry.get_config(arch, n_layers=1, mask_samples=4,
                              dtype=getattr(torch, dtype))
    spec, args = _decode_inputs(cfg, cuda)
    at = next(s for s in spec.steps if s.kind == "attn")
    assert (at.n_heads, at.n_kv_heads, at.head_dim) == (
        cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim)
    before = dops.fused_decode.launches
    got = dops.fused_decode(spec, *args)
    assert dops.fused_decode.launches == before + 1
    want = dops.fused_decode_ref(spec, *args)
    for g, w in zip(got[:2], want[:2]):
        torch.testing.assert_close(g, w, rtol=TOL_FWD, atol=TOL_FWD)
    rel = float((got[0] - want[0]).abs().max() / want[0].abs().max())
    assert rel <= TOL_DECODE_REL, rel
    for g, w in zip(got[2:], want[2:]):
        if g.dtype == torch.bfloat16:
            _within_bf16_ulp(g, w)
        else:
            torch.testing.assert_close(g, w, rtol=TOL_FWD, atol=TOL_FWD)


@pytest.mark.parametrize("arch", DENSE_STACKS)
def test_fused_decode_dense_stack_depth(cuda, arch):
    """Four bf16 layers of each dense stack at its published widths on
    chip_smoke.py's pool (8 requests x 4 masks at position 128 of a
    160-slot cache): every layer's fresh k/v within one bf16 ulp of the
    plain version's. Summed in one tensor-core chain over K, deepseek-coder-
    33b's drifted past two ulps from its third layer on (the plain version
    on the CPU and on the card stay within one ulp of each other at every
    layer of the 40-layer stablelm-12b)."""
    cfg = registry.get_config(arch, n_layers=4, mask_samples=4)
    spec, args = _decode_inputs(cfg, cuda, b=8, plen=128, max_seq=160)
    got = dops.fused_decode(spec, *args)
    want = dops.fused_decode_ref(spec, *args)
    for g, w in zip(got[:2], want[:2]):
        torch.testing.assert_close(g, w, rtol=TOL_FWD, atol=TOL_FWD)
    for g, w in zip(got[2:], want[2:]):
        for layer in range(g.shape[0]):
            _within_bf16_ulp(g[layer], w[layer])


BACKBONES =("phi3.5-moe-42b-a6.6b", "arctic-480b", "xlstm-350m",
             "qwen2-vl-72b", "hubert-xlarge")


@pytest.mark.parametrize("arch", BACKBONES)
def test_backbone_on_card_matches_cpu(cuda, arch):
    """Each family of the later slices at smoke size on the card against
    the CPU's plain path from the same weights: a prefill (qwen2-vl and
    hubert over embeddings, qwen2-vl with [3, B, S] M-RoPE positions) and
    two decode steps, or hubert's forward. Every attention layer's prefill
    or forward is one flash_attention launch (non-causal for hubert); no
    fused_decode launch. fp32, within TOL_FWD."""
    from repro_torch.kernels.flash_attention import ops as fa
    cfg = _SMOKE(arch)
    params = transformer.init(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    on_card = _to(params, cuda)
    gen = torch.Generator().manual_seed(1)
    b, s = 4, 9
    if cfg.embeds_input:
        batch = {"embeds": torch.randn((b, s, cfg.d_model), generator=gen)}
    else:
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                         generator=gen)}
    if cfg.m_rope_sections:
        batch["positions"] = (torch.arange(s)[None, None]
                              + torch.arange(b)[None, :, None]
                              + torch.tensor([0, 1, 2])[:, None, None])
    attn_layers = sum(seg.reps * sum(k in ("attn", "moe") for k in
                                     seg.pattern) for seg in cfg.segments())
    counters = (fa.flash_attention, dops.fused_decode)
    card_batch = {k: t.to(cuda) for k, t in batch.items()}
    if not cfg.has_decode:
        want, _ = transformer.forward(cfg, params, batch, device="cpu")
        before = [c.launches for c in counters]
        got, _ = transformer.forward(cfg, on_card, card_batch, device=cuda)
        assert [c.launches - n for c, n in zip(counters, before)] == \
            [attn_layers, 0]
        torch.testing.assert_close(got.cpu(), want, rtol=TOL_FWD,
                                   atol=TOL_FWD)
        return
    want, wc = transformer.prefill(cfg, params, batch, max_seq=s + 2)
    wants, toks = [want], []
    for i in range(2):
        toks.append(wants[-1].argmax(-1)[:, None])
        want, wc = transformer.decode_step(cfg, params, wc, toks[-1], s + i)
        wants.append(want)
    before = [c.launches for c in counters]
    got, gc = transformer.prefill(cfg, on_card, card_batch, max_seq=s + 2)
    assert [c.launches - n for c, n in zip(counters, before)] == \
        [attn_layers, 0]
    torch.testing.assert_close(got.cpu(), wants[0], rtol=TOL_FWD,
                               atol=TOL_FWD)
    for i, tok in enumerate(toks):
        got, gc = transformer.decode_step(cfg, on_card, gc, tok.to(cuda),
                                          s + i)
        torch.testing.assert_close(got.cpu(), wants[i + 1], rtol=TOL_FWD,
                                   atol=TOL_FWD)
    assert [c.launches - n for c, n in zip(counters, before)] == \
        [attn_layers, 0]
    for g, w in zip(_leaves_of(gc), _leaves_of(wc)):
        torch.testing.assert_close(g.cpu(), w, rtol=TOL_FWD, atol=TOL_FWD)


def _leaves_of(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves_of(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves_of(v)]
    return [tree]


# ---------------------------------------------------------------------------
# moments and the design flow
# ---------------------------------------------------------------------------

MOMENTS_MEAN = dict(rtol=1e-5, atol=1e-6)
MOMENTS_STD = dict(rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shape", [
    (8, 4096, 4),          # the per-op IVIM chunk
    (4, 8, 151936),        # the qwen2-1.5b posterior
    (4, 8, 256000),        # the recurrentgemma-2b posterior
    (64, 65536, 4),        # the reference's N ceiling
    (3, 4097, 5),          # ragged B*P
    (1, 7, 3), (9, 33, 7), (17, 5, 129)])   # N = 1 and N beyond kCache
def test_moments_kernel_matches_plain(cuda, shape):
    x = torch.randn(shape, generator=torch.Generator().manual_seed(0)) \
        .to(cuda)
    before = moops.moments.launches
    mean, std = moops.moments(x)
    assert moops.moments.launches == before + 1
    want = moref.moments_ref(x)
    assert mean.shape == std.shape == shape[1:]
    torch.testing.assert_close(mean, want[0], **MOMENTS_MEAN)
    torch.testing.assert_close(std, want[1], **MOMENTS_STD)


@pytest.mark.parametrize("n", (1, 7, 8, 9, 16, 17, 33, 64, 65, 200))
def test_moments_kernel_every_register_bucket(cuda, n):
    """Every register bucket (8, 16, 32, 64), full and part-filled, and
    the samples past 64 that the second pass reads again."""
    x = torch.randn((n, 37, 5), generator=torch.Generator().manual_seed(n)) \
        .to(cuda)
    before = moops.moments.launches
    mean, std = moops.moments(x)
    assert moops.moments.launches == before + 1
    want = moref.moments_ref(x)
    torch.testing.assert_close(mean, want[0], **MOMENTS_MEAN)
    torch.testing.assert_close(std, want[1], **MOMENTS_STD)


def test_moments_kernel_deterministic_and_shape_free(cuda):
    """Each output element depends on its own N samples alone, summed in
    one order: a launch repeats bit for bit, and the first rows of a
    longer batch equal a shorter batch's — what the bucketed-vs-exact
    prefill's bitwise posterior needs of the kernel."""
    x = torch.randn((4, 8, 1000), generator=torch.Generator().manual_seed(3)
                    ).to(cuda)
    a, b = moops.moments(x), moops.moments(x)
    part = moops.moments(x[:, :5].contiguous())
    for full, again, short in zip(a, b, part):
        assert torch.equal(full, again)
        assert torch.equal(full[:5], short)


def test_moments_kernel_bf16_and_constant(cuda):
    x = torch.randn((8, 4096, 4), generator=torch.Generator().manual_seed(1)
                    ).to(cuda, torch.bfloat16)
    got, want = moops.moments(x), moref.moments_ref(x)
    for g, w in zip(got, want):           # one bf16 ulp of the plain value
        assert g.dtype == torch.bfloat16
        g, w = g.float(), w.float()
        ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(1e-30)))
                         - 7)
        assert bool(((g - w).abs() <= ulp).all()), float((g - w).abs().max())
    for value in (1.0, -0.375):           # sums exact in fp32
        mean, std = moops.moments(torch.full((8, 16, 4), value, device=cuda))
        assert bool((std == 0).all()) and bool((mean == value).all())


def test_moments_refuses_bad_operands(cuda):
    x = torch.randn(4, 6, 5, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        moops.moments(x.transpose(1, 2))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        moops.moments(x.double())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        moops.moments(x.half())
    with pytest.raises(ValueError, match=r"\[N, B, P\]"):
        moops.moments(x[0])
    with pytest.raises(ValueError, match="empty"):
        moops.moments(x[:, :0])


def test_predictive_moments_on_card_launches_moments(cuda):
    from repro_torch.core import uncertainty as unc
    gen = torch.Generator().manual_seed(2)
    for shape, axis in (((8, 33, 4), 0), ((33, 8, 4), 1), ((6, 5), -1)):
        s = torch.randn(shape, generator=gen)
        before = moops.moments.launches
        got = unc.predictive_moments(s.to(cuda), axis=axis)
        assert moops.moments.launches == before + 1
        want = unc.predictive_moments(s, axis=axis)
        torch.testing.assert_close(got[0].cpu(), want[0], **MOMENTS_MEAN)
        torch.testing.assert_close(got[1].cpu(), want[1], **MOMENTS_STD)
    logits = torch.randn((4 * 3, 97), generator=gen) * 3
    before = moops.moments.launches
    mean, rel = unc.token_posterior(logits.to(cuda), 4)
    assert moops.moments.launches == before + 1
    wmean, wrel = unc.token_posterior(logits, 4)
    torch.testing.assert_close(mean.cpu(), wmean, **MOMENTS_MEAN)
    torch.testing.assert_close(rel.cpu(), wrel, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("shape,axis", [((0, 3, 4), 0), ((0,), 0),
                                        ((4, 3, 0), 0), ((8, 33, 4), 0),
                                        ((5, 6), -1)])
def test_predictive_moments_on_card_fp16_and_empty(cuda, shape, axis):
    """fp16 on the card is widened to the fp32 kernel (one launch) and cast
    back; an empty input launches nothing; both give the CPU's results
    (NaN for an empty sample axis), fp16 within one fp16 ulp."""
    from repro_torch.core import uncertainty as unc
    s = torch.randn(shape, generator=torch.Generator().manual_seed(5)).half()
    before = moops.moments.launches
    got = unc.predictive_moments(s.to(cuda), axis=axis)
    assert moops.moments.launches == before + (1 if s.numel() else 0)
    want = unc.predictive_moments(s, axis=axis)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.float16
        assert g.shape == w.shape and g.device.type == "cuda"
        g, w = g.cpu().float(), w.float()
        ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(2.0 ** -24)))
                         - 10)
        assert bool(((g - w).abs() <= ulp).all() if s.numel() and shape[0]
                    else torch.equal(g.isnan(), w.isnan()))


@pytest.mark.parametrize("wrapper", ("moments", "rglru_scan",
                                     "flash_attention"))
def test_wrappers_bind_c_entry_once(cuda, wrapper):
    """A wrapper's C entry is resolved with its signature once: two calls
    use the same bound function object, and the second sets no argtypes."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.rglru_scan import ops as sops
    gen = torch.Generator().manual_seed(6)
    call, lib, entry = {
        "moments": (lambda: moops.moments(
            torch.randn((4, 6, 5), generator=gen).to(cuda)),
            "moments", "moments_f32_launch"),
        "rglru_scan": (lambda: sops.rglru_scan(*_gates((2, 8, 6), cuda)),
                       "rglru_scan", "rglru_scan_launch"),
        "flash_attention": (lambda: fa.flash_attention(
            *_qkv(1, 2, 1, 9, 16, torch.bfloat16, cuda)),
            "flash_attention", "flash_attention_bf16_launch")}[wrapper]
    call()
    fn = _build._BOUND[(lib, entry)]
    sig = fn.argtypes
    call()
    assert _build._BOUND[(lib, entry)] is fn and fn.argtypes is sig
    assert _build.bind(lib, entry, list(sig)) is fn


def test_train_step_on_card_matches_cpu(cuda):
    """One Adam step from identical parameters on the card and on the CPU
    (1e-5: fp32 products in another order), then a short run on the card.
    The directions batch-statistics BN hides from the loss — the biases
    ahead of BN and fc1's row for the b=0 input, 1.0 in every voxel — get
    float-noise gradients that Adam turns into steps of about lr: those
    are held to 2 lr."""
    from repro_torch.ivim import data as ivim_data
    from repro_torch.ivim import train as ivim_train
    cfg = ivim_model.IvimConfig(n_masks=4)
    tcfg = ivim_train.TrainConfig(steps=3, lr=3e-3)
    x = ivim_data.make_dataset(ivim_data.SyntheticConfig(n_voxels=128),
                               device="cpu")["signals"]
    losses = {}
    models = {}
    for dev in ("cpu", cuda):
        model = ivim_model.init(cfg, torch.Generator().manual_seed(0),
                                device=dev)
        step, init_opt = ivim_train.make_train_step(cfg, tcfg)
        losses[str(dev)] = step(model, init_opt(model), x.to(dev)).item()
        models[str(dev)] = model
    np.testing.assert_allclose(losses[str(cuda)], losses["cpu"], rtol=1e-5)
    null = {"fc1.b": (...,), "fc2.b": (...,), "fc1.w": (slice(None), 0)}
    for (name, p), q in zip(models["cpu"].named_parameters(),
                            models[str(cuda)].parameters()):
        got, want = q.detach().cpu().clone(), p.detach().clone()
        if name in null:
            assert float((got[null[name]] - want[null[name]]).abs().max()) \
                <= 2 * tcfg.lr
            got[null[name]] = want[null[name]] = 0.0
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5, msg=name)
    model, hist = ivim_train.train(cfg, tcfg, device=cuda)
    assert len(hist) == 3 and np.isfinite(hist).all()
    assert all(p.device.type == "cuda" for p in model.parameters())


def test_bucketed_prefill_bitwise_on_card(cuda):
    """On the card the bucketed prefill (prompt padded to its bucket) is the
    exact-length prefill bit for bit at every length: posterior,
    uncertainty and every cache leaf (the flash kernel's masked keys add
    exact zeros)."""
    cfg = _SMOKE("qwen2-1.5b", n_layers=2)
    model = lm_model.build_model(cfg)
    params = model.init(torch.Generator(cuda).manual_seed(0), device=cuda)
    fb = server.step_fns(model, device=cuda)
    fe = server.step_fns(model, prefill_buckets=(), device=cuda)
    gen = torch.Generator().manual_seed(2)
    for length in range(1, 13):
        toks = torch.randint(0, cfg.vocab_size, (1, length), generator=gen)
        toks = toks.repeat(cfg.mask_samples, 1).to(cuda)
        got = fb.prefill(params, toks, max_seq=12)
        want = fe.prefill(params, toks, max_seq=12)
        for g, w in zip(got[:2], want[:2]):
            assert torch.equal(g, w), length
        for seg_g, seg_w in zip(got[2], want[2]):
            for b in seg_g:
                for name in seg_g[b]:
                    assert torch.equal(seg_g[b][name], seg_w[b][name]), \
                        (length, b, name)


def test_server_on_card(cuda):
    """The continuous-batching server at smoke size on the card: one fused
    decode launch a step with an LM slot, one fused moments launch a scan
    chunk, no step built on repeat traffic, the pooled scan bitwise the
    direct predict_volume, and the pool's tokens those of the one-shot
    serve_uncertain (rel-unc within the reference's posterior bar)."""
    from repro_torch.obs import registry as obs_registry
    cfg = _SMOKE("qwen2-1.5b", n_layers=2)
    model = lm_model.build_model(cfg)
    params = model.init(torch.Generator(cuda).manual_seed(0), device=cuda)
    icfg = ivim_model.IvimConfig(n_masks=cfg.mask_samples)
    plan = ivim_model.pack_for_serving(ivim_model.init(
        icfg, torch.Generator().manual_seed(1), device=cuda))
    x = torch.rand((45, icfg.width), generator=torch.Generator(
        cuda).manual_seed(3), device=cuda)
    direct = engine.predict_volume(plan, x, chunk=8, fused=True, device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (4, 6),
                         generator=torch.Generator().manual_seed(4))
    scfg = server.ServerConfig(max_slots=3, max_prompt_len=8,
                               max_new_tokens=5, fused=True)
    for warm in (True, False):
        srv = server.BayesianLMServer(model, params, scfg, device=cuda)
        builds = obs_registry.REGISTRY.value("step_builds_total")
        before = (dops.fused_decode.launches, fops.fused_moments.launches)
        rids = [srv.submit(t) for t in toks]
        rs = srv.submit_scan(plan, x, chunk=8, fused=True)
        srv.run()
        occ = zip(srv.metrics.occupancy_samples,
                  srv.metrics.voxel_occupancy_samples)
        assert dops.fused_decode.launches - before[0] == \
            sum(o > v for o, v in occ)
        assert fops.fused_moments.launches - before[1] == 6
        if not warm:
            assert obs_registry.REGISTRY.value("step_builds_total") == builds
    for g, w in zip(srv.result(rs).scan_moments(), direct):
        assert torch.equal(g, w)
    gen, unc, _ = engine.serve_uncertain(
        model, params, toks, engine.ServeConfig(max_new_tokens=5,
                                                fused=True), device=cuda)
    for i, r in enumerate(rids):
        st = srv.result(r)
        assert st.generated == gen[i, 6:].tolist()
        torch.testing.assert_close(torch.tensor(st.uncertainty),
                                   unc[i].cpu(), rtol=1e-4, atol=1e-5)


def test_router_failover_on_card(cuda):
    """The fault-tolerant router over three hosts on the card: host 1 killed
    mid-decode and host 0 (the scan's home) mid-scan. Every request
    completes with the tokens of one unfaulted server and rel-unc within the
    reference's posterior bar (the fused decode sums across blocks with
    float atomics, so not bit for bit); the failed-over scan resumes at its
    chunk cursor and its moments are bitwise the direct predict_volume; a
    second pass builds no step."""
    from repro_torch.obs import registry as obs_registry
    from repro_torch.obs.trace import ManualClock
    from repro_torch.serving import router as router_lib
    from repro_torch.serving.faults import FaultEvent, FaultPlan
    cfg = _SMOKE("qwen2-1.5b", n_layers=2)
    model = lm_model.build_model(cfg)
    params = model.init(torch.Generator(cuda).manual_seed(0), device=cuda)
    icfg = ivim_model.IvimConfig(n_masks=cfg.mask_samples)
    plan = ivim_model.pack_for_serving(ivim_model.init(
        icfg, torch.Generator().manual_seed(1), device=cuda))
    x = torch.rand((45, icfg.width), generator=torch.Generator(
        cuda).manual_seed(3), device=cuda)
    direct = engine.predict_volume(plan, x, chunk=8, fused=True, device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (6, 6),
                         generator=torch.Generator().manual_seed(4))
    scfg = server.ServerConfig(max_slots=2, max_prompt_len=8,
                               max_new_tokens=5, fused=True)
    single = server.BayesianLMServer(model, params, scfg, device=cuda)
    srids = [single.submit(t) for t in toks]
    single.run()
    faults = FaultPlan(events=(FaultEvent(step=2, host=1, action="kill"),
                               FaultEvent(step=3, host=0, action="kill")))
    rcfg = router_lib.RouterConfig(n_hosts=3, heartbeat_timeout_s=2.5,
                                   max_retries=4)
    for warm in (True, False):
        clock = ManualClock()
        router = router_lib.ServingRouter(model, params, scfg, rcfg,
                                          device=cuda, faults=faults,
                                          clock=clock)
        builds = obs_registry.REGISTRY.value("step_builds_total")
        router._rr = 0                   # the scan's home is host 0
        rs = router.submit_scan(plan, x, chunk=8, fused=True)
        rids = [router.submit(t) for t in toks]
        s = router.run(max_steps=300, tick=lambda: clock.advance(1.0))
        assert (s.host_deaths, s.lost, s.shed, s.completed) == (2, 0, 0, 7)
        assert router.result(rs).retries >= 1 and s.remeshes >= 1
        if not warm:
            assert obs_registry.REGISTRY.value("step_builds_total") == builds
    for g, w in zip(router.result(rs).scan_moments(), direct):
        assert torch.equal(g, w)
    for r, q in zip(rids, srids):
        got, want = router.result(r), single.result(q)
        assert got.generated == want.generated
        torch.testing.assert_close(torch.tensor(got.uncertainty),
                                   torch.tensor(want.uncertainty),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("batch", [4096, 100])
def test_schedule_orders_on_card(cuda, batch):
    """The paper's schedules on the card at the dense IVIM widths: the
    Masksembles layer mask by mask (the baseline), the packed form,
    ``scheduler.run`` batch- and sampling-level (a ragged batch padded to
    the 64-voxel chunk) and ``masked_ffn`` in both grid orders, all within
    2e-5 of the baseline's magnitude (fp32-accurate products), the
    kernel's two orders bit-equal."""
    from repro_torch.core import masksembles, packing, scheduler
    w, n = 104, 8
    gen = torch.Generator(cuda).manual_seed(0)
    p = masksembles.masked_ffn_init(gen, w, w, w, masks_lib.MaskSpec(
        width=w, n_masks=n, scale=2.0, seed=0))
    for layer in ("fc1", "fc2"):
        p[layer]["b"] = 0.1 * torch.randn(w, generator=gen, device=cuda)
    x = torch.rand((batch, w), generator=gen, device=cuda)
    pk = packing.pack_masked_ffn(p["fc1"]["w"], p["fc1"]["b"], p["fc2"]["w"],
                                 p["fc2"]["b"], p["fc1"]["masks"])

    def per_sample(params, xb, i):
        return packing.packed_ffn_apply(params, xb, sample=i)

    base = torch.stack([masksembles.masked_ffn_apply(
        p, x, torch.full((batch,), i, device=cuda)) for i in range(n)])
    before = mops.masked_ffn.launches
    k_batch = mops.masked_ffn(x, pk["w1p"], pk["b1p"], pk["w2p"], pk["b2"],
                              sample_major=True)
    k_samp = mops.masked_ffn(x, pk["w1p"], pk["b1p"], pk["w2p"], pk["b2"],
                             sample_major=False)
    assert mops.masked_ffn.launches == before + 2
    assert torch.equal(k_batch, k_samp)
    for out in (packing.packed_ffn_apply(pk, x),
                scheduler.run(scheduler.Schedule("batch"), per_sample, pk, x,
                              n),
                scheduler.run(scheduler.Schedule("sampling", chunk=64),
                              per_sample, pk, x, n), k_batch):
        assert out.shape == base.shape
        assert float((out - base).abs().max() / base.abs().max()) <= 2e-5


# ---------------------------------------------------------------------------
# training: the scan's backward kernel, a train step, the wrapper guard
# ---------------------------------------------------------------------------

# the backward kernel against autograd through the plain version: max abs
# error over the plain gradient's magnitude (a sequential carry against the
# odd/even tree)
TOL_SCAN_BWD_REL = 1e-5


@pytest.mark.parametrize("shape", [
    (8, 1024, 2560),      # recurrentgemma-2b's training batch
    (3, 37, 11),          # ragged B, S and W
    (2, 1, 5),            # one step
    (1, 4099, 130)])      # long S past the unrolled loop, ragged tail
def test_rglru_scan_function_grads_match_plain_autograd(cuda, shape):
    from repro_torch.kernels.rglru_scan import ops as sops
    from repro_torch.kernels.rglru_scan import ref as sref
    a, b = _gates(shape, cuda, seed=sum(shape) + 1)
    g = torch.randn(shape, generator=torch.Generator().manual_seed(9)).to(
        cuda)
    ka, kb = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
    pa, pb = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
    launches = sops.rglru_scan.launches
    backward = sops.rglru_scan.backward_launches
    h = sops.RGLRUScan.apply(ka, kb)
    got = torch.autograd.grad(h, (ka, kb), g)
    assert sops.rglru_scan.launches == launches + 2
    assert sops.rglru_scan.backward_launches == backward + 1
    want = torch.autograd.grad(sref.rglru_scan_ref(pa, pb), (pa, pb), g,
                               allow_unused=True)
    want = (torch.zeros_like(a) if want[0] is None else want[0], want[1])
    for k, p in zip(got, want):
        scale = float(p.abs().max()) or 1.0
        assert float((k - p).abs().max()) <= TOL_SCAN_BWD_REL * scale


# ---------------------------------------------------------------------------
# the chunked scan (csrc/rglru_scan.cu): chunk edges, layouts, determinism
# ---------------------------------------------------------------------------

# the kernels cut time into chunks of 64 steps (kWarps x kFwdSteps and
# kWarps x kBwdSteps, 8 warps of 8 steps, constants), whatever B and W
SCAN_CHUNK = 64
# a in [0.999, 0.9999] over S 16,384: the carry crosses 256 chunks and the
# state remembers 10^3-10^4 steps. Against the plain scan in float64 (on
# the fp32 inputs), over the float64 result's largest magnitude: fp32 rounds
# each step by up to 2^-24 of |h|, and those errors add like a random walk
# over the state's memory, sqrt(10^4) 2^-24 = 6e-6 at most; a CPU emulation
# of the kernel's chunk order read 7e-7 forward and 9e-7 backward
TOL_SLOW_DECAY_REL = 1e-5


def _scan(sops, direction, a, b, g):
    """The kernel's output(s) in ``direction``: (h,) forward; (da, db)
    backward, from the h the plain version gives."""
    if direction == "forward":
        return (sops.rglru_scan(a, b),)
    from repro_torch.kernels.rglru_scan import ref as sref
    return sops.rglru_scan_backward(a, sref.rglru_scan_ref(a, b), g)


def _scan_against_plain(sops, direction, a, b, g):
    from repro_torch.kernels.rglru_scan import ref as sref
    got = _scan(sops, direction, a, b, g)
    if direction == "forward":
        torch.testing.assert_close(got[0], sref.rglru_scan_ref(a, b),
                                   rtol=TOL_SCAN, atol=TOL_SCAN)
        return got
    want = sref.rglru_scan_bwd_ref(a, sref.rglru_scan_ref(a, b), g)
    for k, p in zip(got, want):
        scale = float(p.abs().max()) or 1.0
        assert float((k - p).abs().max()) <= TOL_SCAN_BWD_REL * scale
    return got


def _scan_inputs(shape, device, seed):
    a, b = _gates(shape, device, seed=seed)
    g = torch.randn(shape, generator=torch.Generator().manual_seed(seed + 1))
    return a, b, g.to(device)


@pytest.mark.parametrize("direction", ("forward", "backward"))
@pytest.mark.parametrize("shape", [
    (2, 1, 256),                    # one step
    (2, SCAN_CHUNK - 1, 256),       # one chunk, short of full
    (2, SCAN_CHUNK, 256),           # one full chunk
    (2, SCAN_CHUNK + 1, 256),       # a second chunk of one step
    (2, 3 * SCAN_CHUNK, 256),       # a multiple of the chunk
    (2, 4099, 256),                 # many chunks, ragged tail
    (1, 16384, 4)])                 # a long S over few channels
def test_rglru_scan_chunk_edges(cuda, shape, direction):
    from repro_torch.kernels.rglru_scan import ops as sops
    a, b, g = _scan_inputs(shape, cuda, seed=sum(shape))
    _scan_against_plain(sops, direction, a, b, g)


@pytest.mark.parametrize("direction", ("forward", "backward"))
@pytest.mark.parametrize("layout", ("ragged_w", "offset_base"))
def test_rglru_scan_odd_layouts(cuda, layout, direction):
    """A W that is not a multiple of 4, and contiguous operands whose base
    is one element past a 16-byte boundary: the scalar loads, against the
    plain version; the offset operands give the aligned operands' bits."""
    from repro_torch.kernels.rglru_scan import ops as sops
    shape = (3, 2 * SCAN_CHUNK + 5, 130 if layout == "ragged_w" else 256)
    a, b, g = _scan_inputs(shape, cuda, seed=7)
    if layout == "ragged_w":
        _scan_against_plain(sops, direction, a, b, g)
        return

    def offset(x):
        buf = torch.empty(x.numel() + 1, device=x.device, dtype=x.dtype)
        view = buf[1:].view(x.shape)
        view.copy_(x)
        assert view.is_contiguous() and view.data_ptr() % 16 == 4
        return view

    got = _scan_against_plain(sops, direction, offset(a), offset(b),
                              offset(g))
    for x, y in zip(got, _scan(sops, direction, a, b, g)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("direction", ("forward", "backward"))
def test_rglru_scan_two_launches_bit_equal(cuda, direction):
    from repro_torch.kernels.rglru_scan import ops as sops
    a, b, g = _scan_inputs((4, 4096, 512), cuda, seed=3)
    for x, y in zip(_scan(sops, direction, a, b, g),
                    _scan(sops, direction, a, b, g)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("direction", ("forward", "backward"))
def test_rglru_scan_rows_independent_of_batch(cuda, direction):
    """The first rows of a batch of 8 equal, bit for bit, the same rows
    run as a batch of 3 (another grid, another schedule)."""
    from repro_torch.kernels.rglru_scan import ops as sops
    a, b, g = _scan_inputs((8, 1000, 384), cuda, seed=5)
    full = _scan(sops, direction, a, b, g)
    part = _scan(sops, direction, *(x[:3].contiguous() for x in (a, b, g)))
    for x, y in zip(full, part):
        assert torch.equal(x[:3], y)


@pytest.mark.parametrize("direction", ("forward", "backward"))
def test_rglru_scan_replays_in_a_cuda_graph(cuda, direction):
    """The kernels keep their tickets and epochs on the card: a launch
    captured once (after an eager launch on the capture stream) replays on
    new inputs with the bits of a direct launch."""
    from repro_torch.kernels.rglru_scan import ops as sops
    shape = (2, 3 * SCAN_CHUNK + 7, 256)
    a, b, g = _scan_inputs(shape, cuda, seed=13)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        _scan(sops, direction, a, b, g)
    torch.cuda.current_stream(cuda).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        captured = _scan(sops, direction, a, b, g)
    for seed in (14, 15, 16):
        for x, y in zip((a, b, g), _scan_inputs(shape, cuda, seed=seed)):
            x.copy_(y)
        graph.replay()
        torch.cuda.synchronize(cuda)
        for x, y in zip(captured, _scan(sops, direction, a, b, g)):
            assert torch.equal(x, y)


@pytest.mark.parametrize("direction", ("forward", "backward"))
@pytest.mark.parametrize("warm", (False, True))
def test_rglru_scan_graph_owns_its_workspace(cuda, direction, warm):
    """A capture owns its workspace, on a stream that never ran a scan
    (``warm`` False: larger eager launches there after the capture replace
    the stream's workspace) or on one whose workspace a larger eager launch
    made first (``warm`` True: it is large enough for the capture). A
    replay on a third stream of higher priority, started while an eager
    launch runs on the capture stream (so its blocks start between the
    eager launch's), gives the bits of a direct launch, and so does the
    eager launch."""
    from repro_torch.kernels.rglru_scan import ops as sops
    from repro_torch.kernels.rglru_scan import ref as sref

    def launch(a, b, g, h):
        if direction == "forward":
            return (sops.rglru_scan(a, b),)
        return sops.rglru_scan_backward(a, h, g)

    # the eager launch is 10,240 blocks (past a stream's least workspace)
    # and runs ~0.4-0.7 ms; the replay waits 25-250 us on its stream first
    shape, big_shape = (2, 3 * SCAN_CHUNK + 7, 256), (4, 8192, 2560)
    small = [_scan_inputs(shape, cuda, seed=s) for s in (17, 19, 20, 21)]
    small = [(a, b, g, sref.rglru_scan_ref(a, b)) for a, b, g in small]
    big = _scan_inputs(big_shape, cuda, seed=18)
    big = (*big, sref.rglru_scan_ref(*big[:2]))
    big_want = launch(*big)                  # the library loaded, uncaptured
    inputs = tuple(x.clone() for x in small[0])
    side = torch.cuda.Stream(cuda)
    other = torch.cuda.Stream(cuda, priority=-1)
    side.wait_stream(torch.cuda.current_stream(cuda))
    if warm:
        with torch.cuda.stream(side):
            launch(*big)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        captured = launch(*inputs)
    for new, cycles in zip(small[1:], (50_000, 200_000, 500_000)):
        for x, y in zip(inputs, new):
            x.copy_(y)
        side.wait_stream(torch.cuda.current_stream(cuda))
        other.wait_stream(torch.cuda.current_stream(cuda))
        with torch.cuda.stream(side):
            big_got = launch(*big)
        with torch.cuda.stream(other):
            torch.cuda._sleep(cycles)
            graph.replay()
        torch.cuda.synchronize(cuda)
        for x, y in zip(captured, launch(*new)):
            assert torch.equal(x, y)
        for x, y in zip(big_got, big_want):
            assert torch.equal(x, y)


@pytest.mark.parametrize("direction", ("forward", "backward"))
def test_rglru_scan_slow_decay_against_float64(cuda, direction):
    from repro_torch.kernels.rglru_scan import ops as sops
    from repro_torch.kernels.rglru_scan import ref as sref
    gen = torch.Generator().manual_seed(11)
    shape = (2, 16384, 8)
    a = 0.999 + 0.0009 * torch.rand(shape, generator=gen)
    b = torch.randn(shape, generator=gen) * torch.sqrt(1 - a * a)
    g = torch.randn(shape, generator=gen)
    a, b, g = (x.to(cuda) for x in (a, b, g))
    a64, b64, g64 = (x.double() for x in (a, b, g))
    h64 = sref.rglru_scan_ref(a64, b64)
    if direction == "forward":
        got, want = (sops.rglru_scan(a, b),), (h64,)
    else:
        got = sops.rglru_scan_backward(a, h64.float(), g)
        want = sref.rglru_scan_bwd_ref(a64, h64, g64)
    for k, p in zip(got, want):
        rel = float((k.double() - p).abs().max() / p.abs().max())
        assert rel <= TOL_SLOW_DECAY_REL, rel


# one bf16 train step of the smoke qwen2, card against CPU (bf16 products
# and sums in another order), about twice to ten times what an H100 read
# (NVIDIA H100 80GB HBM3, 700.00 W): loss 6.8e-6 and gnorm 1.8e-4 relative;
# each leaf of AdamW's first moment (0.1 x the clipped gradient) 9.0e-3 of
# the leaf's largest at most (the value bias; two to three bf16 ulps)
TOL_BF16_STEP = {"loss": 1e-4, "gnorm": 2e-3}
TOL_BF16_GRAD = 2e-2


def test_qwen_bf16_train_step_on_card_matches_cpu(cuda):
    """One bf16 train step of the smoke qwen2-1.5b (2 layers, 4 masks) from
    identical parameters on the card and on the CPU. Loss and gnorm within
    TOL_BF16_STEP, relative; the gradients, read as AdamW's first moment, within
    TOL_BF16_GRAD of each leaf's largest. The parameters within what that
    gradient bar implies: AdamW's first step moves a parameter by lr g/(|g|
    + eps), and two gradients d apart move it by at most 2 d/(max |g| + eps)
    lr apart, d = TOL_BF16_GRAD x the leaf's largest gradient; plus one
    bf16 ulp of the value (each side rounds half an ulp), at most 2^-7 of
    it. No flash launch in training."""
    from repro_torch.core import tree as tree_lib
    from repro_torch.data import LMDataConfig, lm_batch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.optim import OptimizerConfig, build_optimizer
    from repro_torch.train import make_train_step, train_state_init
    from repro_torch.train import TrainConfig as LmTrainConfig
    cfg = registry.smoke_config("qwen2-1.5b", dtype=torch.bfloat16,
                                remat="full", attn_chunk=16)
    model = lm_model.build_model(cfg)
    ocfg = OptimizerConfig(lr=1e-3, warmup_steps=0)
    opt = build_optimizer(ocfg)
    step = make_train_step(model, opt, LmTrainConfig())
    data = LMDataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                        global_batch=8)
    cpu = train_state_init(model, opt, torch.Generator().manual_seed(0),
                           device="cpu")
    card = tree_lib.tree_map(lambda t: t.to(cuda, copy=True), cpu)
    flash = fa_ops.flash_attention.launches
    card, m_card = step(card, lm_batch(data, 0, cuda))
    assert fa_ops.flash_attention.launches == flash
    cpu, m_cpu = step(cpu, lm_batch(data, 0, "cpu"))
    rel = {k: abs(float(m_card[k]) - float(m_cpu[k])) / abs(float(m_cpu[k]))
           for k in ("loss", "gnorm")}
    grad_rel, param_use = {}, 0.0
    for (path, got), want, mu_c, mu_w in zip(
            tree_lib.flatten_with_path(card["params"]),
            tree_lib.leaves(cpu["params"]),
            tree_lib.leaves(card["opt"]["mu"]),
            tree_lib.leaves(cpu["opt"]["mu"])):
        g_card, g_cpu = mu_c.cpu() / 0.1, mu_w / 0.1
        scale = float(g_cpu.abs().max())
        if scale == 0:
            assert float(g_card.abs().max()) == 0, path
            continue
        grad_rel[path] = float((g_card - g_cpu).abs().max()) / scale
        d = TOL_BF16_GRAD * scale
        got, want = got.detach().cpu().float(), want.detach().float()
        room = (ocfg.lr * torch.clamp(
            2 * d / (torch.maximum(g_card.abs(), g_cpu.abs()) + ocfg.eps),
            max=2.0)
            + 2.0 ** -7 * torch.maximum(got.abs(), want.abs()))
        param_use = max(param_use, float(((got - want).abs() / room).max()))
    worst = max(grad_rel, key=grad_rel.get)
    print(f"bf16 step card vs CPU: loss {rel['loss']:.3g} gnorm "
          f"{rel['gnorm']:.3g}; gradient {grad_rel[worst]:.3g} at {worst}; "
          f"parameters at {param_use:.3g} of their bound")
    for key in ("loss", "gnorm"):
        assert rel[key] <= TOL_BF16_STEP[key], (key, rel)
    assert grad_rel[worst] <= TOL_BF16_GRAD, (worst, grad_rel)
    assert param_use <= 1.0


@pytest.mark.parametrize("arch", sorted(dict(chip_smoke.FAMILY_AGREE)))
def test_family_train_step_on_card_matches_cpu(cuda, arch):
    """One fp32 layer of each family that had trained only on the CPU, at
    its published widths cut as chip_smoke.py's [train_family_agreement]
    cuts it (``FAMILY_AGREE``): one forward and backward of ``Model.loss``
    (remat "full", 4 masks, B 4 x S 64 of ``lm_batch`` data) on the card and
    on the CPU from one state, loss and moe_aux within its loss bar, every
    gradient leaf within its gradient bar of the leaf's largest magnitude
    (``TOL_TRAIN_AGREE``; xlstm ``TOL_XLSTM_AGREE``, its exponential
    gates; hubert's input embedding unused on both sides). Then one whole
    train step on the card with the optimizer the published config picks
    (Adafactor without the global clip for phi3.5, arctic and qwen2-vl):
    its loss is the same forward's, and the parameters stay finite."""
    from repro_torch.core import tree as tree_lib
    from repro_torch.data import LMDataConfig, lm_batch
    from repro_torch.launch import dryrun
    from repro_torch.optim import OptimizerConfig, build_optimizer
    from repro_torch.train import TrainConfig as LmTrainConfig
    from repro_torch.train import make_train_step
    cfg = registry.get_config(arch, mask_samples=4, remat="full",
                              dtype=torch.float32,
                              **dict(chip_smoke.FAMILY_AGREE)[arch])
    model = lm_model.build_model(cfg)
    data = LMDataConfig(vocab_size=cfg.vocab_size,
                        seq_len=chip_smoke.FAMILY_AGREE_S,
                        global_batch=chip_smoke.FAMILY_AGREE_B,
                        family="audio" if cfg.family == "audio" else "dense",
                        d_model=cfg.d_model)
    cpu = model.init(torch.Generator().manual_seed(0), device="cpu")
    card = tree_lib.tree_map(lambda t: t.to(cuda, copy=True), cpu)
    l_card, a_card, g_card = chip_smoke.family_loss_and_grads(
        model, card, lm_batch(data, 0, cuda))
    l_cpu, a_cpu, g_cpu = chip_smoke.family_loss_and_grads(
        model, cpu, lm_batch(data, 0, "cpu"))
    tol = (chip_smoke.TOL_XLSTM_AGREE if cfg.family == "ssm"
           else chip_smoke.TOL_TRAIN_AGREE)
    assert abs(l_card - l_cpu) <= tol["loss"] * abs(l_cpu), (l_card, l_cpu)
    assert abs(a_card - a_cpu) <= tol["loss"] * abs(a_cpu), (a_card, a_cpu)
    assert (a_cpu > 0) == bool(cfg.n_experts)
    paths = [p for p, _ in tree_lib.flatten_with_path(cpu)]
    for path, gc, gw in zip(paths, g_card, g_cpu):
        if gw is None:
            assert gc is None and path == ("embed", "embed"), path
            assert cfg.family == "audio"
            continue
        scale = float(gw.abs().max())
        err = float((gc.cpu() - gw).abs().max())
        assert err <= tol["grad"] * scale, (path, err, scale)
    del g_card, g_cpu, cpu
    pick = dryrun.pick_optimizer(registry.get_config(arch))
    opt = build_optimizer(OptimizerConfig(
        name=pick.name, clip_norm=pick.clip_norm, lr=3e-4, warmup_steps=2))
    state = {"params": card, "opt": opt.init(card)}
    state, metrics = make_train_step(model, opt, LmTrainConfig())(
        state, lm_batch(data, 0, cuda))
    assert float(metrics["loss"]) == pytest.approx(l_card, rel=1e-6)
    assert all(bool(torch.isfinite(t).all())
               for t in tree_lib.leaves(state["params"]))


def test_arctic_layer_adafactor_step_fits_on_card(cuda):
    """arctic-480b at one layer of published widths (14.07B bf16
    parameters, 28.1 GB, and as much again in gradients) takes a train step
    with its published optimizer, Adafactor without the global clip. The
    whole-slice update of its [1, 128, 7168, 4864] expert stacks held
    several 17.9 GB fp32 temporaries beside them and ran out of memory
    (74.2 GB allocated when it asked for 16.6 GiB more); the blocked
    update holds a few 1 GB blocks. B 1 x S 512: the parameters and
    gradients set the peak."""
    import gc
    from repro_torch.data import LMDataConfig, lm_batch
    from repro_torch.launch import dryrun
    from repro_torch.optim import OptimizerConfig, build_optimizer
    from repro_torch.train import TrainConfig as LmTrainConfig
    from repro_torch.train import make_train_step, train_state_init
    cfg = registry.get_config("arctic-480b", mask_samples=4, remat="full",
                              n_layers=1)
    pick = dryrun.pick_optimizer(registry.get_config("arctic-480b"))
    assert (pick.name, pick.clip_norm) == ("adafactor", 0.0)
    model = lm_model.build_model(cfg)
    opt = build_optimizer(OptimizerConfig(
        name=pick.name, clip_norm=pick.clip_norm, lr=3e-4, warmup_steps=2))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = train_state_init(model, opt, torch.Generator(cuda).manual_seed(0),
                             device=cuda)
    data = LMDataConfig(vocab_size=cfg.vocab_size, seq_len=512,
                        global_batch=1)
    state, metrics = make_train_step(model, opt, LmTrainConfig())(
        state, lm_batch(data, 0, cuda))
    assert np.isfinite(float(metrics["loss"]))
    peak = torch.cuda.max_memory_allocated()
    assert peak < torch.cuda.get_device_properties(cuda).total_memory
    assert int(state["opt"]["step"]) == 1
    del state, metrics
    gc.collect()
    torch.cuda.empty_cache()


def test_wrappers_refuse_grad_operands_on_card(cuda):
    """The guard holds on CUDA tensors too: no launch, a RuntimeError."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rglru_scan import ops as sops
    a, b = _gates((2, 8, 6), cuda)
    q, k, v = _qkv(1, 2, 1, 8, 16, torch.float32, cuda)
    samples = torch.randn((4, 3, 2), device=cuda)
    before = (sops.rglru_scan.launches, fa_ops.flash_attention.launches,
              moops.moments.launches, mops.masked_ffn.launches)
    calls = (
        lambda: sops.rglru_scan(a.requires_grad_(True), b),
        lambda: sops.rglru_scan_backward(a.detach(), b,
                                         b.clone().requires_grad_(True)),
        lambda: fa_ops.flash_attention(q.requires_grad_(True), k, v),
        lambda: moops.moments(samples.requires_grad_(True)),
        lambda: mops.masked_ffn(
            torch.randn((4, 3), device=cuda, requires_grad=True),
            *(torch.randn(s, device=cuda)
              for s in ((2, 3, 5), (2, 5), (2, 5, 2), (2,)))))
    for call in calls:
        with pytest.raises(RuntimeError, match="requires grad"):
            call()
    assert before == (sops.rglru_scan.launches,
                      fa_ops.flash_attention.launches,
                      moops.moments.launches, mops.masked_ffn.launches)


@pytest.fixture
def card_mesh(cuda, tmp_path):
    """A (1, 1) ("data", "model") mesh over a one-rank NCCL group,
    destroyed after the test."""
    from repro_torch.launch import mesh as mesh_lib
    mesh_lib.init_world(f"file://{tmp_path}/rendezvous", 0, 1)
    try:
        yield mesh_lib.make_mesh((1, 1), ("data", "model"))
    finally:
        torch.distributed.destroy_process_group()


def test_kernels_on_dtensors_launch_on_local_shards(cuda, card_mesh):
    """``flash_attention`` (bf16, GQA) and ``moments`` on DTensors run the
    hand-written kernel on the rank's local tensors: one launch each, the
    output that of the plain-tensor call bit for bit."""
    from torch.distributed.tensor import DTensor, Replicate, distribute_tensor
    from repro_torch.kernels.flash_attention import ops as flash
    rep = (Replicate(), Replicate())
    gen = torch.Generator().manual_seed(0)
    q = _rand(gen, 2, 8, 96, 64).to(cuda, torch.bfloat16)
    k = _rand(gen, 2, 2, 96, 64).to(cuda, torch.bfloat16)
    v = _rand(gen, 2, 2, 96, 64).to(cuda, torch.bfloat16)
    want = flash.flash_attention(q, k, v, causal=True)
    flash.flash_attention.launches = 0
    got = flash.flash_attention(
        *(distribute_tensor(t, card_mesh, rep) for t in (q, k, v)),
        causal=True)
    assert isinstance(got, DTensor) and flash.flash_attention.launches == 1
    assert torch.equal(got.to_local(), want)
    s = _rand(gen, 4, 8, 1000).to(cuda)
    want = moops.moments(s)
    moops.moments.launches = 0
    got = moops.moments(distribute_tensor(s, card_mesh, rep))
    assert moops.moments.launches == 1
    for g, w in zip(got, want):
        assert torch.equal(g.to_local(), w)
