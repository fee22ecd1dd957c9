"""int8 serving in the port against the JAX package, on the CPU.

Two halves, as in the reference's ``tests/test_quantized.py``:

* int8 weights (``Precision("int8")``): the quantizers are bit-equal to the
  reference's on the same fp32 input (int8 values and bf16 scales); the
  int8 lowering has the reference's slots, dtypes and shapes; and the port's
  per-op and fused executors (samples and moments) match the reference's
  XLA tier within 2e-4 — the reference's own int8 fused-vs-per-op bar. The
  ``ivim`` and ``ffn`` families are covered with N in {1, 4, 8}; the ``mlp``
  family waits for the port's ``core/transform.py``.
* the int8 KV cache (``kv_dtype="int8"``): ``quantize_kv`` is bit-equal;
  ``prefill`` and ``decode_step`` at ``smoke_config("qwen2-1.5b",
  n_layers=2)`` (weights from ``transformer.params_from_jax``) give the
  reference's caches, scale leaves and logits.

Parity of int8 outputs across frameworks feeds both quantizers the SAME
fp32 weights: the port takes the reference plan's own folded parameters
(``plan.params_from_jax``). Folding BN on each side can move a weight by an
ulp, which near a rounding tie moves its int8 value by one step — about
amax/127, far beyond 2e-4 downstream; that count is printed by
``test_int8_values_when_each_side_folds``, not gated.

The port runs its plain versions here (the CUDA kernels are held to them on
the card by tests/test_torch_cuda.py and chip_smoke.py).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as j_registry
from repro.core import masks as j_masks
from repro.core import plan as j_plan
from repro.distributed import compression as j_comp
from repro.ivim import model as j_ivim
from repro.kernels.fused_plan import ref as j_fref
from repro.kernels.masked_ffn import ref as j_mref
from repro.models import build_model as j_build_model
from repro.models import layers as j_layers
from repro.models import transformer as j_transformer
from repro_torch.configs import registry as t_registry
from repro_torch.core import plan as t_plan
from repro_torch.core import uncertainty as t_unc
from repro_torch.distributed import compression as t_comp
from repro_torch.ivim import model as t_ivim
from repro_torch.kernels.fused_plan import ops as t_fops
from repro_torch.kernels.fused_plan import ref as t_fref
from repro_torch.kernels.masked_ffn import ops as t_mops
from repro_torch.models import layers as t_layers
from repro_torch.models import model as t_lm
from repro_torch.models import transformer as t_transformer
from repro_torch.serving import engine as t_engine
from repro_torch.serving import server as t_server

CPU = "cpu"
NS = (1, 4, 8)
TOL = 2e-4          # the reference's int8 fused-vs-per-op tolerance
TOL_LM = 1e-5       # one fp32 forward pass, sums in another order
# the reference's int8-vs-fp32 drift bounds (tests/test_quantized.py)
FP32_TOL = {"ivim": 2e-2, "ffn": 0.8}
J_INT8 = j_plan.Precision(weights="int8")
T_INT8 = t_plan.Precision(weights="int8")


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy() if a.dtype == torch.bfloat16 \
            else a.detach().numpy()
    return np.asarray(a, np.float32) if a.dtype == jnp.bfloat16 \
        else np.asarray(a)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(_np(got), np.float32),
                               np.asarray(_np(want), np.float32),
                               rtol=tol, atol=tol)


def _bits_equal(got: torch.Tensor, want) -> None:
    """Same dtype family and the same bits (bf16 compared as its values,
    which are exact in fp32)."""
    want = np.asarray(want) if not (hasattr(want, "dtype")
                                    and want.dtype == jnp.bfloat16) \
        else np.asarray(want, np.float32)
    got = _np(got)
    assert got.shape == want.shape
    assert np.array_equal(got, want), \
        f"{int((got != want).sum())} of {got.size} differ"


# ---------------------------------------------------------------------------
# the quantizers: bit-equal on the same fp32 input
# ---------------------------------------------------------------------------


def _weights(seed, shape, scale=0.3):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=shape) * scale).astype(np.float32)
    w.reshape(-1)[::7] = 0.0                      # exact zeros
    w.reshape(-1)[3::11] *= 40.0                  # a few outliers per row
    return w


@pytest.mark.parametrize("shape", [(5, 13), (3, 4, 104), (2, 3, 7, 1),
                                   (1, 1)])
def test_quantize_int8_bit_equal(shape):
    x = _weights(sum(shape), shape)
    q_t, s_t = t_comp.quantize_int8(torch.from_numpy(x))
    q_j, s_j = j_comp.quantize_int8(x)
    assert q_t.dtype == torch.int8 and s_t.dtype == torch.float32
    _bits_equal(q_t, q_j)
    _bits_equal(s_t, s_j)
    _close(t_comp.dequantize_int8(q_t, s_t), j_comp.dequantize_int8(q_j, s_j),
           0.0)


def test_quantize_int8_ties_round_half_to_even():
    """Values exactly half-way between two int8 steps round to even, as
    ``jnp.round`` does (a multiply by the reciprocal would miss these)."""
    row = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -3.5, 126.5]], np.float32)
    q_t, _ = t_comp.quantize_int8(torch.from_numpy(row))
    q_j, _ = j_comp.quantize_int8(row)
    _bits_equal(q_t, q_j)
    assert q_t.tolist() == [[127, 0, 2, 2, 0, -4, 126]]


@pytest.mark.parametrize("shape", [(104, 52), (8, 104, 52), (32, 52, 1),
                                   (4, 11, 6)])
def test_quantize_weight_bit_equal(shape):
    w = _weights(7 + len(shape), shape)
    q_t, s_t = t_plan._quantize_weight(torch.from_numpy(w))
    q_j, s_j = j_plan._quantize_weight(w)
    assert q_t.dtype == torch.int8 and s_t.dtype == torch.bfloat16
    assert tuple(s_t.shape) == shape[:-2] + (1, shape[-1]) == s_j.shape
    _bits_equal(q_t, q_j)
    _bits_equal(s_t, s_j)
    _bits_equal(t_plan._dequantized(torch.from_numpy(w)),
                j_plan._dequantized(w))
    b = w[..., 0, :]
    _bits_equal(t_plan._low_bias(torch.from_numpy(b)), j_plan._low_bias(b))


@pytest.mark.parametrize("shape", [(3, 2, 9, 16), (4, 2, 1, 16)])
def test_quantize_kv_bit_equal(shape):
    x = _weights(3, shape, scale=1.5)
    q_t, s_t = t_layers.quantize_kv(torch.from_numpy(x))
    q_j, s_j = j_layers.quantize_kv(x)
    assert q_t.dtype == torch.int8 and s_t.dtype == torch.float32
    assert tuple(s_t.shape) == shape[:-1]
    _bits_equal(q_t, q_j)
    _bits_equal(s_t, s_j)


# ---------------------------------------------------------------------------
# plans: the same fp32 (folded) weights on both sides
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _ivim_plans(n_masks, seed=0):
    """The reference's IVIM plan (its own init with non-trivial BN
    statistics drawn by numpy, BN folded by the reference) and the port's
    plan of the same model holding the reference plan's folded parameters;
    also the port's own plan (BN folded by the port)."""
    jcfg = j_ivim.IvimConfig(n_masks=n_masks, scale=2.0)
    params, state = jax.tree.map(np.array, j_ivim.init(
        jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 1)
    for bn in ("bn1", "bn2"):
        shape = state[bn]["mean"].shape
        state[bn]["mean"] = (0.2 * rng.normal(size=shape)).astype(np.float32)
        state[bn]["var"] = (0.5 + rng.uniform(size=shape)).astype(np.float32)
        params[bn]["gamma"] = (0.5 + rng.uniform(size=shape)).astype(
            np.float32)
        params[bn]["beta"] = (0.1 * rng.normal(size=shape)).astype(np.float32)
    x = rng.uniform(0.2, 1.1, size=(6, jcfg.width)).astype(np.float32)
    jp = j_plan.compile_ivim(jcfg, params, state)
    tcfg = t_ivim.IvimConfig(n_masks=n_masks, scale=2.0)
    model = t_ivim.params_from_jax(tcfg, params, state, device=CPU)
    own = t_ivim.pack_for_serving(model)
    tp = t_plan.params_from_jax(own, jax.tree.map(np.asarray, jp.params),
                                device=CPU)
    return jp, tp, own, x


@functools.lru_cache(maxsize=None)
def _ffn_plans(n_masks, seed=0):
    d, f, d2 = 8, 24, 8
    rng = np.random.default_rng(seed)
    w1 = (rng.normal(size=(d, f)) * 0.3).astype(np.float32)
    b1 = (rng.normal(size=f) * 0.1).astype(np.float32)
    w2 = (rng.normal(size=(f, d2)) * 0.3).astype(np.float32)
    b2 = (rng.normal(size=d2) * 0.1).astype(np.float32)
    masks = j_masks.generate_masks(j_masks.MaskSpec(width=f, n_masks=n_masks,
                                                    scale=2.0))
    x = rng.normal(size=(10, d)).astype(np.float32)
    jp = j_plan.compile_masked_ffn(w1, b1, w2, b2, masks)
    tp = t_plan.compile_masked_ffn(*map(torch.from_numpy, (w1, b1, w2, b2)),
                                   masks)
    return jp, tp, tp, x


FAMILIES = {"ivim": _ivim_plans, "ffn": _ffn_plans}


def test_int8_lowering_carries_scale_slots():
    """The reference's test_int8_lowering_carries_scale_slots, port and
    reference side by side: the same slots, dtypes and shapes, and the
    same bits in every int8 weight, scale and bias."""
    for family in FAMILIES:
        jp, tp, _, _ = FAMILIES[family](4)
        j_spec, j_params = j_plan.lower_fused(jp.with_precision(J_INT8))
        t_spec, t_params = t_plan.lower_fused(tp.with_precision(T_INT8))
        slots = t_fref.param_slots(t_spec)
        assert slots == j_fref.param_slots(j_spec)
        assert "ws" in [s for _, s in slots]
        assert all(st.w_dtype == "int8" for st in t_spec.steps
                   if st.kind == "dense")
        table = dict(zip(slots, t_params))
        for (i, kind), arr in table.items():
            if kind == "w":
                assert arr.dtype == torch.int8
                ws = table[(i, "ws")]
                assert ws.dtype == torch.bfloat16
                assert ws.shape == arr.shape[:-2] + (1, arr.shape[-1])
            elif kind in ("b", "bp"):
                assert arr.dtype == torch.bfloat16
        for t, j in zip(t_params, j_params):
            _bits_equal(t, j)


def test_fp32_default_lowers_without_scales():
    """The fp32 default is untouched: no 'ws' slot, no w_dtype, the master
    tensors themselves, and the same spec as a plan that never named a
    precision."""
    for family in FAMILIES:
        _, tp, _, _ = FAMILIES[family](4)
        spec, params = t_plan.lower_fused(tp)
        assert all(kind != "ws" for _, kind in t_fref.param_slots(spec))
        assert all(st.w_dtype == "" for st in spec.steps)
        assert all(p.dtype == torch.float32 for p in params)
        masters = {id(t) for d in tp.params.values() for t in d.values()}
        assert all(id(p) in masters for p in params)
        same, _ = t_plan.lower_fused(tp.with_precision(t_plan.Precision()))
        assert same == spec
        q_spec, _ = t_plan.lower_fused(tp.with_precision(T_INT8))
        assert q_spec != spec
        fp = t_fops.pack(spec, params)
        assert fp.qflat is None and fp.sflat is None
    with pytest.raises(ValueError, match="unknown weight precision"):
        t_plan.Precision("bf16")


@pytest.mark.parametrize("n_masks", NS)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_int8_execute_matches_reference(family, n_masks):
    """Per-op samples, fused samples and fused moments at int8 against the
    reference's XLA tier, on the same folded weights."""
    jp, tp, _, x = FAMILIES[family](n_masks)
    jq, tq = jp.with_precision(J_INT8), tp.with_precision(T_INT8)
    xt = torch.from_numpy(x)
    want = np.asarray(j_plan.execute(jq, x, backend="xla"))
    _close(t_plan.execute(tq, xt, device=CPU), want)
    _close(t_plan.execute_fused(tq, xt, device=CPU),
           j_plan.execute_fused(jq, x, backend="xla"))
    _close(t_plan.execute_fused(tq, xt, device=CPU), want)
    j_mean, j_std = j_plan.execute_fused(jq, x, moments=True, backend="xla")
    t_mean, t_std = t_plan.execute_fused(tq, xt, moments=True, device=CPU)
    _close(t_mean, j_mean)
    _close(t_std, j_std)
    p_mean, p_std = t_unc.predictive_moments(t_plan.execute(tq, xt,
                                                            device=CPU))
    _close(t_mean, p_mean)
    _close(t_std, p_std)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_int8_close_to_fp32(family):
    _, tp, _, x = FAMILIES[family](4)
    xt = torch.from_numpy(x)
    y_f = t_plan.execute(tp, xt, device=CPU)
    y_q = t_plan.execute(tp.with_precision(T_INT8), xt, device=CPU)
    drift = float((y_q - y_f).abs().max())
    assert 0 < drift <= FP32_TOL[family], f"{family}: int8 drift {drift}"


def test_int8_per_op_quantizes_once_per_plan():
    """The per-op executor quantizes a plan's weights once and serves every
    call from them (the values of a fresh quantization)."""
    _, tp, _, x = _ivim_plans(4)
    tq = tp.with_precision(T_INT8)
    xt = torch.from_numpy(x)
    first = t_plan.execute(tq, xt, device=CPU)
    cached = dict(t_plan._INT8_LEAVES[tq])
    assert ("body", "w1p", "q") in cached
    second = t_plan.execute(tq, xt, device=CPU)
    assert torch.equal(first, second)
    assert all(t_plan._INT8_LEAVES[tq][k] is v for k, v in cached.items())
    q, s = cached[("body", "w1p", "q")]
    q2, s2 = t_plan._quantize_weight(tq.params["body"]["w1p"])
    assert torch.equal(q, q2) and torch.equal(s, s2)


def test_int8_per_op_hands_masked_ffn_int8_operands(monkeypatch):
    """The relu pair on a shared input reaches the masked_ffn wrapper with
    the int8 weights, their bf16 scales and bf16 biases."""
    seen = []
    real = t_mops.masked_ffn

    def spy(*args):
        seen.append([a.dtype for a in args])
        return real(*args)

    monkeypatch.setattr(t_mops, "masked_ffn", spy)
    _, tp, _, x = _ffn_plans(4)
    t_plan.execute(tp.with_precision(T_INT8), torch.from_numpy(x),
                   device=CPU)
    t_plan.execute(tp, torch.from_numpy(x), device=CPU)
    i8, bf, f32 = torch.int8, torch.bfloat16, torch.float32
    assert seen == [[f32, i8, bf, i8, bf, bf, bf], [f32] * 5]


def test_int8_values_when_each_side_folds():
    """Not a gate: how many int8 weight values differ when the port folds
    BN itself (``torch.rsqrt``) instead of taking the reference's folded
    weights. One ulp near a rounding tie moves a value by one step."""
    for n in NS:
        jp, _, own, _ = _ivim_plans(n)
        _, j_params = j_plan.lower_fused(jp.with_precision(J_INT8))
        _, t_params = t_plan.lower_fused(own.with_precision(T_INT8))
        diff = total = 0
        for t, j in zip(t_params, j_params):
            if t.dtype == torch.int8:
                diff += int((_np(t) != np.asarray(j)).sum())
                total += t.numel()
        print(f"N={n}: {diff} of {total} int8 weight values differ when "
              f"each side folds BN itself")
        assert total > 0


def test_masked_ffn_ref_int8_matches_reference():
    rng = np.random.default_rng(5)
    n, b, d, k, d2 = 3, 7, 9, 5, 4
    x = rng.normal(size=(b, d)).astype(np.float32)
    w1 = (rng.normal(size=(n, d, k)) * 0.4).astype(np.float32)
    w2 = (rng.normal(size=(n, k, d2)) * 0.4).astype(np.float32)
    b1 = (rng.normal(size=(n, k)) * 0.1).astype(np.float32)
    b2 = (rng.normal(size=d2) * 0.1).astype(np.float32)
    jq1, js1 = j_plan._quantize_weight(w1)
    jq2, js2 = j_plan._quantize_weight(w2)
    want = j_mref.masked_ffn_ref(x, jq1, j_plan._low_bias(b1), jq2,
                                 j_plan._low_bias(b2), js1, js2)
    tq1, ts1 = t_plan._quantize_weight(torch.from_numpy(w1))
    tq2, ts2 = t_plan._quantize_weight(torch.from_numpy(w2))
    args = (torch.from_numpy(x), tq1, t_plan._low_bias(torch.from_numpy(b1)),
            tq2, t_plan._low_bias(torch.from_numpy(b2)), ts1, ts2)
    got = t_mops.masked_ffn(*args)          # a CPU tensor: the plain version
    assert got.dtype == torch.float32
    _close(got, want, TOL_LM)
    with pytest.raises(ValueError, match="together"):
        t_mops.masked_ffn(*args[:6])


def test_fused_ref_int8_with_shared_prefix_matches_reference():
    """A chain with a shared int8 prefix, bare activations, shared and
    per-row biases: the plain int8 versions against the reference's."""
    def spec_of(lib):
        s = lib.FusedStep
        return lib.FusedSpec(
            (s("dense", "tanh", shared_bias=True, d_in=7, d_out=12,
               w_dtype="int8"),
             s("act", "gelu"),
             s("dense", None, per_sample=True, shared_bias=True,
               sample_bias=True, d_in=12, d_out=9, w_dtype="int8"),
             s("act", "silu"),
             s("dense", "relu", shared_bias=True, d_in=9, d_out=5,
               w_dtype="int8"),
             s("dense", "sigmoid", per_sample=True, d_in=5, d_out=3,
               w_dtype="int8")), 6, 3, 2, 7, 3)

    t_spec, j_spec = spec_of(t_fref), spec_of(j_fref)
    assert t_fref.param_slots(t_spec) == j_fref.param_slots(j_spec)
    rng = np.random.default_rng(6)
    j_params, t_params = [], []
    for i, slot in j_fref.param_slots(j_spec):
        st = j_spec.steps[i]
        lead = (j_spec.n_rows,) if st.per_sample else ()
        if slot == "ws":
            continue
        shape = {"w": lead + (st.d_in, st.d_out), "b": (st.d_out,),
                 "bp": (j_spec.n_rows, st.d_out)}[slot]
        a = (rng.normal(size=shape) * 0.5).astype(np.float32)
        if slot == "w":
            jq, js = j_plan._quantize_weight(a)
            tq, ts = t_plan._quantize_weight(torch.from_numpy(a))
            j_params += [jq, js]
            t_params += [tq, ts]
        else:
            j_params.append(j_plan._low_bias(a))
            t_params.append(t_plan._low_bias(torch.from_numpy(a)))
    x = rng.uniform(size=(11, 7)).astype(np.float32)
    xt = torch.from_numpy(x)
    _close(t_fref.fused_plan_ref(t_spec, xt, tuple(t_params)),
           j_fref.fused_plan_ref(j_spec, x, tuple(j_params)), TOL_LM)
    fp = t_fops.pack(t_spec, tuple(t_params))
    assert fp.qflat.dtype == torch.int8 and fp.sflat.dtype == torch.bfloat16
    slots = t_fref.param_slots(t_spec)
    assert fp.flat.numel() == sum(p.numel() for (_, k), p in
                                  zip(slots, t_params) if k in ("b", "bp"))
    for got, want in zip(t_fops.fused_moments(fp, xt),
                         t_fref.fused_moments_ref(t_spec, xt,
                                                  tuple(t_params))):
        _close(got, want, 0.0)


def test_fused_pack_refuses_widened_int8_weights():
    _, tp, _, _ = _ffn_plans(4)
    spec, params = t_plan.lower_fused(tp.with_precision(T_INT8))
    widened = tuple(p.float() if p.dtype == torch.int8 else p for p in params)
    with pytest.raises(TypeError, match="int8"):
        t_fops.pack(spec, widened)


# ---------------------------------------------------------------------------
# pricing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bpe", (2, 4))
def test_plan_traffic_matches_reference(bpe):
    """PackedPlan.traffic at both precisions, fused and per-op, equals the
    reference's numbers, and the int8 fused IVIM plan models <= 0.35x the
    fp32 weight bytes (the reference's test_int8_weight_bytes_gate)."""
    for family in FAMILIES:
        jp, tp, _, _ = FAMILIES[family](4)
        for j, t in ((jp, tp), (jp.with_precision(J_INT8),
                                tp.with_precision(T_INT8))):
            for fused in (False, True):
                assert dataclasses.asdict(t.traffic(
                    512, bpe, fused=fused, moments=fused)) == \
                    dataclasses.asdict(j.traffic(512, bpe, fused=fused,
                                                 moments=fused))
    _, tp, _, _ = _ivim_plans(4)
    tq = tp.with_precision(T_INT8)
    for fused in (True, False):
        t_f = tp.traffic(512, 4, fused=fused, moments=fused)
        t_q = tq.traffic(512, 4, fused=fused, moments=fused)
        assert t_q.weight_bytes / t_f.weight_bytes <= 0.35
        assert (t_q.act_bytes, t_q.flops) == (t_f.act_bytes, t_f.flops)


# ---------------------------------------------------------------------------
# the int8 KV cache
# ---------------------------------------------------------------------------


def _cfgs(**overrides):
    return (j_registry.smoke_config("qwen2-1.5b", n_layers=2, **overrides),
            t_registry.smoke_config("qwen2-1.5b", n_layers=2, **overrides))


@pytest.fixture(scope="module")
def qwen8():
    jcfg, tcfg = _cfgs(kv_dtype="int8")
    jp = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    tp = t_transformer.params_from_jax(tcfg, jax.tree.map(np.asarray, jp),
                                       device=CPU)
    return jcfg, tcfg, jp, tp


def _leaves(caches):
    """Cache leaves by path, the port's and the reference's alike."""
    out = {}
    for si, seg in enumerate(caches):
        for b, leaves in seg.items():
            for name, leaf in leaves.items():
                out[(si, b, name)] = _np(leaf)
    return out


def _caches_close(got, want):
    """int8 k/v: the dequantized vectors within TOL_LM plus one int8 step
    (fp32 k/v computed in another order may round to the neighbouring step
    at a tie); scales and positions within TOL_LM / exact."""
    g, w = _leaves(got), _leaves(want)
    assert g.keys() == w.keys()
    for key in g:
        assert g[key].shape == w[key].shape and g[key].dtype == w[key].dtype
    steps = 0
    for (si, b, name) in g:
        if name == "kpos":
            assert np.array_equal(g[(si, b, name)], w[(si, b, name)])
        elif name in ("kscale", "vscale"):
            _close(g[(si, b, name)], w[(si, b, name)], TOL_LM)
        else:
            sc = w[(si, b, name[0] + "scale")][..., None]
            dq_g = g[(si, b, name)].astype(np.float32) * sc
            dq_w = w[(si, b, name)].astype(np.float32) * sc
            assert np.all(np.abs(dq_g - dq_w) <= sc + TOL_LM)
            steps += int((g[(si, b, name)] != w[(si, b, name)]).sum())
    return steps


def test_int8_kv_cache_leaves(qwen8):
    jcfg, tcfg, _, _ = qwen8
    got = t_transformer.init_cache(tcfg, 4, 8, device=CPU)
    want = j_transformer.init_cache(jcfg, 4, 8)
    g, w = _leaves(got), _leaves(want)
    assert g.keys() == w.keys()
    for k in g:
        assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k])
    specs = t_transformer.cache_specs(tcfg, 4, 8)
    for seg, sseg in zip(got, specs):
        for b in seg:
            for name, t in seg[b].items():
                assert (tuple(t.shape), t.dtype) == sseg[b][name]
    assert got[0]["b0"]["k"].dtype == torch.int8
    assert got[0]["b0"]["kscale"].shape == got[0]["b0"]["k"].shape[:-1]


def test_int8_kv_prefill_and_decode_match_reference(qwen8):
    jcfg, tcfg, jp, tp = qwen8
    rng = np.random.default_rng(4)
    b, plen, max_seq = 4, 6, 12
    toks = rng.integers(0, tcfg.vocab_size, (b, plen)).astype(np.int32)
    ids = np.arange(b, dtype=np.int32) % tcfg.mask_samples
    j_logits, j_caches = j_transformer.prefill(
        jcfg, jp, {"tokens": jnp.asarray(toks)}, max_seq=max_seq,
        mask_ids=jnp.asarray(ids))
    t_logits, t_caches = t_transformer.prefill(
        tcfg, tp, {"tokens": torch.from_numpy(toks)}, max_seq=max_seq,
        mask_ids=torch.from_numpy(ids))
    _close(t_logits, j_logits, TOL_LM)
    flips = _caches_close(t_caches, j_caches)
    assert _leaves(t_caches)[(0, "b0", "kscale")][..., plen:].max() == 0
    # decode two steps from the reference's caches, so each step starts
    # from the same int8 state; per-row positions on the second
    caches_t = jax.tree.map(
        lambda a: torch.from_numpy(np.array(a)), j_caches)
    for step, pos in enumerate((np.int32(plen),
                                np.array([7, 6, 7, 6], np.int32))):
        tok = rng.integers(0, tcfg.vocab_size, (b, 1)).astype(np.int32)
        j_logits, j_caches = j_transformer.decode_step(
            jcfg, jp, j_caches, jnp.asarray(tok), jnp.asarray(pos),
            mask_ids=jnp.asarray(ids))
        t_logits, caches_t = t_transformer.decode_step(
            tcfg, tp, caches_t, torch.from_numpy(tok), torch.as_tensor(pos),
            mask_ids=torch.from_numpy(ids))
        _close(t_logits, j_logits, TOL_LM)
        flips += _caches_close(caches_t, j_caches)
        caches_t = jax.tree.map(
            lambda a: torch.from_numpy(np.array(a)), j_caches)
    print(f"int8 k/v values one step apart from the reference: {flips}")


def test_int8_kv_update_writes_scales():
    rng = np.random.default_rng(8)
    cache = t_layers.init_kv_cache(3, 2, 5, 4, torch.float32, "int8")
    k = torch.from_numpy(rng.normal(size=(3, 2, 1, 4)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(3, 2, 1, 4)).astype(np.float32))
    pos = torch.tensor([0, 3, 7], dtype=torch.int32)
    new = t_layers.kv_cache_update(cache, k, v, pos)
    jnew = j_layers.kv_cache_update(
        j_layers.init_kv_cache(3, 2, 5, 4, jnp.float32, "int8"),
        k.numpy(), v.numpy(), pos.numpy())
    assert set(new) == set(jnew)
    for name in new:
        _bits_equal(new[name], jnew[name])
    assert float(cache["kscale"].abs().max()) == 0       # functional
    q = torch.from_numpy(rng.normal(size=(3, 4, 1, 4)).astype(np.float32))
    _close(t_layers.attention_decode(q, new["k"], new["v"], new["kpos"], pos,
                                     new["kscale"], new["vscale"]),
           j_layers.attention_decode(q.numpy(), jnew["k"], jnew["v"],
                                     jnew["kpos"], pos.numpy(),
                                     jnew["kscale"], jnew["vscale"]), TOL_LM)


def test_cache_trim_clears_scale_leaves(qwen8):
    _, tcfg, _, tp = qwen8
    toks = torch.randint(0, tcfg.vocab_size, (4, 5),
                         generator=torch.Generator().manual_seed(0))
    _, caches = t_transformer.prefill(tcfg, tp, {"tokens": toks},
                                      max_seq=10)
    trimmed = t_transformer.cache_trim_positions(caches, 3)
    for seg in trimmed:
        for leaves in seg.values():
            for name in ("kscale", "vscale"):
                assert bool((leaves[name][..., 3:] == 0).all())
                assert bool((leaves[name][..., :3] != 0).any())
            assert bool((leaves["k"][..., 3:, :] == 0).all())


def test_int8_kv_has_no_fused_lowering_and_serves_per_op(qwen8):
    _, tcfg, _, tp = qwen8
    with pytest.raises(t_plan.FusedPlanUnsupported, match="int8 KV"):
        t_plan.lower_fused_decode(tcfg)
    fns = t_server.step_fns(tcfg, device=CPU)
    assert fns.fused_spec is None and not fns.fused_live()
    assert t_server.fallback_counts[("build", "decode")] >= 1
    prompts = torch.randint(0, tcfg.vocab_size, (3, 6),
                            generator=torch.Generator().manual_seed(1))
    gen, unc, _ = t_engine.serve_uncertain(
        t_lm.build_model(tcfg), tp, prompts,
        t_engine.ServeConfig(max_new_tokens=4), device=CPU)
    assert gen.shape == (3, 10) and bool(torch.isfinite(unc).all())
    assert fns.counts["decode_per_op"] >= 4
    assert fns.counts.get("decode_fused", 0) == 0


def test_int8_kv_decode_tokens_match_fp32_cache(qwen8):
    """The reference's test_per_op_decode_low_precision_kv on the port:
    the int8 cache emits the fp32 cache's greedy tokens at smoke size, with
    rel-uncertainty within the reference's 5e-4."""
    _, tcfg, _, tp = qwen8
    prompts = torch.randint(0, tcfg.vocab_size, (3, 6),
                            generator=torch.Generator().manual_seed(1))
    outs = [t_engine.serve_uncertain(
        t_lm.build_model(c), tp, prompts,
        t_engine.ServeConfig(max_new_tokens=4, fused=False), device=CPU)
        for c in (dataclasses.replace(tcfg, kv_dtype=""), tcfg)]
    assert torch.equal(outs[0][0], outs[1][0])
    _close(outs[1][1], outs[0][1], 5e-4)


def test_decode_stage_traffic_int8_matches_reference(qwen8):
    """Stage pricing at every kv_dtype equals the reference's and sums to
    decode_traffic; int8 prices 1-byte k/v plus an fp32 scale per cached
    vector. The int8 spec is the bf16 one retagged: no fused lowering
    exists to produce it."""
    for kvd in ("", "bfloat16", "int8"):
        jcfg, tcfg = _cfgs(packed_ffn_serving=False)
        j_spec = dataclasses.replace(j_plan.decode_fused_spec(jcfg),
                                     kv_dtype=kvd)
        t_spec = dataclasses.replace(t_plan.decode_fused_spec(tcfg),
                                     kv_dtype=kvd)
        for bpe in (2, 4):
            want = j_plan.decode_stage_traffic(j_spec, 16, 24, bpe)
            got = t_plan.decode_stage_traffic(t_spec, 16, 24, bpe)
            assert got.keys() == want.keys()
            for kind in got:
                assert dataclasses.asdict(got[kind]) == \
                    dataclasses.asdict(want[kind]), (kvd, bpe, kind)
            total = t_plan.decode_traffic(t_spec, 16, 24, bpe)
            for field in ("weight_bytes", "act_bytes", "flops",
                          "weight_loads"):
                assert sum(getattr(t, field) for t in got.values()) == \
                    getattr(total, field)
