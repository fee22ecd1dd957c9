"""The last two arms of the flash kernel against the JAX package, on the CPU:
causal attention at Sq != Skv and head widths above 256.

The port's ``flash_attention`` runs its plain version here (a CPU tensor);
the reference is its Pallas kernel ``flash_attention_pallas`` in interpret
mode, at block-aligned shapes (the kernel's own contract: ``ops.py`` pads).
Both mask causally top-left: row i sees keys j <= i, so a row i >= Skv
sees every key. The CUDA kernel is held to the same plain version on the
card by tests/test_torch_cuda.py and chip_smoke.py.

Inputs are made from numpy seeds. Tolerances:
  * fp32: 2e-5 (TOL_ATTN, as tests/test_torch_hybrid.py: one softmax,
    sums in another order than XLA's);
  * bf16: one bf16 ulp of the reference's value plus 2^-8 max|v| (the
    kernel rounds the unnormalized p to bf16 before p.v, the plain
    version the normalized one: the two differ by up to half a bf16 ulp of
    each p, summed against v);
  * the prefill at ``head_dim`` 320: 1e-5 on the logits, as
    tests/test_torch_lm.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as j_registry
from repro.kernels.flash_attention import kernel as j_fkernel
from repro.models import build_model as j_build_model
from repro.models import transformer as j_transformer
from repro_torch.configs import registry as t_registry
from repro_torch.kernels.flash_attention import ops as t_fops
from repro_torch.models import transformer as t_transformer

TOL_ATTN = 2e-5
TOL = 1e-5
BF16_V_SHARE = 2.0 ** -8
BLOCK = 128


def _qkv(b, h, hkv, sq, skv, dh, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(b, n, s, dh)).astype(np.float32)
                 for n, s in ((h, sq), (hkv, skv), (hkv, skv)))


def _both(q, k, v, dtype, causal):
    """The port's plain version and the reference's kernel in interpret
    mode on the same inputs in ``dtype``, both as fp32 numpy."""
    tq, tk, tv = (torch.from_numpy(t).to(getattr(torch, dtype))
                  for t in (q, k, v))
    got = t_fops.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    jq, jk, jv = (jnp.asarray(t, getattr(jnp, dtype)) for t in (q, k, v))
    want = j_fkernel.flash_attention_pallas(
        jq, jk, jv, causal=causal, block_q=BLOCK, block_k=BLOCK,
        interpret=True)
    return (got.float().numpy(), np.asarray(want, np.float32),
            tv.float().numpy())


def _check(got, want, v, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=TOL_ATTN, atol=TOL_ATTN)
        return
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    err = np.abs(got - want)
    assert (err <= ulp + BF16_V_SHARE * np.abs(v).max()).all(), err.max()


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("h,hkv", [(4, 2), (4, 1)])
@pytest.mark.parametrize("sq,skv", [(128, 256), (256, 128)])
def test_causal_at_unequal_lengths_matches_pallas(sq, skv, h, hkv, dtype):
    """GQA 4/2 and MQA 4/1: a short query block against a long key axis
    (every row's keys end inside the first tile), and a long one against a
    short axis (rows past Skv see every key)."""
    q, k, v = _qkv(1, h, hkv, sq, skv, 64, seed=sq + 3 * h + hkv)
    got, want, vv = _both(q, k, v, dtype, causal=True)
    _check(got, want, vv, dtype)


def test_causal_at_unequal_lengths_is_top_left():
    """Row i of a causal block sees keys 0..i whatever Skv is: the first
    Sq rows over Skv keys equal the same rows over only the first Sq keys,
    and a row past Skv equals full attention over every key."""
    q, k, v = (torch.from_numpy(t) for t in _qkv(1, 2, 1, 96, 160, 32, 5))
    short = t_fops.flash_attention(q, k[:, :, :96].contiguous(),
                                   v[:, :, :96].contiguous(), causal=True)
    torch.testing.assert_close(t_fops.flash_attention(q, k, v, causal=True),
                               short, rtol=TOL_ATTN, atol=TOL_ATTN)
    q2, k2, v2 = (torch.from_numpy(t) for t in _qkv(1, 2, 1, 160, 96, 32, 6))
    got = t_fops.flash_attention(q2, k2, v2, causal=True)
    full = t_fops.flash_attention(q2[:, :, 96:].contiguous(), k2, v2,
                                  causal=False)
    torch.testing.assert_close(got[:, :, 96:], full, rtol=TOL_ATTN,
                               atol=TOL_ATTN)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("causal", (True, False))
@pytest.mark.parametrize("dh", (264, 320, 512))
def test_wide_heads_match_pallas(dh, causal, dtype):
    """Head widths above 256 (the card's wide arm): 264 is one bf16 slice
    of 256 and a ragged second of 8 columns, 512 two whole slices; GQA
    4/2."""
    q, k, v = _qkv(1, 4, 2, 128, 128, dh, seed=dh + causal)
    got, want, vv = _both(q, k, v, dtype, causal)
    _check(got, want, vv, dtype)


def test_prefill_at_head_dim_320_matches_jax(monkeypatch):
    """A smoke-size dense model with ``head_dim`` 320: every causal prefill
    layer calls the flash wrapper at dh 320 (on the card, its wide arm),
    and the logits and caches agree with the reference's prefill."""
    over = dict(n_layers=2, head_dim=320)
    jcfg = j_registry.smoke_config("qwen2-1.5b", **over)
    tcfg = t_registry.smoke_config("qwen2-1.5b", **over)
    jp = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    tp = t_transformer.params_from_jax(tcfg, jax.tree.map(np.asarray, jp),
                                       device="cpu")
    widths, plain = [], t_fops.flash_attention
    monkeypatch.setattr(
        t_transformer.flash_ops, "flash_attention",
        lambda q, *a, **kw: widths.append(q.shape[-1]) or plain(q, *a, **kw))
    toks = np.random.default_rng(9).integers(0, 256, size=(2, 11)) \
        .astype(np.int32)
    jl, jc = j_transformer.prefill(jcfg, jp, {"tokens": toks}, max_seq=14)
    tl, tc = t_transformer.prefill(tcfg, tp, {"tokens": torch.from_numpy(
        toks)}, max_seq=14)
    assert widths == [320, 320]
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                               atol=TOL)
    got = jax.tree.leaves(jax.tree.map(
        np.asarray, tc, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    want = jax.tree.leaves(jc)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, np.asarray(w), rtol=TOL, atol=TOL)
