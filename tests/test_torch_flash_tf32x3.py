"""The fp32 flash kernels' arithmetic, 3xTF32 on the tensor cores, held to
the JAX package's flash kernel on the CPU.

``csrc/flash_attention.cu`` runs both fp32 products of its online softmax
(QK^T and p.v) as three tf32 products of split operands: hi = rna(x) and
lo = rna(x - hi), where rna is cvt.rna.tf32.f32 (to nearest on the 13
dropped mantissa bits, ties away from zero), and a.b = lo.hi + hi.lo +
hi.hi with fp32 sums, the small terms first. No card runs here, so this
file models that arithmetic in plain PyTorch (``flash_model``: the
kernel's key tiles, scores divided by sqrt(dh) after the product and
masked at -1e30, fp32 m and l, l summing the fp32 p, acc / max(l, 1e-30))
and holds it to ``flash_attention_pallas`` run as the JAX package's own
CPU tests run it (interpret mode), on numpy inputs from a seed, at
``TOL_FLASH_F32``: the bar the kernel meets on the card
(tests/test_torch_cuda.py, chip_smoke.py). The wide arm (dh > 256) cuts
the output's columns into slices, each with the same scores: the same
arithmetic column by column, so one model covers it.

Plain TF32 (one product of operands rounded to tf32) misses that bar: a
case shows it, so the bar tells the two apart.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import kernel as j_fkernel
from repro_torch.kernels.flash_attention import ref as t_fref

# the card's fp32 flash bar (tests/test_torch_cuda.py, chip_smoke.py)
TOL_FLASH_F32 = 1e-5
BLOCK = 32               # the Pallas kernel's q and kv blocks (Sq, Skv % 32 == 0)


def _bk(dh: int) -> int:
    """Keys a tile of the kernel at head width dh (F32Tile / F32Wide)."""
    return 64 if dh <= 64 else 32


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest tf32 (top 19 bits), ties away from zero, as
    cvt.rna.tf32.f32: add half of the dropped range to the magnitude's
    bits, then clear the 13 dropped bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(x: torch.Tensor):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as lo.hi + hi.lo + hi.hi in fp32 (each product of two tf32
    values is exact in fp32)."""
    ah, al = _split(a)
    bh, bl = _split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def mm_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain TF32: one product of the rounded operands."""
    return tf32_rna(a) @ tf32_rna(b)


def flash_model(q, k, v, *, causal: bool, mm, block_k: int) -> torch.Tensor:
    """The kernel's online softmax over key tiles of ``block_k``, its two
    products through ``mm``; q [B, H, Sq, dh], k/v [B, Hkv, Skv, dh], fp32."""
    b, h, sq, dh = q.shape
    group = h // k.shape[1]
    k, v = k.repeat_interleave(group, 1), v.repeat_interleave(group, 1)
    sqrt_dh = torch.tensor(math.sqrt(dh), dtype=torch.float32)
    m = torch.full((b, h, sq, 1), -1e30)
    l = torch.zeros((b, h, sq, 1))
    acc = torch.zeros_like(q)
    rows = torch.arange(sq)[:, None]
    for k0 in range(0, k.shape[2], block_k):
        kt, vt = k[:, :, k0:k0 + block_k], v[:, :, k0:k0 + block_k]
        s = mm(q, kt.transpose(-1, -2)) / sqrt_dh
        if causal:
            keys = torch.arange(k0, k0 + kt.shape[2])[None, :]
            s = torch.where(keys > rows, torch.tensor(-1e30), s)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + mm(p, vt)
        m = m_new
    return acc / l.clamp_min(1e-30)


def _case(b, h, hkv, sq, skv, dh, causal, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, n, s, dh)).astype(np.float32)
               for n, s in ((h, sq), (hkv, skv), (hkv, skv)))
    want = np.asarray(j_fkernel.flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=BLOCK, block_k=BLOCK, interpret=True), np.float32)
    return (*(torch.from_numpy(t) for t in (q, k, v)), want)


@pytest.mark.parametrize("causal", (True, False))
@pytest.mark.parametrize("dh", (64, 128, 256, 320, 30),
                         ids=("dh64", "dh128", "dh256", "wide_dh320",
                              "ragged_dh30"))
def test_3xtf32_flash_matches_pallas(dh, causal):
    """Each head-width bucket of the narrow kernel (64 / 128 / 256), the
    wide arm (320) and a ragged width (30, in the 64 bucket), GQA 4/2 over
    three key tiles or more."""
    q, k, v, want = _case(1, 4, 2, 96, 96, dh, causal, seed=dh + causal)
    got = flash_model(q, k, v, causal=causal, mm=mm_3xtf32,
                      block_k=_bk(dh))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL_FLASH_F32,
                               atol=TOL_FLASH_F32)
    # and the port's plain version, which the card's kernel is held to
    plain = t_fref.flash_attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got, plain, rtol=TOL_FLASH_F32,
                               atol=TOL_FLASH_F32)


@pytest.mark.parametrize("sq,skv", [(32, 128), (128, 32)])
@pytest.mark.parametrize("dh", (64, 320), ids=("dh64", "wide_dh320"))
def test_3xtf32_flash_causal_unequal_lengths(dh, sq, skv):
    """Causal at Sq != Skv, top-left aligned (row i sees keys j <= i, a row
    past Skv every key), GQA 4/1."""
    q, k, v, want = _case(1, 4, 1, sq, skv, dh, True, seed=sq + dh)
    got = flash_model(q, k, v, causal=True, mm=mm_3xtf32, block_k=_bk(dh))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL_FLASH_F32,
                               atol=TOL_FLASH_F32)


@pytest.mark.parametrize("dh", (64, 256))
def test_plain_tf32_misses_the_bar(dh):
    """One product of rounded operands (plain TF32) on the same inputs
    lands outside TOL_FLASH_F32, where 3xTF32 stays far inside it."""
    q, k, v, want = _case(1, 4, 2, 96, 96, dh, True, seed=dh)
    tol = TOL_FLASH_F32 * (1 + np.abs(want))
    three = flash_model(q, k, v, causal=True, mm=mm_3xtf32,
                        block_k=_bk(dh)).numpy()
    one = flash_model(q, k, v, causal=True, mm=mm_tf32,
                      block_k=_bk(dh)).numpy()
    assert (np.abs(three - want) <= tol / 4).all()
    assert not (np.abs(one - want) <= tol).all()


def test_tf32_rounding_is_rna():
    """tf32_rna rounds the 13 dropped bits to nearest with ties away from
    zero (cvt.rna), keeps the sign, and x - rna(x) is exact in fp32."""
    one = 1.0
    ulp = 2.0 ** -10                  # tf32's ulp at 1
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2**-23,
                      one + 3 * ulp / 2, 0.0, -0.0], dtype=torch.float32)
    got = tf32_rna(x)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + 2 * ulp, 0.0,
                         -0.0], dtype=torch.float32)
    assert torch.equal(got, want)
    assert torch.equal(torch.signbit(got), torch.signbit(want))
    r = torch.from_numpy(np.random.default_rng(0).normal(size=1000)
                         .astype(np.float32))
    hi, lo = _split(r)
    assert torch.equal(tf32_rna(hi), hi) and torch.equal(tf32_rna(lo), lo)
    assert float(((hi + lo - r).abs() / r.abs()).max()) <= 2.0 ** -22
