"""The port's moments module and ``core/uncertainty`` against the JAX
package, on the CPU.

The plain version ``kernels/moments/ref.moments_ref`` against the
reference's kernel wrapper as its own tests run it (``repro.kernels.moments
.ops.moments``: the Pallas kernel in interpret mode) and against its plain
tier (``moments_ref``); then the consumers that reach the wrapper through
``uncertainty.predictive_moments``. The CUDA kernel is held to this plain
version on the card by tests/test_torch_cuda.py and ``chip_smoke.py``.

Tolerances (fp32, sums in another order): the reference's own
kernel-vs-ref bar from tests/test_kernels.py — mean rtol 1e-5 / atol 1e-6,
std rtol 1e-4 / atol 1e-5. bf16 outputs within one bf16 ulp of the
reference's (both round an fp32 result once). A constant input whose sums
are exact in fp32 gives a std of exactly 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import uncertainty as j_unc
from repro.kernels.moments import ops as j_mo_ops
from repro.kernels.moments import ref as j_mo_ref
from repro_torch.core import uncertainty as t_unc
from repro_torch.kernels.moments import ops as t_mo_ops
from repro_torch.kernels.moments import ref as t_mo_ref

MEAN = dict(rtol=1e-5, atol=1e-6)
STD = dict(rtol=1e-4, atol=1e-5)


def _samples(n, b, p, seed=0):
    return np.random.default_rng(seed).normal(size=(n, b, p)) \
        .astype(np.float32)


def _check(got, want):
    np.testing.assert_allclose(np.asarray(got[0], np.float32),
                               np.asarray(want[0], np.float32), **MEAN)
    np.testing.assert_allclose(np.asarray(got[1], np.float32),
                               np.asarray(want[1], np.float32), **STD)


@pytest.mark.parametrize("p", [1, 4, 5, 128])
@pytest.mark.parametrize("b", [1, 7, 300])
@pytest.mark.parametrize("n", [1, 2, 8, 64])
def test_moments_plain_matches_reference(n, b, p):
    s = _samples(n, b, p, seed=n * 1000 + b * 10 + p)
    got = t_mo_ref.moments_ref(torch.from_numpy(s))
    assert got[0].dtype == got[1].dtype == torch.float32
    assert got[0].shape == got[1].shape == (b, p)
    _check(got, j_mo_ref.moments_ref(jnp.asarray(s)))
    _check(got, j_mo_ops.moments(jnp.asarray(s), interpret=True))
    # the wrapper on a CPU tensor is the plain version and launches nothing
    before = t_mo_ops.moments.launches
    _check(t_mo_ops.moments(torch.from_numpy(s)), got)
    assert t_mo_ops.moments.launches == before


def _within_bf16_ulp(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert (np.abs(got - want) <= ulp).all(), np.abs(got - want).max()


def test_moments_plain_bf16_matches_reference():
    s = _samples(8, 300, 5, seed=3)
    sb = torch.from_numpy(s).to(torch.bfloat16)
    got = t_mo_ref.moments_ref(sb)
    assert got[0].dtype == got[1].dtype == torch.bfloat16
    want = j_mo_ops.moments(jnp.asarray(sb.float().numpy(), jnp.bfloat16),
                            interpret=True)
    assert want[0].dtype == jnp.bfloat16
    for g, w in zip(got, want):
        _within_bf16_ulp(g.float().numpy(), np.asarray(w, np.float32))


@pytest.mark.parametrize("value", [1.0, -0.375])
def test_moments_plain_constant_input_zero_std(value):
    """A constant whose sums are exact in fp32: the mean is the value and
    the centered variance exactly 0 (the reference's test uses ones)."""
    s = torch.full((8, 16, 4), value)
    mean, std = t_mo_ref.moments_ref(s)
    assert bool((std == 0).all()) and bool((mean == value).all())
    _, jstd = j_mo_ops.moments(jnp.full((8, 16, 4), value), interpret=True)
    np.testing.assert_allclose(np.asarray(jstd), 0.0, atol=1e-7)


def test_moments_wrapper_refuses_non_3d():
    with pytest.raises(ValueError, match=r"\[N, B, P\]"):
        t_mo_ops.moments(torch.zeros(4, 5))
    with pytest.raises(ValueError, match=r"\[N, B, P\]"):
        t_mo_ops.moments(torch.zeros(2, 3, 4, 5))


@pytest.mark.parametrize("shape,axis", [((8, 33, 4), 0), ((33, 8, 4), 1),
                                        ((5, 6), 0), ((6, 5), -1),
                                        ((3, 4, 6, 5), 2), ((7,), 0)])
def test_predictive_moments_matches_reference(shape, axis):
    s = np.random.default_rng(len(shape) + axis).normal(size=shape) \
        .astype(np.float32)
    got = t_unc.predictive_moments(torch.from_numpy(s), axis=axis)
    want = j_unc.predictive_moments(jnp.asarray(s), axis=axis)
    assert got[0].shape == want[0].shape and got[1].shape == want[1].shape
    _check(got, want)
    np.testing.assert_allclose(
        t_unc.relative_uncertainty(torch.from_numpy(s), axis=axis).numpy(),
        np.asarray(j_unc.relative_uncertainty(jnp.asarray(s), axis=axis)),
        rtol=1e-4)


@pytest.mark.parametrize("n,b,v", [(4, 3, 97), (1, 2, 50), (8, 1, 256)])
def test_token_posterior_matches_reference(n, b, v):
    logits = np.random.default_rng(n + b + v).normal(size=(n * b, v)) \
        .astype(np.float32) * 3
    mean, rel = t_unc.token_posterior(torch.from_numpy(logits), n)
    jmean, jrel = j_unc.token_posterior(jnp.asarray(logits), n)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), **MEAN)
    assert np.array_equal(mean.numpy().argmax(-1),
                          np.asarray(jmean).argmax(-1))
    np.testing.assert_allclose(rel.numpy(), np.asarray(jrel),
                               rtol=1e-4, atol=1e-6)
    if n == 1:
        assert bool((rel == 0).all())


@pytest.mark.parametrize("shape,axis", [((0, 3, 4), 0), ((0,), 0),
                                        ((4, 3, 0), 0), ((3, 0, 4), 1)])
def test_predictive_moments_empty_matches_reference(shape, axis):
    """An empty sample axis gives NaN over the other axes, empty other axes
    give empty results: the reference's jnp.mean/jnp.std, without a
    reshape of an empty tensor and without a launch."""
    s = np.zeros(shape, np.float32)
    before = t_mo_ops.moments.launches
    got = t_unc.predictive_moments(torch.from_numpy(s), axis=axis)
    assert t_mo_ops.moments.launches == before
    want = j_unc.predictive_moments(jnp.asarray(s), axis=axis)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and w.dtype == jnp.float32
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))  # NaN == NaN


def _within_fp16_ulp(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -24)))
                  - 10)
    assert (np.abs(got - want) <= ulp).all(), np.abs(got - want).max()


@pytest.mark.parametrize("shape,axis", [((8, 33, 4), 0), ((5, 6), -1),
                                        ((4, 7, 3), 1)])
def test_predictive_moments_fp16_matches_reference(shape, axis):
    """fp16 samples: widened to fp32 for the reduction, results in fp16,
    within one fp16 ulp of the reference's (both round an fp32 result)."""
    s = np.random.default_rng(sum(shape)).normal(size=shape) \
        .astype(np.float16)
    got = t_unc.predictive_moments(torch.from_numpy(s), axis=axis)
    want = j_unc.predictive_moments(jnp.asarray(s), axis=axis)
    for g, w in zip(got, want):
        assert g.dtype == torch.float16 and w.dtype == jnp.float16
        assert tuple(g.shape) == w.shape
        _within_fp16_ulp(g.float().numpy(), np.asarray(w, np.float32))


@pytest.mark.parametrize("n,bucket", [(1, 8), (7, 8), (8, 8), (9, 16),
                                      (16, 16), (17, 32), (33, 64), (64, 64),
                                      (65, 64), (200, 64)])
def test_moments_register_bucket(n, bucket):
    """The kernel instance the wrapper picks: the smallest register bucket
    that holds all N samples, the largest (64) beyond that."""
    assert t_mo_ops.register_bucket(n) == bucket
    assert bucket in t_mo_ops.REGISTER_BUCKETS
