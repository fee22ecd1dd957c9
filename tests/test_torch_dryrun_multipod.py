"""The port's multi-pod dry-run cells that failed or took minutes, and the
products written for them, on the CPU.

On the (2, 16, 16) mesh over a ``fake`` group of 512 ranks, xlstm-350m's
``train_4k`` raised in the mLSTM chunk (DTensor split the einsum's
flattened B·H over all three mesh dims, 512 ways, which the unflatten to
[256, 4] cannot give), and hubert-xlarge's ``train_4k`` and xlstm's
``decode_32k`` took 1,227 s and 484 s, most of it DTensor planning the
grouped-score einsum and the decode step's products. The products now go
through ``layers.einsum`` (each rank's local shards where they line up,
the layout stated) with the mLSTM's layouts stated first.

The limits below are this file's wall-clock bars for one layer, far above
what the cells take alone on an 8-core host and far below what they took
before. ``layers.einsum`` keeps plain tensors on ``torch.einsum`` itself:
the bitwise cases hold the rewritten products to the einsum forms they
replaced, at fp32 and bf16; the gloo case holds it to ``torch.einsum`` on
DTensors, values and gradients.
"""

import math
import time

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_dist_worker as worker
from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES
from repro_torch.launch import dryrun
from repro_torch.models import layers, xlstm

#: Wall-clock bars for one layer on the 512-rank mesh (s): hubert's
#: ``train_4k`` (≈ 22 s alone; 1,227 s for 48 layers before, ≈ 280 s of
#: it the first layer's grouped-score einsum) and xlstm's ``decode_32k``
#: (≈ 8 s alone; 484 s for 24 layers before).
HUBERT_TRACE_LIMIT_S = 120.0
XLSTM_DECODE_LIMIT_S = 60.0
ONE_LAYER = {"n_layers": 1}


def test_xlstm_multi_pod_train_cell_runs():
    """xlstm-350m ``train_4k`` on (2, 16, 16) at its published widths, cut
    to one layer, an mLSTM: it traces (it raised in ``_mlstm_chunk``
    before), on 512 devices, each with half a single-pod device's model
    FLOPs, and it moves bytes between them."""
    r = dryrun.run_cell("xlstm-350m", "train_4k", multi_pod=True,
                        overrides=ONE_LAYER)
    cfg = registry.get_config("xlstm-350m", **ONE_LAYER)
    assert [seg.pattern for seg in cfg.segments()] == [("mlstm",)]
    assert r["n_chips"] == 512
    assert r["roofline"]["model_flops_per_device"] * 2 == \
        dryrun.model_flops(cfg, SHAPES["train_4k"]) / 256
    assert r["cost"]["hlo_flops_per_device"] > 0
    assert sum(r["collectives"].values()) > 0


def _timed(arch: str, shape: str) -> tuple[dict, float]:
    t0 = time.perf_counter()
    r = dryrun.run_cell(arch, shape, multi_pod=True, overrides=ONE_LAYER)
    return r, time.perf_counter() - t0


def test_hubert_multi_pod_train_cell_within_its_limit():
    r, seconds = _timed("hubert-xlarge", "train_4k")
    assert seconds < HUBERT_TRACE_LIMIT_S, seconds
    assert r["n_chips"] == 512
    assert r["cost"]["hlo_flops_per_device"] > 0


def test_xlstm_multi_pod_decode_cell_within_its_limit():
    r, seconds = _timed("xlstm-350m", "decode_32k")
    assert seconds < XLSTM_DECODE_LIMIT_S, seconds
    assert r["n_chips"] == 512
    assert r["cost"]["hlo_flops_per_device"] > 0


# ---------------------------------------------------------------------------
# the rewritten products on plain tensors: bit for bit the einsum forms
# ---------------------------------------------------------------------------


def _chunk_einsum(q, k, v, igate, fgate, carry, eps=1e-6):
    """``xlstm._mlstm_chunk`` as it was written with ``torch.einsum``."""
    c_state, n_state, m_state = carry
    lf = F.logsigmoid(fgate.float())
    fc = torch.cumsum(lf, -1)
    a = igate.float() - fc
    g = torch.cummax(a, 2).values
    m = torch.maximum(m_state[..., None], g)
    qf, kf, vf = q.float(), k.float(), v.float()
    s = torch.einsum("bhqd,bhtd->bhqt", qf, kf)
    cc = q.shape[2]
    tri = torch.tril(torch.ones((cc, cc), dtype=torch.bool))
    d_w = torch.where(tri, torch.exp(a[:, :, None, :] - m[..., None]), 0.0)
    sw = s * d_w
    num_intra = torch.einsum("bhqt,bhtd->bhqd", sw, vf)
    den_intra = sw.sum(-1)
    c_j = torch.exp(m_state[..., None] - m)
    num_inter = torch.einsum("bhqd,bhde->bhqe", qf, c_state) * c_j[..., None]
    den_inter = torch.einsum("bhqd,bhd->bhq", qf, n_state) * c_j
    m_star = fc + m
    den = torch.maximum((den_intra + den_inter).abs(),
                        torch.exp(-m_star)) + eps
    h = (num_intra + num_inter) / den[..., None]
    m_last = m[..., -1]
    w_t = torch.exp(a - m_last[..., None])
    decay = torch.exp(m_state - m_last)
    c_new = (decay[..., None, None] * c_state
             + torch.einsum("bht,bhtd,bhte->bhde", w_t, kf, vf))
    n_new = decay[..., None] * n_state + torch.einsum("bht,bhtd->bhd",
                                                      w_t, kf)
    return h, (c_new, n_new, fc[..., -1] + m_last)


def _step_einsum(q, k, v, igate, fgate, carry, eps=1e-6):
    """``xlstm.mlstm_step`` as it was written with ``torch.einsum``."""
    c_state, n_state, m_state = carry
    lf = F.logsigmoid(fgate.float())
    ig = igate.float()
    m_new = torch.maximum(lf + m_state, ig)
    fw = torch.exp(lf + m_state - m_new)
    iw = torch.exp(ig - m_new)
    kf, vf, qf = k.float(), v.float(), q.float()
    c_new = (fw[..., None, None] * c_state
             + iw[..., None, None] * kf[..., :, None] * vf[..., None, :])
    n_new = fw[..., None] * n_state + iw[..., None] * kf
    num = torch.einsum("bhd,bhde->bhe", qf, c_new)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", qf, n_new).abs(),
                        torch.exp(-m_new)) + eps
    return num / den[..., None], (c_new, n_new, m_new)


def _scores_einsum(q, k):
    b, h, sq, dh = q.shape
    hkv = k.shape[1]
    qg = q.reshape(b, hkv, h // hkv, sq, dh)
    return torch.einsum("bkgqd,bksd->bkgqs", qg.float(), k.float())


def _combine_einsum(p, v):
    b, hkv, g, sq, _ = p.shape
    out = torch.einsum("bkgqs,bksd->bkgqd", p.to(v.dtype), v)
    return out.reshape(b, hkv * g, sq, -1)


def _rand(rng, shape, dtype, scale=1.0):
    return torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32)).to(dtype)


def _equal(got, want):
    if isinstance(got, tuple):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _equal(a, b)
        return
    assert got.dtype == want.dtype and torch.equal(got, want)


DTYPES = (torch.float32, torch.bfloat16)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("c", (8, 16))
def test_mlstm_chunk_is_the_einsum_form(dtype, c):
    rng = np.random.default_rng(c)
    b, h, dh = 2, 4, 16
    q, v = (_rand(rng, (b, h, c, dh), dtype) for _ in range(2))
    k = _rand(rng, (b, h, c, dh), dtype, 1 / math.sqrt(dh))
    ig, fg = (_rand(rng, (b, h, c), dtype, 2.0) for _ in range(2))
    carry = (_rand(rng, (b, h, dh, dh), torch.float32),
             _rand(rng, (b, h, dh), torch.float32),
             _rand(rng, (b, h), torch.float32))
    _equal(xlstm._mlstm_chunk(q, k, v, ig, fg, carry),
           _chunk_einsum(q, k, v, ig, fg, carry))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_mlstm_step_is_the_einsum_form(dtype):
    rng = np.random.default_rng(1)
    b, h, dh = 3, 4, 16
    q, k, v = (_rand(rng, (b, h, dh), dtype) for _ in range(3))
    ig, fg = (_rand(rng, (b, h), dtype, 2.0) for _ in range(2))
    carry = (_rand(rng, (b, h, dh, dh), torch.float32),
             _rand(rng, (b, h, dh), torch.float32),
             _rand(rng, (b, h), torch.float32))
    _equal(xlstm.mlstm_step(q, k, v, ig, fg, carry),
           _step_einsum(q, k, v, ig, fg, carry))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("h,hkv", [(8, 2), (4, 4)], ids=("gqa", "g1"))
def test_grouped_scores_and_combine_are_the_einsum_forms(dtype, h, hkv):
    rng = np.random.default_rng(h * hkv)
    b, sq, sk, dh = 2, 5, 7, 16
    q = _rand(rng, (b, h, sq, dh), dtype)
    k, v = (_rand(rng, (b, hkv, sk, dh), dtype) for _ in range(2))
    s = layers._grouped_scores(q, k)
    _equal(s, _scores_einsum(q, k))
    _equal(layers._grouped_scores(q, k, scores_f32=False),
           _scores_einsum(q, k).to(dtype))
    p = torch.softmax(s, -1)
    _equal(layers._grouped_combine(p, v), _combine_einsum(p, v))


# ---------------------------------------------------------------------------
# on DTensors: values and gradients on a (2, 2) gloo mesh
# ---------------------------------------------------------------------------


def test_einsum_on_dtensors_matches_torch_einsum(tmp_path):
    """Every ``EINSUM_CASES`` product of ``tests/torch_dist_worker.py`` on
    4 gloo ranks: lined up or not as the case says, and equal to
    ``torch.einsum`` on the whole tensors in float64 (values, and each
    operand's gradient: the partial gradients of the operands that hold
    the sharded subscript whole)."""
    worker.spawn("einsum", 4, str(tmp_path))
