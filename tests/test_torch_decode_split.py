"""The fused decode kernel's arithmetic and layout, on the CPU.

``csrc/fused_decode.cu`` runs its products on the tensor cores with each
fp32 activation split into three bf16 parts
(``kernels/fused_decode/ref.split_bf16x3``). These tests hold the plain
statement of that split to what the kernel relies on: the parts sum to x
exactly, and three bf16 x bf16 products (each exact in fp32) summed in
fp32 give the fp32 product over bf16 weights, where one or two parts do
not. Sums of products are compared in float64 against the fp32 product's
own rounding. The wrapper's stage list and its guards run here too (no
launch). The kernel itself is held to its plain version on the card
(tests/test_torch_cuda.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.core import plan as plan_lib
from repro_torch.kernels.fused_decode import ops as dops
from repro_torch.kernels.fused_decode import ref as dref


def _activations(seed: int, n: int) -> torch.Tensor:
    """fp32 values across the magnitudes a decode step produces (residual
    stream, normed rows, attention outputs, FFN hidden units): signed,
    log-uniform in [1e-6, 1e4], plus exact zeros and powers of two."""
    rng = np.random.default_rng(seed)
    mag = 10.0 ** rng.uniform(-6, 4, n)
    x = (rng.choice([-1.0, 1.0], n) * mag).astype(np.float32)
    x[:8] = [0.0, 1.0, -1.0, 2.0 ** -20, 2.0 ** 13, 3.0, -0.5, 1e-6]
    return torch.from_numpy(x)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_parts_sum_to_x_exactly(seed):
    x = _activations(seed, 100_000)
    hi, mid, lo = dref.split_bf16x3(x)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    total = hi.double() + mid.double() + lo.double()
    assert torch.equal(total, x.double())
    # each remainder is at most half a bf16 ulp of the part before it
    assert bool((mid.double().abs() <= hi.double().abs() * 2.0 ** -8).all())
    assert bool((lo.double().abs() <= mid.double().abs() * 2.0 ** -8).all())
    # and in fp32, summed small parts first, as the kernel's mma order does
    assert torch.equal((lo.float() + mid.float()) + hi.float(), x)


@pytest.mark.parametrize("seed", [0, 1])
def test_split_products_are_exact_in_fp32(seed):
    """A bf16 weight times each part is exact in fp32 (8 x 8 significant
    bits), so the three products carry w . x without rounding."""
    x = _activations(seed, 50_000)
    rng = np.random.default_rng(seed + 10)
    w = torch.from_numpy(rng.standard_normal(x.numel()).astype(np.float32)
                         ).to(torch.bfloat16)
    for part in dref.split_bf16x3(x):
        assert torch.equal((w.float() * part.float()).double(),
                           w.double() * part.double())
    exact = sum(w.double() * p.double() for p in dref.split_bf16x3(x))
    assert torch.equal(exact, w.double() * x.double())


def _products(k: int, n: int, rows: int, seed: int):
    """in [rows, k] fp32 activations and w [k, n] bf16 weights; the float64
    product, the fp32 product, and the fp32 sum of 1, 2 and 3 split parts'
    products (each part's product taken in fp32)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal((rows, k))
                          * 10.0 ** rng.uniform(-1, 1, (rows, 1))
                          ).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((k, n)) / np.sqrt(k))
                         .astype(np.float32)).to(torch.bfloat16)
    exact = x.double() @ w.double()
    fp32 = x @ w.float()
    parts = dref.split_bf16x3(x)
    split = {}
    acc = torch.zeros_like(fp32)
    for i, p in enumerate(parts, 1):
        acc = acc + p.float() @ w.float()
        split[i] = acc.clone()
    return exact, fp32, split


@pytest.mark.parametrize("seed", [0, 1])
def test_three_parts_round_like_one_fp32_product(seed):
    """One product, summed small parts first in fp32 (two roundings):
    within one ulp of the exact w . x, where the fp32 product is within
    half an ulp; two parts miss by more than 16 ulp, one part by more than
    1,000 (bf16's 8 bits)."""
    x = _activations(seed, 50_000)
    x = x[x.abs() > 1e-3]
    rng = np.random.default_rng(seed + 20)
    w = torch.from_numpy(rng.standard_normal(x.numel()).astype(np.float32)
                         ).to(torch.bfloat16).float()
    hi, mid, lo = (p.float() for p in dref.split_bf16x3(x))
    exact = w.double() * x.double()
    ulp = torch.exp2(torch.floor(torch.log2(exact.abs())) - 23)
    ulps = {3: (w * lo + w * mid) + w * hi, 2: w * mid + w * hi, 1: w * hi,
            "fp32": w * x}
    ulps = {k: float(((v.double() - exact).abs() / ulp).max())
            for k, v in ulps.items()}
    assert ulps["fp32"] <= 0.5 and ulps[3] <= 1.0
    assert ulps[2] > 16 and ulps[1] > 1000


@pytest.mark.parametrize("k,n,seed", [(1536, 256, 0), (8960, 64, 1),
                                      (40, 100, 2)])
def test_three_parts_match_the_fp32_product(k, n, seed):
    """Sums of products: three parts within the fp32 product's own
    rounding of the exact dot (each part's sum rounds relative to that
    part's size); one part (plain bf16 activations) or two are not (two
    parts read 6-10x the fp32 error at these shapes, one part 4,000x)."""
    exact, fp32, split = _products(k, n, 32, seed)
    scale = float(exact.abs().max())
    err = {i: float((s.double() - exact).abs().max()) / scale
           for i, s in split.items()}
    fp32_err = float((fp32.double() - exact).abs().max()) / scale
    assert err[3] <= 2 * fp32_err + 2.0 ** -24
    assert err[2] > 3 * fp32_err
    assert err[1] > 1e3 * fp32_err


def test_stage_names_follow_the_kernel():
    """7 stages a layer, RMSNorm or layernorm alike (the hidden units are
    computed in the down GEMV's staging, so no stage of their own), then
    the final norm and the 4 epilogue stages."""
    for arch, n_layers in (("qwen2-1.5b", 3), ("granite-20b", 2)):
        spec = plan_lib.lower_fused_decode(
            registry.smoke_config(arch, n_layers=n_layers))
        names = dops.stage_names(spec)
        assert len(names) == 7 * n_layers + 5
        assert names[:7] == ("norm1", "qkv", "attention", "wo", "norm2",
                             "gate_up", "down")
        assert names[-5:] == ("final_norm", "lm_head", "log_sum_exp",
                              "welford", "argmax")
        assert "hidden" not in names and names.count("norm1") == n_layers


def test_kernel_guards_raise_unsupported():
    """Beyond the kernel's head width the wrapper raises
    FusedPlanUnsupported (the serving step then runs per-op). Every GQA
    group width (the kernel cuts a group whose attention state outgrows its
    shared memory into head chunks) and any number of packed masks (its
    GEMV jobs run in batches of its job table) pass."""
    for arch in ("qwen2-1.5b", "granite-20b"):
        dops._layout(plan_lib.lower_fused_decode(registry.get_config(arch)))
    wide = registry.smoke_config("qwen2-1.5b", n_heads=4, n_kv_heads=2,
                                 head_dim=dops.MAX_HEAD_DIM * 2)
    with pytest.raises(dops.FusedPlanUnsupported, match="head_dim"):
        dops._layout(plan_lib.lower_fused_decode(wide))
    big = registry.smoke_config("qwen2-1.5b", n_heads=64, n_kv_heads=1,
                                head_dim=dops.MAX_HEAD_DIM)
    dops._layout(plan_lib.lower_fused_decode(big))
    packed = registry.smoke_config("qwen2-1.5b", mask_samples=40,
                                   packed_ffn_serving=True)
    assert plan_lib.lower_fused_decode(packed).n_samples == 40
    dops._layout(plan_lib.lower_fused_decode(packed))


def test_workspace_holds_the_attention_parts():
    """The zeroed workspace has room for PMAX parts of every head's
    attention state and a count for every head (a head chunk's count sits
    at its first head)."""
    cfg = dataclasses.replace(registry.smoke_config("qwen2-1.5b"),
                              n_heads=12, n_kv_heads=2, head_dim=128)
    spec = plan_lib.lower_fused_decode(cfg)
    buf, ptrs, stamps = dops._workspace(spec, 12, torch.device("cpu"))
    assert len(ptrs) == 12 and not bool(buf.any())
    heads = 12 * 12 * dops._ATTN_PARTS
    assert buf.data_ptr() + 4 * buf.numel() - ptrs[-1] >= 4 * 12 * 12  # cnt
    assert ptrs[-1] - ptrs[-2] >= 4 * heads * 128   # part_acc
    assert ptrs[-2] - ptrs[-3] >= 4 * heads * 2     # part_ml
    assert stamps.numel() == len(dops.stage_names(spec)) + 1
