"""The roofline and MFU counts against hand-computed shapes."""

import pytest

from portbench.counts import fused_decode, fused_moments, lm_model_flops, peaks

TINY = {"d_model": 8, "d_ff": 16, "n_heads": 2, "n_kv_heads": 1,
        "head_dim": 4, "n_layers": 2, "vocab_size": 10, "dtype": "bfloat16",
        "norm": "layernorm", "qkv_bias": False}


def test_fused_decode_counts_kv_up_to_position():
    # two slots x two masks at positions 3 and 5
    flops, nbytes = fused_decode.step_bound(TINY, [3, 3, 5, 5], n_masks=2)
    # per layer: q 8x8, k and v 8x4, o 8x8, gate/up/down 3 x 8x16 = 576
    assert fused_decode.layer_params(TINY) == 576
    # rows: 2 layers x (2 x 576 + 4 heads-dims x context) + head 2 x 8 x 10
    assert flops == sum(2 * (2 * 576 + 2 * 2 * 2 * 4 * c) + 160
                        for c in (4, 4, 6, 6))
    weights = 2 * (576 + 4 * 8 + 2 * 16) + 8 * 10 + 2 * 8 + 4 * 8
    kv_read = (3 + 3 + 5 + 5) * 2 * 2 * 4 * 2     # k and v, 2 layers, bf16
    kv_write = 4 * 2 * 2 * 4 * 2
    out = 2 * 10 * 4                              # two slots' fp32 mean logp
    assert nbytes == 2 * weights + kv_read + kv_write + out


def test_fused_decode_longer_context_costs_more():
    short = fused_decode.step_bound(TINY, [10] * 4, 2)
    long = fused_decode.step_bound(TINY, [1000] * 4, 2)
    assert long[1] - short[1] == 990 * 4 * 2 * 2 * 4 * 2
    assert fused_decode.step_bound(TINY, [], 2)[0] == 0


def test_rmsnorm_and_qkv_bias_bytes():
    cfg = {**TINY, "norm": "rmsnorm", "qkv_bias": True}
    # two scales of 8 a layer, biases on q (8), k and v (4 each)
    assert fused_decode.layer_small_params(cfg) == 2 * 8 + 8 + 4 + 4
    _, with_bias = fused_decode.step_bound(cfg, [3, 3], n_masks=2)
    _, plain = fused_decode.step_bound(TINY, [3, 3], n_masks=2)
    # per layer: +16 of biases, -16 of LayerNorm biases; final norm -8
    assert with_bias - plain == 2 * (2 * (16 - 16) - 8)


def test_stablelm_weights_dominate_a_step():
    cfg = {"d_model": 5120, "d_ff": 13824, "n_heads": 32, "n_kv_heads": 8,
           "head_dim": 160, "n_layers": 40, "vocab_size": 100352,
           "dtype": "bfloat16", "norm": "layernorm", "qkv_bias": False}
    # 12.1 B parameters at 2 bytes, about 24.3 GB (with the embedding)
    layers = 40 * fused_decode.layer_params(cfg)
    assert 11.0e9 < layers < 11.2e9
    _, nbytes = fused_decode.step_bound(cfg, [0] * 64, 4)
    assert 23.0e9 < nbytes < 23.4e9


def test_qwen2_weights_dominate_a_step():
    cfg = {"d_model": 3584, "d_ff": 18944, "n_heads": 28, "n_kv_heads": 4,
           "head_dim": 128, "n_layers": 28, "vocab_size": 152064,
           "dtype": "bfloat16", "norm": "rmsnorm", "qkv_bias": True}
    # 7.6 B parameters; the layers' products 6.5 B
    layers = 28 * fused_decode.layer_params(cfg)
    assert 6.52e9 < layers < 6.53e9
    # the layers, masks and output head at 2 bytes (the embedding table is
    # not read whole: only the fed tokens' rows)
    _, nbytes = fused_decode.step_bound(cfg, [0] * 64, 4)
    assert 14.1e9 < nbytes < 14.2e9


def test_ivim_packed_chain():
    # the dense protocol at 8 masks keeps 52 of 104 units in each layer
    assert fused_moments.flops_per_voxel(104, 4, 8, 52, 52) == \
        4 * 8 * 2 * (104 * 52 + 52 * 52 + 52)
    flops, nbytes = fused_moments.chunk_bound(4096, 104, 4, 8, 52, 52)
    assert flops == pytest.approx(2.140e9, rel=1e-3)
    params = 32 * (104 * 52 + 52 + 52 * 52 + 52 + 52 + 1)
    assert nbytes == 4 * (4096 * 104 + 4096 * 8 + params)
    # compute-bound at the 3xTF32 rate
    assert flops / peaks.TF32X3_FLOPS > nbytes / peaks.HBM_BYTES_PER_S


def test_prefill_flops():
    got = lm_model_flops.prefill_flops(TINY, 3, n_masks=2)
    per_mask = 3 * 2 * (2 * 576) + 2 * 2 * 2 * 2 * 4 * 3 * 4 // 2 + 160
    assert got == 2 * per_mask
    assert lm_model_flops.decode_flops(TINY, [3, 5]) == \
        fused_decode.row_flops(TINY, 4) + fused_decode.row_flops(TINY, 6)


def test_peaks_table():
    assert peaks.BF16_FLOPS == 989e12
    assert peaks.TF32X3_FLOPS == pytest.approx(165e12)
    assert peaks.HBM_BYTES_PER_S == 3.35e12
