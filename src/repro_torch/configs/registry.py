"""Exact public configs of the 10 architectures (+ reduced smoke variants):
the port's copy of ``repro.configs.registry``, with ``torch`` dtypes.

Every architecture listed here builds in the port (``models.model``).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig

__all__ = ["ARCH_IDS", "get_config", "smoke_config", "CONFIGS"]


CONFIGS: dict[str, ModelConfig] = {
    # [hf:stabilityai/stablelm-2-12b] — LayerNorm, partial rotary 25%,
    # qkv bias off, gated SiLU MLP.
    "stablelm-12b": ModelConfig(
        arch_id="stablelm-12b", family="dense",
        source="hf:stabilityai/stablelm-2-12b",
        n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
        d_ff=13824, vocab_size=100352,
        norm="layernorm", activation="silu", rope_pct=0.25,
        rope_theta=10_000.0),

    # [arXiv:2407.10671] — GQA kv=2, QKV bias, tied embeddings.
    "qwen2-1.5b": ModelConfig(
        arch_id="qwen2-1.5b", family="dense",
        source="arXiv:2407.10671 (Qwen2)",
        n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
        d_ff=8960, vocab_size=151936,
        qkv_bias=True, tie_embeddings=True, rope_theta=1_000_000.0),

    # [arXiv:2405.04324] — llama-arch code model, MQA (kv=1).
    "granite-20b": ModelConfig(
        arch_id="granite-20b", family="dense",
        source="arXiv:2405.04324 (Granite Code)",
        n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1,
        d_ff=24576, vocab_size=49152,
        activation="gelu_mlp", norm="layernorm", qkv_bias=True,
        rope_theta=10_000.0),

    # [arXiv:2401.14196] — llama-arch, GQA kv=8, RoPE theta 100k.
    "deepseek-coder-33b": ModelConfig(
        arch_id="deepseek-coder-33b", family="dense",
        source="arXiv:2401.14196 (DeepSeek-Coder)",
        n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8,
        d_ff=19200, vocab_size=32256, rope_theta=100_000.0),

    # [hf:microsoft/Phi-3.5-MoE-instruct] — 16 experts top-2, GQA kv=8.
    "phi3.5-moe-42b-a6.6b": ModelConfig(
        arch_id="phi3.5-moe-42b-a6.6b", family="moe",
        source="hf:microsoft/Phi-3.5-MoE-instruct",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=6400, vocab_size=32064,
        n_experts=16, top_k=2, norm="layernorm",
        rope_theta=10_000.0),

    # [hf:Snowflake/snowflake-arctic-base] — 128 experts top-2 with a dense
    # FFN residual in parallel (dense-MoE hybrid).
    "arctic-480b": ModelConfig(
        arch_id="arctic-480b", family="moe",
        source="hf:Snowflake/snowflake-arctic-base",
        n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
        d_ff=4864, vocab_size=32000,
        n_experts=128, top_k=2, moe_dense_residual=True,
        capacity_factor=1.25, rope_theta=10_000.0),

    # [arXiv:2402.19427] — Griffin/RecurrentGemma: RG-LRU blocks with one
    # local-attention layer per two recurrent layers, window 2048, MQA.
    "recurrentgemma-2b": ModelConfig(
        arch_id="recurrentgemma-2b", family="hybrid",
        source="arXiv:2402.19427 (RecurrentGemma)",
        n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, head_dim=256,
        d_ff=7680, vocab_size=256000,
        activation="gelu", local_window=2048, lru_width=2560,
        rope_theta=10_000.0),

    # [arXiv:2106.07447] — HuBERT X-Large: encoder-only, frontend stubbed.
    "hubert-xlarge": ModelConfig(
        arch_id="hubert-xlarge", family="audio",
        source="arXiv:2106.07447 (HuBERT)",
        n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16,
        d_ff=5120, vocab_size=504,
        causal=False, embeds_input=True, norm="layernorm",
        activation="gelu_mlp"),

    # [arXiv:2409.12191] — Qwen2-VL 72B backbone: M-RoPE (16,24,24).
    "qwen2-vl-72b": ModelConfig(
        arch_id="qwen2-vl-72b", family="vlm",
        source="arXiv:2409.12191 (Qwen2-VL)",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=29568, vocab_size=152064,
        qkv_bias=True, m_rope_sections=(16, 24, 24), embeds_input=True,
        rope_theta=1_000_000.0),

    # [arXiv:2405.04517] — xLSTM 350M-class: mLSTM + sLSTM blocks, pf=2.
    "xlstm-350m": ModelConfig(
        arch_id="xlstm-350m", family="ssm",
        source="arXiv:2405.04517 (xLSTM)",
        n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab_size=50304,
        xlstm_pf=2.0, slstm_every=4, chunk_size=256),
}

ARCH_IDS: tuple[str, ...] = tuple(CONFIGS)


def get_config(arch_id: str, **overrides) -> ModelConfig:
    if arch_id not in CONFIGS:
        raise KeyError(f"unknown arch {arch_id!r}; have {ARCH_IDS}")
    cfg = CONFIGS[arch_id]
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def smoke_config(arch_id: str, **overrides) -> ModelConfig:
    """Reduced same-family config: small widths/layers/vocab, fp32,
    Masksembles ON (N=4) so every smoke test exercises the technique."""
    base = get_config(arch_id)
    heads = min(base.n_heads, 4)
    kv = min(base.n_kv_heads, heads)
    small = dict(
        n_layers=min(base.n_layers, 4 if base.family in ("hybrid", "ssm")
                     else 2),
        d_model=64, n_heads=heads, n_kv_heads=kv, head_dim=16,
        d_ff=0 if base.d_ff == 0 else 128,
        vocab_size=256,
        n_experts=min(base.n_experts, 8) if base.n_experts else 0,
        moe_group_size=64,
        capacity_factor=(float(min(base.n_experts, 8)) / base.top_k
                         if base.n_experts else base.capacity_factor),
        local_window=16 if base.local_window else 0,
        lru_width=64 if base.lru_width else 0,
        chunk_size=8,
        mask_samples=4, mask_scale=2.0,
        dtype=torch.float32, remat="none", attn_chunk=64,
    )
    if base.m_rope_sections:
        small["m_rope_sections"] = (2, 3, 3)   # scaled to head_dim 16
    if base.family == "hybrid":
        small["n_layers"] = 4          # rec,rec,attn + rec remainder
    if base.family == "ssm":
        small["n_layers"] = 4          # m,m,m,s
        small["d_model"] = 64
        small["head_dim"] = 0
    small.update(overrides)
    return dataclasses.replace(base, **small)
