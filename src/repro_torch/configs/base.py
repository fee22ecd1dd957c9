"""Unified model configuration schema: the port's copy of
``repro.configs.base`` with the same fields and properties, and a
``torch.dtype`` where the reference holds a jax dtype.

One dataclass describes every family (dense / moe / hybrid / audio / vlm /
ssm); family-specific fields are ignored by families that don't use them.
The layer stack is described by *segments* — homogeneous runs of a
repeating block pattern — whose parameters are stacked over the repeats.
The config is frozen and hashable: the serving step caches key on it.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

__all__ = ["ModelConfig", "InputShape", "SHAPES", "Segment"]


@dataclasses.dataclass(frozen=True)
class Segment:
    """A run of ``reps`` repetitions of ``pattern`` (tuple of block kinds).

    Block kinds: 'attn' (global attention + FFN), 'local_attn' (windowed
    attention + FFN), 'moe' (attention + MoE FFN), 'rec' (RG-LRU recurrent
    block + FFN), 'mlstm', 'slstm'.
    """
    pattern: tuple[str, ...]
    reps: int

    @property
    def n_layers(self) -> int:
        return len(self.pattern) * self.reps


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One dry-run cell's input geometry."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # ---- identity ----------------------------------------------------------
    arch_id: str
    family: str                      # dense | moe | hybrid | audio | vlm | ssm
    source: str = ""                 # provenance note ([hf:...] / [arXiv:...])

    # ---- core transformer dims ---------------------------------------------
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0                # 0 -> d_model // n_heads
    d_ff: int = 256                  # 0 -> family provides its own expansion
    vocab_size: int = 1000

    # ---- attention / position ----------------------------------------------
    causal: bool = True              # False for encoder-only (audio)
    qkv_bias: bool = False           # qwen2 family: True
    rope_theta: float = 10_000.0
    rope_pct: float = 1.0            # stablelm-2: 0.25 partial rotary
    m_rope_sections: tuple[int, ...] = ()   # qwen2-vl M-RoPE ((16,24,24))
    local_window: int = 0            # >0: sliding-window attention size

    # ---- norms / activations / embeddings ----------------------------------
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    activation: str = "silu"         # silu(SwiGLU) | gelu(GeGLU) | gelu_mlp
    tie_embeddings: bool = False
    embeds_input: bool = False       # audio/vlm prefill: frontend stub feeds
                                     # precomputed embeddings, not token ids

    # ---- MoE ---------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 2.0
    moe_group_size: int = 512
    moe_local_groups: bool = False
    moe_dense_residual: bool = False

    # ---- hybrid (RG-LRU) ----------------------------------------------------
    lru_width: int = 0               # 0 -> d_model
    conv_width: int = 4

    # ---- ssm (xLSTM) --------------------------------------------------------
    xlstm_pf: float = 2.0
    slstm_every: int = 4
    chunk_size: int = 256

    # ---- the paper's technique (Masksembles uncertainty) --------------------
    mask_samples: int = 0            # N=0 -> technique off (baseline DNN)
    mask_scale: float = 2.0
    mask_seed: int = 0
    # serving form: store per-sample PACKED FFN weights (mask-zero skipping,
    # paper §V-C) instead of multiplying by masks.
    packed_ffn_serving: bool = False

    # ---- numerics / execution ----------------------------------------------
    # The execution fields below mirror the reference's schema; the port's
    # serving path reads dtype, kv_dtype and attn_chunk.
    seq_shard: bool = False
    attn_scores_f32: bool = True
    segments_override: tuple = ()
    analysis_unroll: bool = False
    dtype: Any = torch.bfloat16      # activation/param storage dtype
    # KV cache storage dtype tag: "" = cache in `dtype`; "bfloat16" keeps
    # the cache in bf16; "int8" stores one int8 vector and one fp32 scale
    # per cached position and serves through the per-op decode step (it
    # has no fused decode lowering).
    kv_dtype: str = ""
    remat: str = "full"              # none | full | dots
    attn_chunk: int = 1024           # q-chunk of the chunked prefill attention
    use_pallas: bool = False
    scan_layers: bool = True

    # ------------------------------------------------------------------------
    def __post_init__(self):
        if self.family not in ("dense", "moe", "hybrid", "audio", "vlm",
                               "ssm"):
            raise ValueError(f"unknown family {self.family}")
        if self.kv_dtype not in ("", "bfloat16", "int8"):
            raise ValueError(f"unknown kv_dtype {self.kv_dtype!r}")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def bayesian(self) -> bool:
        return self.mask_samples > 0

    @property
    def sub_quadratic(self) -> bool:
        """Supports the long_500k cell (no O(S^2) full attention)."""
        return self.family in ("hybrid", "ssm")

    @property
    def has_decode(self) -> bool:
        return self.causal  # encoder-only archs have no decode step

    def segments(self) -> tuple[Segment, ...]:
        """The layer stack as homogeneous segments."""
        if self.segments_override:
            return tuple(Segment(tuple(p), r)
                         for p, r in self.segments_override)
        L = self.n_layers
        if self.family in ("dense", "vlm", "audio"):
            return (Segment(("attn",), L),)
        if self.family == "moe":
            return (Segment(("moe",), L),)
        if self.family == "hybrid":
            # RecurrentGemma: repeating (rec, rec, attn); remainder rec-only.
            reps, rem = divmod(L, 3)
            segs = []
            if reps:
                segs.append(Segment(("rec", "rec", "local_attn"), reps))
            if rem:
                segs.append(Segment(("rec",) * rem, 1))
            return tuple(segs)
        if self.family == "ssm":
            # xLSTM: every `slstm_every`-th block is sLSTM.
            k = self.slstm_every
            reps, rem = divmod(L, k)
            segs = []
            if reps:
                segs.append(Segment(("mlstm",) * (k - 1) + ("slstm",), reps))
            if rem:
                segs.append(Segment(("mlstm",) * rem, 1))
            return tuple(segs)
        raise ValueError(f"unknown family {self.family}")

    def param_count(self) -> int:
        """Approximate parameter count (for roofline MODEL_FLOPS)."""
        d, dh = self.d_model, self.resolved_head_dim
        qkv = d * dh * (self.n_heads + 2 * self.n_kv_heads) \
            + dh * self.n_heads * d
        if self.activation in ("silu", "gelu"):
            ffn = 3 * d * self.d_ff
        else:
            ffn = 2 * d * self.d_ff
        per_layer = 0
        for seg in self.segments():
            for kind in seg.pattern:
                if kind in ("attn", "local_attn"):
                    per_layer += (qkv + ffn) * seg.reps
                elif kind == "moe":
                    expert = 3 * d * self.d_ff
                    layer = qkv + self.n_experts * expert + d * self.n_experts
                    if self.moe_dense_residual:
                        layer += ffn
                    per_layer += layer * seg.reps
                elif kind == "rec":
                    w = self.lru_width or d
                    per_layer += (2 * d * w + w * d + 3 * w
                                  + self.conv_width * w + ffn) * seg.reps
                elif kind in ("mlstm", "slstm"):
                    pd = int(self.xlstm_pf * d)
                    per_layer += (2 * d * pd + pd * d + 4 * pd) * seg.reps
        embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return per_layer + embed

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k experts only)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        expert = 3 * d * self.d_ff
        total = self.param_count()
        inactive = self.n_layers * (self.n_experts - self.top_k) * expert
        return total - inactive
