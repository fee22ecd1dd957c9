"""Plain PyTorch version of the flash_attention kernel
(``csrc/flash_attention.cu``): the port's prefill attention of
``models/layers.py``, which materializes the scores (in query chunks of
``chunk`` rows for a long causal prompt)."""

from __future__ import annotations

import torch

from repro_torch.models import layers

__all__ = ["flash_attention_ref"]


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, chunk: int = 1024
                        ) -> torch.Tensor:
    """q [B, H, Sq, dh], k/v [B, Hkv, Skv, dh] -> [B, H, Sq, dh]: fp32
    scores and softmax, ``p`` rounded to v's dtype before ``p v``."""
    if causal and q.shape[2] > chunk:
        return layers.attention_chunked(q, k, v, causal=True, chunk=chunk)
    return layers.attention_full(q, k, v, causal=causal)
