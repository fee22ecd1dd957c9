"""Plain PyTorch version of the masked_ffn kernel (``csrc/masked_ffn.cu``)."""

from __future__ import annotations

import torch

__all__ = ["masked_ffn_ref"]


def masked_ffn_ref(x: torch.Tensor, w1p: torch.Tensor, b1p: torch.Tensor,
                   w2p: torch.Tensor, b2: torch.Tensor,
                   w1s: torch.Tensor | None = None,
                   w2s: torch.Tensor | None = None, *,
                   sample_major: bool = True) -> torch.Tensor:
    """Packed N-sample FFN: x [B, D], w1p [N, D, K], b1p [N, K],
    w2p [N, K, D2], b2 [D2] -> ``relu(x @ w1p[n] + b1p[n]) @ w2p[n] + b2``
    as [N, B, D2].

    ``w1s``/``w2s`` ([N, 1, K] / [N, 1, D2] bf16) are the per-output-channel
    scales of int8 ``w1p``/``w2p``: each weight is dequantized as
    ``float(q) * float(scale)``, and bf16 biases widen at the add.
    ``sample_major`` is the kernel's grid order; the result does not
    depend on it, and this version ignores it."""
    if w1s is not None:
        w1p = w1p.float() * w1s.float()
    if w2s is not None:
        w2p = w2p.float() * w2s.float()
    h = torch.relu(torch.matmul(x, w1p) + b1p[:, None, :])     # [N, B, K]
    return torch.matmul(h, w2p) + b2
