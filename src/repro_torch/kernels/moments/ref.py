"""Plain PyTorch version of the moments kernel (``csrc/moments.cu``)."""

from __future__ import annotations

import torch

__all__ = ["moments_ref"]


def moments_ref(samples: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """samples [N, B, P] -> (mean [B, P], std [B, P]) in the input's dtype:
    accumulated in fp32 (or wider), the variance centered and two-pass,
    population (ddof=0)."""
    s = samples.to(torch.promote_types(samples.dtype, torch.float32))
    mean = s.mean(dim=0)
    d = s - mean
    std = (d * d).mean(dim=0).sqrt()
    return mean.to(samples.dtype), std.to(samples.dtype)
