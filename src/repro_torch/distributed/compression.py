"""Symmetric per-row int8 quantization — the part of
``repro.distributed.compression`` that int8 serving calls
(``core.plan._quantize_weight``). The gradient-compression transforms and
the compressed all-reduce come with the port's distributed slice.

The arithmetic is the reference's, step for step, so the int8 values are
bit-equal on the same fp32 input, on the CPU and on the card: the scale is
``max(amax, 1e-12) / 127`` in fp32 (:func:`int8_scale`), the value is
divided by it (not multiplied by its reciprocal), and ``torch.round``
rounds half to even, as ``jnp.round`` does.
"""

from __future__ import annotations

import torch

__all__ = ["int8_scale", "quantize_int8", "dequantize_int8"]


def int8_scale(amax: torch.Tensor) -> torch.Tensor:
    """``max(amax, 1e-12) / 127`` in fp32, as a true division on every
    device. PyTorch's CUDA division by a Python number multiplies by its
    reciprocal, which can land an ulp away from the quotient (and then move
    an int8 value by a step), so the divisor is a tensor on ``amax``'s
    device."""
    return amax.clamp_min(1e-12) / amax.new_full((), 127.0)


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization: x [..., d] -> (q int8 [..., d],
    scale fp32 [..., 1])."""
    xf = x.float()
    scale = int8_scale(xf.abs().amax(dim=-1, keepdim=True))
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale
