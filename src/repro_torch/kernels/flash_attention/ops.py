"""Public wrapper of the flash_attention kernel
(``csrc/flash_attention.cu``).

Dispatch is by device: a CPU tensor takes the plain version
(:func:`ref.flash_attention_ref`, the port's prefill attention), a CUDA
tensor launches the kernel or raises. No padding: the kernel masks ragged
Sq, Skv and head widths up to 256.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ref as _ref

__all__ = ["flash_attention", "MAX_HEAD_DIM"]

MAX_HEAD_DIM = 256
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float]
             + [ctypes.c_int] + [ctypes.c_void_p])
_ENTRIES = {torch.float32: "flash_attention_f32_launch",
            torch.bfloat16: "flash_attention_bf16_launch"}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, chunk: int = 1024) -> torch.Tensor:
    """q [B, H, Sq, dh], k/v [B, Hkv, Skv, dh] (fp32 or bf16, one dtype)
    -> [B, H, Sq, dh] in q's dtype; q-head h reads kv-head
    ``h // (H // Hkv)``. Causal requires ``Sq == Skv``. ``chunk`` is the
    query-chunk length of the plain version (its peak memory); the kernel
    does not read it."""
    _build.check_no_grad("flash_attention", q=q, k=k, v=v)
    if q.device.type == "cpu":
        return _ref.flash_attention_ref(q, k, v, causal=causal, chunk=chunk)
    if q.dtype not in _ENTRIES:
        raise TypeError(f"flash_attention: q is {q.dtype}, kernel takes "
                        f"float32 or bfloat16")
    dev = _build.check_operands("flash_attention",
                                {"q": q.dtype, "k": q.dtype, "v": q.dtype},
                                q=q, k=k, v=v)
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} are not "
                         f"[B, H, Sq, dh] and two equal [B, Hkv, Skv, dh]")
    b, h, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != dh or h % hkv or 0 in q.shape \
            or 0 in k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)} do not share batch and head "
                         f"width, or H is not a multiple of Hkv")
    if causal and sq != skv:
        raise ValueError(f"flash_attention: causal needs Sq == Skv, got "
                         f"{sq} and {skv}")
    if dh > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head width {dh} > "
                         f"{MAX_HEAD_DIM}")
    o = torch.empty_like(q)
    fn = _build.bind("flash_attention", _ENTRIES[q.dtype], _ARGTYPES)
    with _build.on_device(dev):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b,
                 h, hkv, sq, skv, dh, math.sqrt(dh), int(causal),
                 _build.stream_of(dev))
    _build.check_launch("flash_attention", err)
    flash_attention.launches += 1
    return o


#: Kernel launches since the count was last set to 0.
flash_attention.launches = 0
