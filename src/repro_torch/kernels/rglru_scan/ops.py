"""Public wrapper of the rglru_scan kernel (``csrc/rglru_scan.cu``).

Dispatch is by device: a CPU tensor takes the plain version
(:func:`ref.rglru_scan_ref`), a CUDA tensor launches the kernel or raises.
No padding: the kernel masks ragged B and W and takes any S >= 1.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rglru_scan import ref as _ref

__all__ = ["rglru_scan"]

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b [B, S, W] fp32 -> h [B, S, W] fp32 with
    ``h_t = a_t h_{t-1} + b_t`` from a zero state."""
    if a.device.type == "cpu":
        return _ref.rglru_scan_ref(a, b)
    dev = _build.check_operands("rglru_scan", a=a, b=b)
    if a.ndim != 3 or a.shape != b.shape or a.numel() == 0:
        raise ValueError(f"rglru_scan: a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} must be one non-empty [B, S, W]")
    bsz, s, w = a.shape
    h = torch.empty_like(a)
    fn = _build.bind("rglru_scan", "rglru_scan_launch", _ARGTYPES)
    with _build.on_device(dev):
        err = fn(a.data_ptr(), b.data_ptr(), h.data_ptr(), bsz, s, w,
                 _build.stream_of(dev))
    _build.check_launch("rglru_scan", err)
    rglru_scan.launches += 1
    return h


#: Kernel launches since the count was last set to 0.
rglru_scan.launches = 0
