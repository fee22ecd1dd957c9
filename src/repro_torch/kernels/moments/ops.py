"""Public wrapper of the moments kernel (``csrc/moments.cu``).

Dispatch is by device: a CPU tensor takes the plain version
(:func:`ref.moments_ref`), a CUDA tensor launches the kernel or raises. No
padding: the kernel masks the ragged tail of B·P itself and takes any
N >= 1.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.moments import ref as _ref

__all__ = ["moments", "register_bucket", "REGISTER_BUCKETS"]

#: Samples a thread of the kernel holds in registers (a template instance
#: each); samples past the largest are read again in the second pass.
REGISTER_BUCKETS = (8, 16, 32, 64)
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong,
                                     ctypes.c_int, ctypes.c_void_p]
_ENTRIES = {torch.float32: "moments_f32_launch",
            torch.bfloat16: "moments_bf16_launch"}


def register_bucket(n: int) -> int:
    """The kernel instance for N samples: the smallest bucket that holds
    all N, else the largest."""
    for c in REGISTER_BUCKETS:
        if c >= n:
            return c
    return REGISTER_BUCKETS[-1]


def moments(samples: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """samples [N, B, P] (fp32 or bf16, contiguous) -> (mean [B, P],
    std [B, P]) in the samples' dtype: fp32 accumulation, centered two-pass
    variance, population std (ddof=0)."""
    if samples.ndim != 3:
        raise ValueError(f"moments: samples {tuple(samples.shape)} are not "
                         f"[N, B, P]")
    _build.check_no_grad("moments", samples=samples)
    if samples.device.type == "cpu":
        return _ref.moments_ref(samples)
    if samples.dtype not in _ENTRIES:
        raise TypeError(f"moments: samples are {samples.dtype}, kernel takes "
                        f"float32 or bfloat16")
    dev = _build.check_operands("moments", {"samples": samples.dtype},
                                samples=samples)
    if 0 in samples.shape:
        raise ValueError(f"moments: samples {tuple(samples.shape)} are empty")
    n, b, p = samples.shape
    out = samples.new_empty((2, b, p))                   # mean, std
    mean_ptr = out.data_ptr()
    std_ptr = mean_ptr + b * p * out.element_size()
    fn = _build.bind("moments", _ENTRIES[samples.dtype], _ARGTYPES)
    with _build.on_device(dev):
        err = fn(samples.data_ptr(), mean_ptr, std_ptr, n, b * p,
                 register_bucket(n), _build.stream_of(dev))
    _build.check_launch("moments", err)
    moments.launches += 1
    mean, std = out.unbind()
    return mean, std


#: Kernel launches since the count was last set to 0.
moments.launches = 0
