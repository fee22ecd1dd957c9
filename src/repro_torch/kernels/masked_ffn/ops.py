"""Public wrapper of the masked_ffn kernel (``csrc/masked_ffn.cu``).

Dispatch is by device: a CPU tensor takes the plain version
(:func:`ref.masked_ffn_ref`), a CUDA tensor launches the kernel or raises.
No padding: the kernel masks ragged B, D, K and D2 itself.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.masked_ffn import ref as _ref

__all__ = ["masked_ffn"]

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def masked_ffn(x: torch.Tensor, w1p: torch.Tensor, b1p: torch.Tensor,
               w2p: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """x [B, D], w1p [N, D, K], b1p [N, K], w2p [N, K, D2], b2 [D2] ->
    ``relu(x @ w1p[n] + b1p[n]) @ w2p[n] + b2`` as [N, B, D2] (fp32)."""
    if x.device.type == "cpu":
        return _ref.masked_ffn_ref(x, w1p, b1p, w2p, b2)
    dev = _build.check_operands("masked_ffn", x=x, w1p=w1p, b1p=b1p,
                                w2p=w2p, b2=b2)
    b, d = x.shape
    n, _, k = w1p.shape
    d2 = w2p.shape[-1]
    if (w1p.shape != (n, d, k) or b1p.shape != (n, k)
            or w2p.shape != (n, k, d2) or b2.shape != (d2,)):
        raise ValueError(
            f"masked_ffn: shapes x {tuple(x.shape)}, w1p {tuple(w1p.shape)}, "
            f"b1p {tuple(b1p.shape)}, w2p {tuple(w2p.shape)}, "
            f"b2 {tuple(b2.shape)} do not chain")
    y = torch.empty((n, b, d2), dtype=torch.float32, device=dev)
    fn = _build.load("masked_ffn").masked_ffn_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(dev):
        err = fn(x.data_ptr(), w1p.data_ptr(), b1p.data_ptr(), w2p.data_ptr(),
                 b2.data_ptr(), y.data_ptr(), b, d, k, d2, n,
                 _build.stream_of(dev))
    _build.check_launch("masked_ffn", err)
    masked_ffn.launches += 1
    return y


#: Kernel launches since the count was last set to 0.
masked_ffn.launches = 0
