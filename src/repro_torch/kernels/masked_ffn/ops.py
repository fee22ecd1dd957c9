"""Public wrapper of the masked_ffn kernel (``csrc/masked_ffn.cu``).

Dispatch is by device: a CPU tensor takes the plain version
(:func:`ref.masked_ffn_ref`), a CUDA tensor launches the kernel or raises.
No padding: the kernel masks ragged B, D, K and D2 itself. With scales the
int8 body runs: int8 weights, bf16 scales and bf16 biases are read as
stored and dequantized in the kernel. ``sample_major`` picks the kernel's
grid order (the reference's name and default): the paper's batch-level
schedule, or with ``False`` the sampling-level one; one block body serves
both, so the two orders give bit-equal results.
:func:`masked_ffn_all_samples` is the unpacked entry: plain weights and
masks in, packed by mask-zero skipping (``core.plan.compile_masked_ffn``)
and run through this kernel.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.masked_ffn import ref as _ref

__all__ = ["masked_ffn", "masked_ffn_all_samples"]

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_Q_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_INT8_DTYPES = {"w1p": torch.int8, "w2p": torch.int8, "w1s": torch.bfloat16,
                "w2s": torch.bfloat16, "b1p": torch.bfloat16,
                "b2": torch.bfloat16}


def masked_ffn(x: torch.Tensor, w1p: torch.Tensor, b1p: torch.Tensor,
               w2p: torch.Tensor, b2: torch.Tensor,
               w1s: torch.Tensor | None = None,
               w2s: torch.Tensor | None = None, *,
               sample_major: bool = True) -> torch.Tensor:
    """x [B, D], w1p [N, D, K], b1p [N, K], w2p [N, K, D2], b2 [D2] ->
    ``relu(x @ w1p[n] + b1p[n]) @ w2p[n] + b2`` as [N, B, D2] (fp32).

    ``w1s``/``w2s`` (both or neither; [N, 1, K] / [N, 1, D2] bf16) are the
    per-output-channel scales of int8 ``w1p``/``w2p``; the int8 body takes
    bf16 biases, the int8 serving bundle's storage. ``sample_major=True``
    runs the batch-level grid order (a sample's voxel tiles one after
    another), ``False`` the sampling-level one (a tile's samples one after
    another); the plain version has no grid and ignores it."""
    if (w1s is None) != (w2s is None):
        raise ValueError("masked_ffn: w1s and w2s must be passed together")
    quant = w1s is not None
    _build.check_no_grad("masked_ffn", x=x, w1p=w1p, b1p=b1p, w2p=w2p,
                         b2=b2, w1s=w1s, w2s=w2s)
    if x.device.type == "cpu":
        return _ref.masked_ffn_ref(x, w1p, b1p, w2p, b2, w1s, w2s,
                                   sample_major=sample_major)
    scales = {"w1s": w1s, "w2s": w2s} if quant else {}
    dev = _build.check_operands("masked_ffn", _INT8_DTYPES if quant else None,
                                x=x, w1p=w1p, b1p=b1p, w2p=w2p, b2=b2,
                                **scales)
    b, d = x.shape
    n, _, k = w1p.shape
    d2 = w2p.shape[-1]
    if (w1p.shape != (n, d, k) or b1p.shape != (n, k)
            or w2p.shape != (n, k, d2) or b2.shape != (d2,)
            or (quant and (w1s.shape != (n, 1, k)
                           or w2s.shape != (n, 1, d2)))):
        raise ValueError(
            f"masked_ffn: shapes x {tuple(x.shape)}, w1p {tuple(w1p.shape)}, "
            f"b1p {tuple(b1p.shape)}, w2p {tuple(w2p.shape)}, "
            f"b2 {tuple(b2.shape)}"
            + (f", w1s {tuple(w1s.shape)}, w2s {tuple(w2s.shape)}"
               if quant else "") + " do not chain")
    y = torch.empty((n, b, d2), dtype=torch.float32, device=dev)
    with _build.on_device(dev):
        if quant:
            fn = _build.bind("masked_ffn", "masked_ffn_q_launch", _Q_ARGTYPES)
            err = fn(x.data_ptr(), w1p.data_ptr(), w1s.data_ptr(),
                     b1p.data_ptr(), w2p.data_ptr(), w2s.data_ptr(),
                     b2.data_ptr(), y.data_ptr(), b, d, k, d2, n,
                     int(sample_major), _build.stream_of(dev))
        else:
            fn = _build.bind("masked_ffn", "masked_ffn_launch", _ARGTYPES)
            err = fn(x.data_ptr(), w1p.data_ptr(), b1p.data_ptr(),
                     w2p.data_ptr(), b2.data_ptr(), y.data_ptr(), b, d, k,
                     d2, n, int(sample_major), _build.stream_of(dev))
    _build.check_launch("masked_ffn", err)
    masked_ffn.launches += 1
    if quant:
        masked_ffn.int8_launches += 1
    return y


#: Kernel launches since the count was last set to 0 (``int8_launches``:
#: those of the int8 body among them).
masked_ffn.launches = 0
masked_ffn.int8_launches = 0


def masked_ffn_all_samples(x: torch.Tensor, w1: torch.Tensor,
                           b1: torch.Tensor, w2: torch.Tensor,
                           b2: torch.Tensor, masks, *,
                           device: torch.device | str | None = None
                           ) -> torch.Tensor:
    """x [B, D], w1 [D, F], b1 [F], w2 [F, D2], b2 [D2], masks [N, F] ->
    ``relu(x @ w1 + b1) * masks[n] @ w2 + b2`` as [N, B, D2]
    (:func:`ref.unpacked_masked_ffn_ref`). Compiles a one-pair plan
    (mask-zero skipping) and executes it: one :func:`masked_ffn` launch on
    the card (``device=None``), its plain version with ``device="cpu"``."""
    from repro_torch.core import plan as plan_lib    # plan imports this module
    plan = plan_lib.compile_masked_ffn(w1, b1, w2, b2, masks)
    return plan_lib.execute(plan, x, device=device)
