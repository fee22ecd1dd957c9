"""Public wrappers of the rglru_scan kernels (``csrc/rglru_scan.cu``), and
the differentiable scan over them.

Dispatch is by device: a CPU (or ``meta``) tensor takes the plain version
(:mod:`ref`), a CUDA tensor launches the kernel or raises. No padding: the
kernels mask ragged B and W and take any S >= 1.

The wrappers fill their outputs through ``ctypes``, which autograd cannot
see, so they refuse operands that require grad while autograd records
(``_build.check_no_grad``). Training reaches the kernel through
:class:`RGLRUScan`, whose forward is the forward launch and whose backward
is the backward launch: the same recurrence in reverse time.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rglru_scan import ref as _ref

__all__ = ["rglru_scan", "rglru_scan_backward", "RGLRUScan"]

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_BWD_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                 + [ctypes.c_void_p])


def _check_shapes(kernel: str, **operands: torch.Tensor) -> tuple:
    shapes = {t.shape for t in operands.values()}
    first = next(iter(operands.values()))
    if len(shapes) != 1 or first.ndim != 3 or first.numel() == 0:
        raise ValueError(f"{kernel}: " + " and ".join(
            f"{n} {tuple(t.shape)}" for n, t in operands.items())
            + " must be one non-empty [B, S, W]")
    return tuple(first.shape)


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b [B, S, W] fp32 -> h [B, S, W] fp32 with
    ``h_t = a_t h_{t-1} + b_t`` from a zero state."""
    _build.check_no_grad("rglru_scan", a=a, b=b)
    if a.device.type in _build.PLAIN_DEVICES:
        return _ref.rglru_scan_ref(a, b)
    dev = _build.check_operands("rglru_scan", a=a, b=b)
    bsz, s, w = _check_shapes("rglru_scan", a=a, b=b)
    h = torch.empty_like(a)
    fn = _build.bind("rglru_scan", "rglru_scan_launch", _ARGTYPES)
    with _build.on_device(dev):
        err = fn(a.data_ptr(), b.data_ptr(), h.data_ptr(), bsz, s, w,
                 _build.stream_of(dev))
    _build.check_launch("rglru_scan", err)
    rglru_scan.launches += 1
    return h


#: Launches of ``rglru_scan.cu``'s kernels since the count was last set to
#: 0, the backward's (:func:`rglru_scan_backward`) among them;
#: ``backward_launches`` counts those alone.
rglru_scan.launches = 0
rglru_scan.backward_launches = 0


def rglru_scan_backward(a: torch.Tensor, h: torch.Tensor, g: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The scan's backward: a, h (the forward's output) and g = dL/dh
    [B, S, W] fp32 -> (da, db) [B, S, W] fp32, with
    ``dh_t = g_t + a_{t+1} dh_{t+1}``, ``db = dh``, ``da_t = dh_t h_{t-1}``.
    Counts on ``rglru_scan.launches`` and ``rglru_scan.backward_launches``.
    """
    _build.check_no_grad("rglru_scan_backward", a=a, h=h, g=g)
    if a.device.type in _build.PLAIN_DEVICES:
        return _ref.rglru_scan_bwd_ref(a, h, g)
    dev = _build.check_operands("rglru_scan_backward", a=a, h=h, g=g)
    bsz, s, w = _check_shapes("rglru_scan_backward", a=a, h=h, g=g)
    da, db = torch.empty_like(a), torch.empty_like(a)
    fn = _build.bind("rglru_scan", "rglru_scan_bwd_launch", _BWD_ARGTYPES)
    with _build.on_device(dev):
        err = fn(a.data_ptr(), h.data_ptr(), g.data_ptr(), da.data_ptr(),
                 db.data_ptr(), bsz, s, w, _build.stream_of(dev))
    _build.check_launch("rglru_scan_backward", err)
    rglru_scan.launches += 1
    rglru_scan.backward_launches += 1
    return da, db


class RGLRUScan(torch.autograd.Function):
    """``h = scan(a, b)`` with its gradient through the kernels: the
    forward is one :func:`rglru_scan` launch and saves ``a`` and ``h``; the
    backward is one :func:`rglru_scan_backward` launch. On the CPU both
    run their plain versions, so the CPU tests hold the backward's algebra
    against JAX's autodiff of the associative scan."""

    @staticmethod
    def forward(ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        a = a.detach()
        h = rglru_scan(a, b.detach())
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        a, h = ctx.saved_tensors
        da, db = rglru_scan_backward(a, h, g.contiguous())
        return da, db
