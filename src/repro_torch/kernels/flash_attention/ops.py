"""Public wrapper of the flash_attention kernel
(``csrc/flash_attention.cu``).

Dispatch is by device: a CPU (or ``meta``) tensor takes the plain version
(:func:`ref.flash_attention_ref`, the port's prefill attention), a CUDA
tensor launches the kernel or raises. Every arm of the TPU kernel runs on
the card: causal or full at any Sq and Skv (the causal mask top-left
aligned: row i sees keys j <= i), GQA, and any head width (above 256 on
the kernel's wide arm). No padding: the kernel masks ragged Sq, Skv and
dh. The one limit, from the kernel's int32 tile arithmetic: Sq, Skv and dh
below ``MAX_DIM``.

DTensor operands run the same wrapper on each rank's local shard
(``local_map``), one launch a rank: a sequence dim sharded anywhere is
gathered first (the KV-sequence layout: each query needs every key), a
partial sum reduced, and the key/value heads take the query's head shards
(head-TP: local query heads read local KV heads) where their count divides,
else every head is gathered.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ref as _ref

__all__ = ["flash_attention", "MAX_DIM"]

#: Sq, Skv and dh each stay below this (``kMaxDim`` of the kernel).
MAX_DIM = 1 << 30
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float]
             + [ctypes.c_int] + [ctypes.c_void_p])
_ENTRIES = {torch.float32: "flash_attention_f32_launch",
            torch.bfloat16: "flash_attention_bf16_launch"}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, chunk: int = 1024) -> torch.Tensor:
    """q [B, H, Sq, dh], k/v [B, Hkv, Skv, dh] (fp32 or bf16, one dtype)
    -> [B, H, Sq, dh] in q's dtype; q-head h reads kv-head
    ``h // (H // Hkv)``. Causal masks key j for row i when j > i, at any
    Sq and Skv. ``chunk`` is the query-chunk length of the plain version
    (its peak memory); the kernel does not read it."""
    _build.check_no_grad("flash_attention", q=q, k=k, v=v)
    from torch.distributed.tensor import DTensor
    if isinstance(q, DTensor):
        return _on_local_shards(q, k, v, causal, chunk)
    if q.device.type in _build.PLAIN_DEVICES:
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
    if max(sq, skv, dh) >= MAX_DIM:
        raise ValueError(f"flash_attention: Sq {sq}, Skv {skv} or head "
                         f"width {dh} is not below {MAX_DIM}")
    o = torch.empty_like(q)
    fn = _build.bind("flash_attention", _ENTRIES[q.dtype], _ARGTYPES)
    with _build.on_device(dev):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b,
                 h, hkv, sq, skv, dh, math.sqrt(dh), int(causal),
                 _build.stream_of(dev))
    _build.check_launch("flash_attention", err)
    flash_attention.launches += 1
    if q.dtype == torch.float32:
        flash_attention.launches_f32 += 1
    return o


#: Kernel launches since the count was last set to 0.
flash_attention.launches = 0
#: Of them, fp32 launches (the 3xTF32 kernels), counted apart.
flash_attention.launches_f32 = 0


def _on_local_shards(q, k, v, causal: bool, chunk: int) -> torch.Tensor:
    """:func:`flash_attention` on DTensors: batch and head shards kept,
    the sequence dims (and any head shard the KV heads cannot follow)
    gathered, then one wrapper call a rank on its local q/k/v; the output
    takes q's layout."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    hkv = k.shape[1]
    pl = tuple(Replicate() if d.is_partial() or (
                   d.is_shard() and (d.dim >= 2 or (
                       d.dim == 1 and hkv % mesh.size(i))))
               else d for i, d in enumerate(q.placements))
    q, k, v = (t.redistribute(mesh, pl) for t in (q, k, v))
    return local_map(
        lambda a, b, c: flash_attention(a.contiguous(), b.contiguous(),
                                        c.contiguous(), causal=causal,
                                        chunk=chunk),
        out_placements=(pl,), in_placements=(pl, pl, pl),
        device_mesh=mesh)(q, k, v)
