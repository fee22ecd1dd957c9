"""Int8 compression (the port's twin of ``repro.distributed.compression``):
the symmetric per-row quantizer that int8 serving calls
(``core.plan._quantize_weight``), and the error-feedback gradient
transforms of the train step (``compress_tree``/``decompress_tree``,
``ef_init``/``ef_update``): the gradient plus the carried residual is
quantized per row, dequantized, and the quantization error carried into
the next step, so the applied updates stay unbiased over steps. Leaves of
fewer than two dims pass through raw (negligible bytes; quantizing them
hurts); the 2-D Masksembles ``masks`` are quantized like any matrix.
:func:`compressed_allreduce` is the int8 all-reduce over a process group:
the members agree on one per-row scale, and the sum runs over int32 words.

The arithmetic is the reference's, step for step, so the int8 values are
bit-equal on the same fp32 input, on the CPU and on the card: the scale is
``max(amax, 1e-12) / 127`` in fp32 (:func:`int8_scale`), the value is
divided by it (not multiplied by its reciprocal), and ``torch.round``
rounds half to even, as ``jnp.round`` does.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from repro_torch.core import tree as tree_lib

Params = Any

__all__ = ["int8_scale", "quantize_int8", "dequantize_int8",
           "compress_tree", "decompress_tree", "ef_init", "ef_update",
           "compressed_allreduce"]


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


def _compress(g: torch.Tensor) -> dict:
    if g.ndim < 2:
        return {"raw": g}
    q, s = quantize_int8(g)
    return {"q": q, "scale": s}


def _decompress(leaf: dict) -> torch.Tensor:
    if "raw" in leaf:
        return leaf["raw"]
    return dequantize_int8(leaf["q"], leaf["scale"])


def compress_tree(grads: Params) -> Params:
    """Gradient tree -> a tree of ``{"q", "scale"}`` (int8 rows and their
    fp32 scales), or ``{"raw"}`` for leaves of fewer than two dims."""
    return tree_lib.tree_map(_compress, grads)


def decompress_tree(comp: Params) -> Params:
    """The inverse of :func:`compress_tree` (fp32 for quantized leaves)."""
    if isinstance(comp, dict) and ("raw" in comp or "q" in comp):
        return _decompress(comp)
    if isinstance(comp, dict):
        return {k: decompress_tree(v) for k, v in comp.items()}
    return type(comp)(decompress_tree(v) for v in comp)


def ef_init(grads_like: Params) -> Params:
    """A zero fp32 residual shaped like ``grads_like``."""
    return tree_lib.tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads_like)


@torch.no_grad()
def ef_update(grads: Params, residual: Params) -> tuple[Params, Params]:
    """Error feedback: corrected = grads + residual (fp32); returns
    (dequantize(quantize(corrected)), corrected - that). Leaf by leaf, so
    one leaf's fp32 temporaries are alive at a time; the trees passed in
    are left as they were."""
    deq, res = [], []
    for g, r in zip(tree_lib.leaves(grads), tree_lib.leaves(residual)):
        corrected = g.float() + r
        d = _decompress(_compress(corrected))
        deq.append(d)
        res.append(corrected - d)
    return (tree_lib.unflatten(grads, deq),
            tree_lib.unflatten(residual, res))


def compressed_allreduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """The int8-quantized sum of ``x`` [..., d] over ``group`` (a process
    group; None is the default one), every member's fp32 result the same.

    The members first agree on one per-row scale (a MAX all-reduce of
    their local amax: a scalar a row), quantize onto that shared grid
    (a true division, round half to even, clip to ±127), and the
    reduction itself runs over **int32** words, dequantized once. The
    int32 sum is exact for groups of up to ``2^24 / 127`` members; the
    arithmetic is the reference's, so the result is bit-equal to its
    ``shard_map`` form on the same inputs."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = int8_scale(amax)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int32)
    dist.all_reduce(q, op=dist.ReduceOp.SUM, group=group)
    return q.float() * scale
