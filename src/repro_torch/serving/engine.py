"""Voxel-uncertainty serving: the IVIM half of ``repro.serving.engine``.

A compiled :class:`~repro_torch.core.plan.PackedPlan` is served on a voxel
batch or a whole scan: the voxels stream through one per-chunk moments
runner in fixed-size chunks (the last one zero-padded, so every launch sees
one shape), and the per-chunk (mean, std) are reassembled. By default the
runner is the fused whole-plan kernel with its in-kernel moments epilogue
(one launch per chunk); the per-op executor (one masked_ffn launch per chunk,
then two-pass moments) is its fallback.
"""

from __future__ import annotations

import collections
from typing import Callable

import torch

from repro_torch import device as device_lib
from repro_torch.core import plan as plan_lib
from repro_torch.core import scheduler as scheduler_lib
from repro_torch.core import uncertainty as unc_lib

__all__ = ["plan_chunk_runner", "predict_packed", "predict_volume",
           "fallback_counts"]

#: Fallbacks to the per-op executor taken by ``fused=None`` runners, keyed
#: by where the fused path was refused: "build" (no fused lowering) or
#: "call" (the kernel's residency guard, at the first chunk).
fallback_counts: collections.Counter = collections.Counter()


def plan_chunk_runner(plan: plan_lib.PackedPlan, *,
                      fused: bool | None = None,
                      device: torch.device | str | None = None):
    """The per-chunk moments executor of one plan: a callable
    ``xc [chunk, D] -> (mean [chunk, d_out], std)``.

    ``fused=True`` requires the whole-plan kernel with the in-kernel moments
    epilogue and surfaces :class:`plan_lib.FusedPlanUnsupported`;
    ``fused=False`` forces the per-op path (one masked_ffn launch per
    PackedPair, then ``uncertainty.predictive_moments``); ``None`` tries
    fused and falls back per-op only on ``FusedPlanUnsupported`` — at build
    when the plan has no fused lowering, or at the first call when the
    shared-memory residency guard fires (every chunk has one shape, so the
    choice is made once). Any other exception propagates.
    """
    dev = device_lib.resolve(device)
    plan = plan.to(dev)

    def per_op(xc):
        return unc_lib.predictive_moments(
            plan_lib.execute(plan, xc, device=dev))

    if fused is False:
        return per_op
    try:
        run = plan_lib.fused_executor(plan, moments=True, device=dev)
    except plan_lib.FusedPlanUnsupported:
        if fused:
            raise
        fallback_counts["build"] += 1
        return per_op
    if fused:
        return run

    state: dict[str, Callable] = {}

    def runner(xc):
        fn = state.get("fn")
        if fn is not None:
            return fn(xc)
        try:
            out = run(xc)          # the residency guard fires here
        except plan_lib.FusedPlanUnsupported:
            fallback_counts["call"] += 1
            state["fn"] = per_op
            return per_op(xc)
        state["fn"] = run
        return out

    return runner


def predict_packed(plan: plan_lib.PackedPlan, x: torch.Tensor, *,
                   chunk: int | None = None, fused: bool | None = None,
                   device: torch.device | str | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Serve a compiled PackedPlan on a voxel batch: x [B, D] ->
    (mean [B, d_out], std [B, d_out]) on ``device`` (None -> the card).

    ``fused`` selects the executor as in :func:`plan_chunk_runner`.
    ``chunk`` bounds the resident batch: the voxels stream through one
    runner in ``chunk``-row slices (``scheduler.chunk_bounds``, the last
    slice zero-padded to the chunk shape, pad rows dropped), so each chunk
    is exactly one fused launch.
    """
    dev = device_lib.resolve(device)
    plan = plan.to(dev)
    x = x.to(dev)
    b = x.shape[0]
    if chunk is None or chunk >= b:
        if fused is not False:
            try:
                run = plan_lib.fused_executor(plan, moments=True, device=dev)
                return run(x)
            except plan_lib.FusedPlanUnsupported:
                if fused:
                    raise
        return unc_lib.predictive_moments(
            plan_lib.execute(plan, x, device=dev))

    runner = plan_chunk_runner(plan, fused=fused, device=dev)
    means, stds = [], []
    for lo, hi in scheduler_lib.chunk_bounds(b, chunk):
        xc = x[lo:hi]
        if hi - lo < chunk:
            pad = x.new_zeros((chunk - (hi - lo),) + tuple(x.shape[1:]))
            xc = torch.cat([xc, pad])
        mean, std = runner(xc)
        means.append(mean)
        stds.append(std)
    return torch.cat(means)[:b], torch.cat(stds)[:b]


def predict_volume(plan: plan_lib.PackedPlan, volume: torch.Tensor, *,
                   chunk: int = 4096, fused: bool | None = None,
                   device: torch.device | str | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stream a clinical scan through the executor: volume [..., D] (e.g.
    ``[X, Y, Z, n_bvalues]``) -> (mean, std), each ``[..., d_out]``. The
    voxel grid is flattened, served by :func:`predict_packed` in fixed
    ``chunk``-voxel slices and reshaped back to the scan's layout."""
    if volume.ndim < 2:
        raise ValueError(f"volume must be [..., D], got {tuple(volume.shape)}")
    lead = tuple(volume.shape[:-1])
    x = volume.reshape(-1, volume.shape[-1])
    mean, std = predict_packed(plan, x, chunk=chunk, fused=fused,
                               device=device)
    return (mean.reshape(lead + (mean.shape[-1],)),
            std.reshape(lead + (std.shape[-1],)))
