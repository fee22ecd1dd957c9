"""Pipeline parallelism: a GPipe stage runner on a "stage" mesh dim (the
port's twin of ``repro.distributed.pipeline``).

Layers are split into ``n_stages`` groups, one a rank of the mesh's
"stage" dim; microbatches stream through the stages, the activations
moving from stage s to s+1 by point-to-point sends
(``batch_isend_irecv``). The schedule is the classic GPipe fill / steady /
drain: with M microbatches and S stages, ticks t = 0..M+S-2, stage s works
on microbatch t-s when 0 <= t-s < M. Bubble fraction = (S-1)/(M+S-1).

Forward only, as in the reference (serving and eval pipelines; training
scales depth with FSDP + TP + remat instead).
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.core import tree as tree_lib
from repro_torch.launch import mesh as mesh_lib

Params = Any

__all__ = ["pipeline_forward", "bubble_fraction"]


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)


def pipeline_forward(mesh, stage_fn: Callable[[Params, torch.Tensor],
                                              torch.Tensor],
                     stage_params: Params, x: torch.Tensor,
                     n_micro: int) -> torch.Tensor:
    """Run ``x`` [B, ...] through ``n_stages`` pipeline stages; every rank
    returns the output.

    ``mesh`` holds a "stage" dim; ``stage_params`` leaves lead with the
    stage dim (every rank passes the whole stack and keeps its own slice);
    ``x`` is the same on every rank; every stage preserves the
    activation's shape (transformer blocks do), and its output is kept in
    ``x``'s dtype. A batch that ``n_micro`` does not divide raises
    ``ValueError`` before any communication. With one stage no message is
    sent."""
    n_stages = mesh_lib.mesh_shape(mesh)["stage"]
    b = x.shape[0]
    if b % n_micro != 0:
        raise ValueError(
            f"pipeline_forward: batch {b} not divisible by n_micro "
            f"{n_micro} — microbatching needs equal splits")
    micro = x.reshape(n_micro, b // n_micro, *x.shape[1:])
    stage = mesh.get_local_rank("stage")
    group = mesh.get_group("stage")
    params = tree_lib.tree_map(lambda a: a[stage], stage_params)
    outs = torch.zeros_like(micro)          # the last stage collects
    recv = torch.empty_like(micro[0])
    prev = next_ = None
    if n_stages > 1:
        ranks = [dist.get_global_rank(group, i) for i in range(n_stages)]
        prev = ranks[stage - 1] if stage > 0 else None
        next_ = ranks[stage + 1] if stage < n_stages - 1 else None
    y = None
    for t in range(n_micro + n_stages - 1):
        mb = t - stage                      # this stage's microbatch
        active = 0 <= mb < n_micro
        # the exchange of tick t-1's outputs: stage s-1 sends microbatch
        # t-s, which stage s works on now
        ops = []
        if next_ is not None and 0 <= mb - 1 < n_micro:
            ops.append(dist.P2POp(dist.isend, y, next_, group))
        if prev is not None and active:
            ops.append(dist.P2POp(dist.irecv, recv, prev, group))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        if not active:
            continue
        h = micro[mb] if stage == 0 else recv
        y = stage_fn(params, h).to(micro.dtype).contiguous()
        if stage == n_stages - 1:
            outs[mb] = y
    if n_stages > 1:                        # the last stage's outputs to all
        dist.broadcast(outs, src=dist.get_global_rank(group, n_stages - 1),
                       group=group)
    return outs.reshape(b, *x.shape[1:])
