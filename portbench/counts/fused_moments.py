"""What the packed uIVIM-NET chain needs, counted from its shapes:
``fused_plan``'s moments mode (``fused_moments_kernel``) runs it for one
chunk of voxels. Mask-zero skipping leaves each (sub-network, mask) sample
a K1- and K2-wide hidden pair, K the mask's kept units; the count is the
same whatever implements the chain."""

from __future__ import annotations

__all__ = ["flops_per_voxel", "chunk_bound"]


def flops_per_voxel(width: int, groups: int, n_masks: int, k1: int,
                    k2: int) -> int:
    """Products of the packed chain for one voxel: every sub-network under
    every mask, width -> K1 -> K2 -> 1 (2 FLOPs a multiply-add)."""
    return groups * n_masks * 2 * (width * k1 + k1 * k2 + k2)


def chunk_bound(voxels: int, width: int, groups: int, n_masks: int, k1: int,
                k2: int) -> tuple[int, int]:
    """(FLOPs, bytes) of one chunk: the voxels' fp32 signals read once,
    (mean, std) of each sub-network's output written once, and the packed
    fp32 parameters (weights and biases) read once."""
    flops = voxels * flops_per_voxel(width, groups, n_masks, k1, k2)
    params = groups * n_masks * (width * k1 + k1 + k1 * k2 + k2 + k2 + 1)
    nbytes = 4 * (voxels * width + voxels * groups * 2 + params)
    return flops, nbytes
