"""Mask-zero skipping: fold fixed masks into packed dense weights (offline).

Every mask keeps exactly K of H hidden units (masks.py I2), so "skip the
zeros" becomes "gather the K kept columns/rows into smaller dense matrices",
one set per mask-sample:

    w1 [D, H], masks [N, H]  ->  w1p [N, D, K]     (+ b1p [N, K])
    w2 [H, D2]               ->  w2p [N, K, D2]

and ``relu(x @ w1 + b1) * mask @ w2`` becomes, exactly,
``relu(x @ w1p[i] + b1p[i]) @ w2p[i]``. The gathers here are the port's
twins of ``repro.core.packing``; :func:`kept_indices` is the same numpy
stable argsort, so both packages pack the same units in the same order.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["kept_indices", "gather_units", "pack_out_dim", "pack_in_dim",
           "pack_pair_dims"]


def kept_indices(masks: np.ndarray | torch.Tensor) -> np.ndarray:
    """[N, K] indices of kept units per mask. Requires uniform K (I2)."""
    if isinstance(masks, torch.Tensor):
        masks = masks.detach().cpu().numpy()
    masks = np.asarray(masks).astype(bool)
    counts = masks.sum(axis=1)
    if not (counts == counts[0]).all():
        raise ValueError(f"non-uniform keep counts {counts}; packing requires "
                         "rectangular masks (masks.py normalizes to K)")
    k = int(counts[0])
    # stable argsort puts the kept (True) positions first, in ascending index
    # order — the vectorized form of a per-row flatnonzero
    return np.argsort(~masks, axis=1, kind="stable")[:, :k]


def gather_units(w: torch.Tensor, idx: np.ndarray, axis: int) -> torch.Tensor:
    """Per-mask gather along one axis in a single index_select:
    w [..., H, ...] + idx [N, K] -> [N, ..., K, ...] (K replaces H)."""
    ax = axis % w.ndim
    n, k = idx.shape
    flat = torch.as_tensor(idx.reshape(-1), device=w.device)
    out = w.index_select(ax, flat)
    out = out.reshape(w.shape[:ax] + (n, k) + w.shape[ax + 1:])
    return out.movedim(ax, 0).contiguous()     # kernels take dense operands


def pack_out_dim(w: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
    """w [..., H] + idx [N, K] -> [N, ..., K] (gather kept output units)."""
    return gather_units(w, idx, axis=-1)


def pack_in_dim(w: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
    """w [H, ...] + idx [N, K] -> [N, K, ...] (gather kept input units)."""
    return gather_units(w, idx, axis=0)


def pack_pair_dims(w: torch.Tensor, idx_in: np.ndarray,
                   idx_out: np.ndarray) -> torch.Tensor:
    """w [H_in, H_out] -> [N, K_in, K_out]: paired per-mask gather of both
    dims (mask n's kept inputs pair with mask n's kept outputs)."""
    g = gather_units(w, idx_in, axis=0)            # [N, K_in, H_out]
    cols = torch.as_tensor(idx_out, device=w.device)[:, None, :]
    return torch.gather(g, 2, cols.expand(g.shape[0], g.shape[1], -1))
