"""A frozen copy of the port's Masksembles mask construction
(``repro_torch.core.masks`` as of this benchmark's first version).

The benchmark makes the masks of every configuration with this copy and
hands the same masks to the program and to the plain references, so a later
change to the program's generator cannot move the yardstick. Numpy only.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["keep_rate", "keep_count", "generate_masks"]


def keep_rate(n_masks: int, scale: float) -> float:
    """Fraction of units each individual mask keeps.

    From the Masksembles construction: a layer of width ``c`` is covered by
    masks each keeping ``m`` units with ``c = m * s * (1 - (1 - 1/s)^n)``,
    hence ``m / c = 1 / (s * (1 - (1 - 1/s)^n))``.
    """
    if scale == 1.0:
        return 1.0
    s, n = float(scale), int(n_masks)
    return 1.0 / (s * (1.0 - (1.0 - 1.0 / s) ** n))


def keep_count(width: int, n_masks: int, scale: float) -> int:
    """Exact per-mask keep count K (>=1, <=width)."""
    k = int(round(width * keep_rate(n_masks, scale)))
    return max(1, min(width, k))


def generate_masks_rotation(width: int, n_masks: int, keep: int,
                            seed: int = 0) -> np.ndarray:
    """Deterministic structured masks: rotated K-windows over a permutation.

    Mask ``i`` keeps positions ``perm[(i * stride + j) % width]`` for
    ``j < keep``. Uniform K by construction; coverage holds whenever
    ``keep * n_masks >= width`` because consecutive windows advance by
    ``stride = ceil(width / n_masks) <= keep``.
    """
    if not (1 <= keep <= width):
        raise ValueError(f"keep must be in [1, {width}], got {keep}")
    rng = np.random.default_rng(seed)
    perm = rng.permutation(width)
    stride = math.ceil(width / n_masks)
    masks = np.zeros((n_masks, width), dtype=bool)
    for i in range(n_masks):
        idx = [(i * stride + j) % width for j in range(keep)]
        masks[i, perm[idx]] = True
    return masks


def generate_masks_masksembles(width: int, n_masks: int, scale: float,
                               seed: int = 0,
                               max_tries: int = 200) -> np.ndarray | None:
    """Official Masksembles rejection construction.

    Draw ``n`` random ``m``-subsets of ``ceil(m*s)`` abstract positions, drop
    positions no mask keeps, accept when the surviving width equals the layer
    width. We search ``m`` in a small neighbourhood of the analytic value to
    make acceptance fast; returns None if the search fails (caller falls back
    to the rotation construction).
    """
    if scale == 1.0:
        return np.ones((n_masks, width), dtype=bool)
    rng = np.random.default_rng(seed)
    m0 = max(1, keep_count(width, n_masks, scale))
    for m in _search_order(m0):
        total = int(round(m * scale))
        if total < m:
            continue
        for _ in range(max_tries // 10):
            draws = np.zeros((n_masks, total), dtype=bool)
            for i in range(n_masks):
                draws[i, rng.choice(total, size=m, replace=False)] = True
            alive = draws.any(axis=0)
            if int(alive.sum()) == width:
                return draws[:, alive]
    return None


def _search_order(m0: int):
    yield m0
    for d in range(1, 16):
        yield m0 + d
        if m0 - d >= 1:
            yield m0 - d


def generate_masks(width: int, n_masks: int, scale: float,
                   seed: int = 0) -> np.ndarray:
    """Fixed masks [n_masks, width] (bool); official construction with
    deterministic rotation fallback; every mask keeps exactly
    ``keep_count`` units."""
    keep = keep_count(width, n_masks, scale)
    masks = generate_masks_masksembles(width, n_masks, scale, seed=seed)
    if masks is None:
        masks = generate_masks_rotation(width, n_masks, keep, seed=seed)
    # The rejection construction can yield per-mask counts off-by-one from K;
    # normalize to exactly K so downstream packing is rectangular (I2).
    masks = _normalize_keep_counts(masks, keep,
                                   np.random.default_rng(seed + 1))
    return masks


def _normalize_keep_counts(masks: np.ndarray, keep: int,
                           rng: np.random.Generator) -> np.ndarray:
    """Adjust each mask to exactly ``keep`` ones, preserving coverage greedily."""
    masks = masks.copy()
    n, width = masks.shape
    keep = min(keep, width)
    for i in range(n):
        ones = np.flatnonzero(masks[i])
        if len(ones) > keep:
            # Drop from positions other masks also cover, least-needed first.
            need = len(ones) - keep
            cover = masks.sum(axis=0)
            order = ones[np.argsort(-cover[ones], kind="stable")]
            drop = [p for p in order if cover[p] > 1][:need]
            # If coverage cannot be preserved, drop arbitrarily (rare).
            if len(drop) < need:
                dropped = set(drop)
                drop.extend(p for p in ones if p not in dropped)
            masks[i, drop[:need]] = False
        elif len(ones) < keep:
            zeros = np.flatnonzero(~masks[i])
            cover = masks.sum(axis=0)
            order = zeros[np.argsort(cover[zeros], kind="stable")]
            masks[i, order[: keep - len(ones)]] = True
    return masks
