"""Masksembles mask generation (Durasov et al., CVPR'21) — offline, fixed masks.

The paper's central algorithmic move is replacing runtime Bernoulli dropout with
``n`` *pre-generated, fixed* binary masks over a hidden dimension. Fixedness is
what unlocks both hardware optimizations (mask-zero skipping and the batch-level
scheme), so mask generation lives here as a pure, seeded, **numpy** (host-side,
compile-time-constant) routine: masks never enter the model as runtime
randomness.

The port's own copy of ``repro.core.masks`` (which is numpy-only): the same
seeded construction, so ``generate_masks`` returns identical arrays
(tests/test_torch_core.py holds the two equal).

Two generators are provided:

* :func:`generate_masks_masksembles` — the official Masksembles rejection
  construction, parameterized by ``scale`` (s=1 → identical all-ones masks,
  larger s → less overlap, approaching Deep-Ensembles-like independence).
* :func:`generate_masks_rotation` — a deterministic structured fallback with
  identical invariants (used when the rejection search cannot hit the requested
  width exactly, and for reproducible tiny test configs).

Invariants (property-tested on the reference in tests/test_core_masks.py):
  I1. shape == (n_masks, width), dtype bool.
  I2. every mask keeps exactly K units (uniform K — required for packing).
  I3. every unit is kept by >= 1 mask whenever K * n_masks >= width
      (full coverage: no permanently-dead unit).
  I4. masks are pairwise distinct for scale > 1 (decorrelation).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = [
    "MaskSpec",
    "keep_rate",
    "keep_count",
    "generate_masks",
    "generate_masks_masksembles",
    "generate_masks_rotation",
    "mask_overlap_matrix",
]


@dataclasses.dataclass(frozen=True)
class MaskSpec:
    """Static description of a Masksembles configuration.

    Attributes:
      width: hidden dimension the masks cover.
      n_masks: number of samples ``N`` (paper sweeps 4, 8, 16, 32, 64).
      scale: Masksembles scale ``s`` >= 1 (paper grid-searches dropout rates
        0.1..0.9; scale maps monotonically onto an effective drop rate).
      seed: host RNG seed — masks are part of the model configuration and
        must be bit-reproducible across restarts/hosts.
    """

    width: int
    n_masks: int
    scale: float
    seed: int = 0

    def __post_init__(self) -> None:
        if self.width <= 0:
            raise ValueError(f"width must be positive, got {self.width}")
        if self.n_masks <= 0:
            raise ValueError(f"n_masks must be positive, got {self.n_masks}")
        if self.scale < 1.0:
            raise ValueError(f"scale must be >= 1, got {self.scale}")

    @property
    def keep(self) -> int:
        return keep_count(self.width, self.n_masks, self.scale)


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


def generate_masks(spec: MaskSpec) -> np.ndarray:
    """Generate fixed masks for ``spec``; official construction with
    deterministic rotation fallback. Always satisfies invariants I1–I4."""
    masks = generate_masks_masksembles(spec.width, spec.n_masks, spec.scale,
                                       seed=spec.seed)
    if masks is None:
        masks = generate_masks_rotation(spec.width, spec.n_masks, spec.keep,
                                        seed=spec.seed)
    # The rejection construction can yield per-mask counts off-by-one from K;
    # normalize to exactly K so downstream packing is rectangular (I2).
    masks = _normalize_keep_counts(masks, spec.keep,
                                   np.random.default_rng(spec.seed + 1))
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


def mask_overlap_matrix(masks: np.ndarray) -> np.ndarray:
    """Pairwise IoU between masks — the paper's 'less correlated' diagnostic."""
    m = masks.astype(np.float64)
    inter = m @ m.T
    union = m.sum(1)[:, None] + m.sum(1)[None, :] - inter
    return inter / np.maximum(union, 1.0)
