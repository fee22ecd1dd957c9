"""Fused whole-plan executor: spec IR + the plain PyTorch versions.

This module owns the contract between ``core/plan.lower_fused`` and the CUDA
kernels of ``csrc/fused_plan.cu``: a :class:`FusedSpec` is a flat, hashable
chain of dense/elementwise steps over a running hidden state, with every
weight either sample-shared or per-sample-row (``n_rows = groups × n_masks``
packed weight sets). :func:`fused_plan_ref` and :func:`fused_moments_ref`
run the chain with plain tensor products — the same contraction order as the
per-op ``plan.execute`` path. The wrappers in ``ops.py`` take them for CPU
tensors; ``chip_smoke.py`` holds the kernels to them on the card.

Params travel as a flat tuple ordered by :func:`param_slots`: for each dense
step, ``w`` then (if present) shared bias ``b`` then per-sample bias ``bp``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F

__all__ = ["FusedStep", "FusedSpec", "FusedPlanUnsupported", "ACTIVATIONS",
           "act_fn", "split_prefix", "param_slots", "fused_plan_ref",
           "fused_moments_ref"]


class FusedPlanUnsupported(NotImplementedError):
    """Raised when a PackedPlan cannot run through the fused executor
    (unknown op kind, or a per-row footprint the kernel cannot hold in
    shared memory). Callers fall back to the per-op ``plan.execute``."""


#: The one activation-name table of the port (core/plan resolves its op
#: activations here too). GELU is the tanh form: ``jax.nn.gelu``'s default,
#: and the form the CUDA kernels compute.
ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "relu": torch.relu, "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu, "sigmoid": torch.sigmoid, "tanh": torch.tanh,
    "identity": lambda x: x,
}


def act_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """Resolve an activation name ('gelu_mlp' is the plain-MLP gelu)."""
    return ACTIVATIONS["gelu" if name == "gelu_mlp" else name]


@dataclasses.dataclass(frozen=True)
class FusedStep:
    """One step of the fused chain.

    kind='dense': ``h @ w (+ b) (+ bp[n]) -> activation`` with ``w`` indexed
    by the sample row when ``per_sample`` (``[n_rows, d_in, d_out]``) and
    shared (``[d_in, d_out]``) otherwise. kind='act': bare elementwise
    nonlinearity (no params; only emitted when it cannot fuse into the
    preceding dense). ``w_dtype`` tags a quantized weight; only the native
    fp32 form ("") runs in this port so far.
    """
    kind: str                       # 'dense' | 'act'
    activation: str | None = None
    per_sample: bool = False
    shared_bias: bool = False
    sample_bias: bool = False
    d_in: int = 0
    d_out: int = 0
    w_dtype: str = ""


@dataclasses.dataclass(frozen=True)
class FusedSpec:
    """Static description of a whole-plan fused execution (hashable — the
    cache key of the kernel's step layout in ``ops.py``)."""
    steps: tuple[FusedStep, ...]
    n_rows: int                     # kernel sample axis (groups × n_masks)
    n_masks: int
    groups: int
    d_in: int                       # chain input width
    d_out: int                      # final per-row output width

    def __post_init__(self) -> None:
        if self.n_rows != self.groups * self.n_masks:
            raise ValueError(f"n_rows {self.n_rows} != groups*n_masks")
        if not any(s.kind == "dense" for s in self.steps):
            raise FusedPlanUnsupported("fused chain has no dense step")
        for s in self.steps:
            if s.kind not in ("dense", "act"):
                raise FusedPlanUnsupported(f"step kind {s.kind!r}")
            if s.w_dtype:
                raise ValueError(
                    f"w_dtype={s.w_dtype!r}: quantized fused specs arrive "
                    f"with the port's int8 slice")

    @property
    def weight_elements(self) -> int:
        """Total weight+bias elements of the chain."""
        tot = 0
        for s in self.steps:
            if s.kind != "dense":
                continue
            rows = self.n_rows if s.per_sample else 1
            tot += rows * s.d_in * s.d_out
            if s.shared_bias:
                tot += s.d_out
            if s.sample_bias:
                tot += self.n_rows * s.d_out
        return tot


def split_prefix(spec: FusedSpec) -> int:
    """Index of the first step that depends on the sample row: steps before
    it are the shared prefix, which the moments kernel runs once per batch
    tile instead of once per row."""
    for i, st in enumerate(spec.steps):
        if st.per_sample or st.sample_bias:
            return i
    return len(spec.steps)


def param_slots(spec: FusedSpec) -> tuple[tuple[int, str], ...]:
    """Flat param ordering: (step index, 'w'|'b'|'bp') per array."""
    slots: list[tuple[int, str]] = []
    for i, st in enumerate(spec.steps):
        if st.kind != "dense":
            continue
        slots.append((i, "w"))
        if st.shared_bias:
            slots.append((i, "b"))
        if st.sample_bias:
            slots.append((i, "bp"))
    return tuple(slots)


def _slot_table(spec: FusedSpec, params: tuple[torch.Tensor, ...]
                ) -> dict[tuple[int, str], torch.Tensor]:
    slots = param_slots(spec)
    if len(slots) != len(params):
        raise ValueError(f"fused spec expects {len(slots)} params, "
                         f"got {len(params)}")
    return dict(zip(slots, params))


def fused_plan_ref(spec: FusedSpec, x: torch.Tensor,
                   params: tuple[torch.Tensor, ...]) -> torch.Tensor:
    """Plain version: x [B, d_in] -> per-row samples [n_rows, B, d_out].

    Shared prefix steps run once on [B, d]; the first per-sample step
    introduces the row axis and the rest of the chain is sample-major
    batched products (the batch-level contraction order).
    """
    table = _slot_table(spec, params)
    h = x
    for i, st in enumerate(spec.steps):
        if st.kind == "act":
            h = act_fn(st.activation)(h)
            continue
        w = table[(i, "w")]
        if st.per_sample:
            y = torch.matmul(h, w)      # [B,d]|[N,B,d] x [N,d,k] -> [N,B,k]
        else:
            y = h @ w
        if st.shared_bias:
            y = y + table[(i, "b")]
        if st.sample_bias:
            bp = table[(i, "bp")]
            if y.ndim == 2:             # per-sample bias on a shared value
                y = y[None] + bp[:, None, :]
            else:
                y = y + bp[:, None, :]
        if st.activation:
            y = act_fn(st.activation)(y)
        h = y
    if h.ndim == 2:                     # fully shared chain: rows identical
        h = h[None].expand((spec.n_rows,) + tuple(h.shape))
    return h


def fused_moments_ref(spec: FusedSpec, x: torch.Tensor,
                      params: tuple[torch.Tensor, ...]
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the in-kernel moments epilogue: x [B, d_in] ->
    (mean [B, groups·d_out], std [B, groups·d_out]); the reduction is over
    the ``n_masks`` rows *within* each group (ddof=0), matching
    ``uncertainty.predictive_moments`` of the group-unflattened samples."""
    s = fused_plan_ref(spec, x, params)          # [G·N, B, do]
    g, n = spec.groups, spec.n_masks
    b, do = s.shape[1], s.shape[2]
    sg = s.reshape(g, n, b, do)
    mean = sg.mean(dim=1).movedim(0, 1).reshape(b, g * do)
    std = sg.std(dim=1, correction=0).movedim(0, 1).reshape(b, g * do)
    return mean, std
