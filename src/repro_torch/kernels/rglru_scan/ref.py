"""Plain PyTorch version of the rglru_scan kernel (``csrc/rglru_scan.cu``).

It is the reference's own scan: the odd/even recursion of
``jax.lax.associative_scan`` (log-depth; pairs of neighbours combined,
the half-length scan solved recursively, the even positions filled in
from it) with the combine of ``repro.kernels.rglru_scan.ref``, so that its
products and sums are taken in the reference's order. The kernel runs the
recurrence step by step instead; the two agree to fp32 rounding.

The backward (:func:`rglru_scan_bwd_ref`) is the same scan run over
reversed time: ``dh_t = g_t + a_{t+1} dh_{t+1}`` from ``dh_S = 0``, then
``db = dh`` and ``da_t = dh_t h_{t-1}`` with ``h_{-1} = 0`` — the
plain version of ``csrc/rglru_scan.cu``'s backward kernel.
"""

from __future__ import annotations

import torch

__all__ = ["rglru_scan_ref", "rglru_scan_bwd_ref"]


def _combine(a1, b1, a2, b2):
    """(a2, b2) after (a1, b1): ``(a1 a2, a2 b1 + b2)``."""
    return a1 * a2, a2 * b1 + b2


def _scan(a: torch.Tensor, b: torch.Tensor):
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine(a[:, 0:n - 1:2], b[:, 0:n - 1:2], a[:, 1::2],
                      b[:, 1::2])
    oa, ob = _scan(ra, rb)                      # prefixes at 1, 3, 5, ...
    if n % 2 == 0:
        oa_, ob_ = oa[:, :-1], ob[:, :-1]
    else:
        oa_, ob_ = oa, ob
    ea, eb = _combine(oa_, ob_, a[:, 2::2], b[:, 2::2])   # at 2, 4, ...
    out_a, out_b = torch.empty_like(a), torch.empty_like(b)
    out_a[:, 0], out_b[:, 0] = a[:, 0], b[:, 0]
    out_a[:, 2::2], out_b[:, 2::2] = ea, eb
    out_a[:, 1::2], out_b[:, 1::2] = oa, ob
    return out_a, out_b


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0: a, b [B, S, W] -> h
    [B, S, W]."""
    return _scan(a, b)[1]


def rglru_scan_bwd_ref(a: torch.Tensor, h: torch.Tensor, g: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """a, h (the forward's output) and g = dL/dh [B, S, W] -> (da, db)
    [B, S, W]."""
    a_next = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], 1)
    dh = _scan(a_next.flip(1), g.flip(1))[1].flip(1)
    h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], 1)
    return dh * h_prev, dh
