"""Elastic remesh planning: device loss -> nearest valid submesh (the pure
part of ``repro.distributed.elastic``).

The recovery path:
  1. a straggler or health monitor marks hosts dead (``straggler.py``, the
     serving router's heartbeats),
  2. :func:`plan_remesh` picks the largest valid mesh on the surviving
     devices,
  3. the caller rebuilds its layout on that mesh; a trainer keeps the
     global batch by raising gradient-accumulation steps
     (:func:`grad_accum_for_batch`), so optimizer dynamics are unchanged.

The planner is pure logic. It favors keeping the "model" axis intact
(tensor-parallel groups must stay within one fast interconnect domain) and
shrinking "data"/"pod" first (a data-parallel shrink only costs
throughput; a model-axis shrink changes the layout of every weight).
Materializing the planned mesh (``mesh_from_plan``) comes with the port's
``DeviceMesh`` layer.
"""

from __future__ import annotations

import dataclasses

__all__ = ["RemeshPlan", "plan_remesh", "grad_accum_for_batch"]


@dataclasses.dataclass(frozen=True)
class RemeshPlan:
    old_shape: dict[str, int]
    new_shape: dict[str, int]
    n_alive: int
    dropped_chips: int              # alive devices intentionally left idle
    reshard_required: bool          # param layout changes (model axis moved)
    note: str = ""

    @property
    def new_size(self) -> int:
        out = 1
        for v in self.new_shape.values():
            out *= v
        return out


def plan_remesh(old_shape: dict[str, int], n_alive: int) -> RemeshPlan:
    """Largest valid mesh on ``n_alive`` devices, preferring to preserve
    the "model" axis, then "data" (powers of two), then "pod"."""
    model = old_shape.get("model", 1)
    pod = old_shape.get("pod", 1)
    best = None
    for m in _divisor_chain(model):
        for p in range(pod, 0, -1):
            data = _largest_pow2(n_alive // (m * p))
            if data < 1:
                continue
            size = m * p * data
            cand = (size, m == model, p, (m, p, data))
            if best is None or cand > best:
                best = cand
    if best is None:
        raise ValueError(
            f"no valid mesh fits n_alive={n_alive} surviving chip(s) for "
            f"old shape {old_shape}: every candidate assignment needs at "
            f"least one chip per axis — the pool has nothing left to "
            f"remesh onto")
    m, p, data = best[3]
    new_shape = {k: v for k, v in old_shape.items()}
    if "pod" in new_shape:
        new_shape["pod"] = p
    new_shape["data"] = data
    new_shape["model"] = m
    return RemeshPlan(
        old_shape=dict(old_shape), new_shape=new_shape, n_alive=n_alive,
        dropped_chips=n_alive - m * p * data,
        reshard_required=(m != model),
        note=("model axis preserved; DP shrunk" if m == model else
              "model axis shrunk — full reshard via checkpoint restore"),
    )


def _largest_pow2(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p if n >= 1 else 0


def _divisor_chain(n: int):
    d = n
    while d >= 1:
        yield d
        d //= 2


def grad_accum_for_batch(global_batch: int, old_dp: int, new_dp: int,
                         old_accum: int = 1) -> int:
    """Keep the optimizer-visible global batch constant across a remesh by
    scaling gradient-accumulation steps with the DP shrink factor.

    One optimizer step consumes ``total_micro = old_dp * old_accum``
    micro-batches of ``global_batch / total_micro`` examples each, so
    ``global_batch`` must divide evenly by ``total_micro`` — the check
    below rejects a ``global_batch`` the pre-remesh schedule could not have
    produced from integer micro-batches. The returned accumulation count
    is the ceiling division, pinning the invariant ``new_dp * new_accum >=
    total_micro`` (the global batch never shrinks across the remesh; when
    ``new_dp`` does not divide ``total_micro`` the final accumulation step
    runs partially empty)."""
    if min(global_batch, old_dp, new_dp, old_accum) < 1:
        raise ValueError(
            f"global_batch={global_batch}, old_dp={old_dp}, "
            f"new_dp={new_dp}, old_accum={old_accum} must all be >= 1")
    total_micro = old_dp * old_accum
    if global_batch % total_micro:
        raise ValueError(
            f"global_batch {global_batch} is not divisible by old_dp * "
            f"old_accum = {total_micro}: the pre-remesh schedule could "
            f"not have produced it from integer micro-batches")
    return max(1, -(-total_micro // new_dp))
