"""Sample scheduling: sampling-level vs batch-level (paper Fig. 5).

A mask-based BayesNN evaluates every input under N mask-samples. Two loop
orders compute identical results with very different weight traffic:

* **sampling-level** (the paper's baseline): voxel-outer, sample-inner —
  each voxel chunk re-reads all N weight sets -> ``N × ceil(B/chunk)``
  weight loads per batch.
* **batch-level** (the paper's scheme): sample-outer, batch-inner — each
  weight set is read once per batch -> ``N`` weight loads.

The loop forms here (:func:`run_batch_level`, :func:`run_sampling_level`)
are plain PyTorch: each ``apply_fn`` call is one sample over one batch or
chunk, so the order of weight use is the loop order itself. They give the
reference semantics and the card's timings of the two orders; the kernel
that runs either order in one launch is ``kernels/masked_ffn``
(``sample_major=True|False``). The module also holds the chunk partition of
the serving engine, the serving pool's slot layout, and the analytic
traffic model the plan's byte/FLOP accounting is built from.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

Params = dict[str, Any]
ApplyFn = Callable[[Params, torch.Tensor, int], torch.Tensor]

__all__ = ["Schedule", "SlotSchedule", "chunk_bounds", "run_sampling_level",
           "run_batch_level", "run", "weight_load_counts", "TrafficModel",
           "traffic_model"]


def chunk_bounds(n: int, chunk: int) -> tuple[tuple[int, int], ...]:
    """Partition ``n`` voxels into fixed-``chunk`` slices: ``(start, stop)``
    pairs, the last slice short when ``chunk`` does not divide ``n``. The
    serving engine zero-pads each slice to exactly ``chunk`` rows, so every
    launch sees one shape."""
    if n < 1 or chunk < 1:
        raise ValueError(f"chunk_bounds needs n >= 1, chunk >= 1 "
                         f"(got n={n}, chunk={chunk})")
    return tuple((s, min(s + chunk, n)) for s in range(0, n, chunk))


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Execution schedule for N-sample inference.

    kind: 'sampling' (voxel-outer) or 'batch' (sample-outer, paper's scheme).
    chunk: voxel-chunk size of the sampling-level loop.
    """
    kind: str = "batch"
    chunk: int = 64

    def __post_init__(self) -> None:
        if self.kind not in ("sampling", "batch"):
            raise ValueError(f"unknown schedule kind {self.kind!r}")


@dataclasses.dataclass(frozen=True)
class SlotSchedule:
    """Row layout of the continuous-batching serving pool
    (``serving/server.py``): ``n_masks * max_slots`` rows, mask-major (row
    ``m * max_slots + s`` is mask-sample ``m`` of slot ``s``). One request
    occupies one *slot group* — the ``n_masks`` rows of a single slot — so
    the mask-id vector is a constant (:meth:`mask_ids`), the batch-level
    schedule applies to every decode step whichever requests are resident,
    and admitting or freeing a request touches exactly
    :meth:`rows_for_slot`. Tensors come back on ``device`` (default the
    CPU)."""
    n_masks: int
    max_slots: int

    def __post_init__(self) -> None:
        if self.n_masks < 1 or self.max_slots < 1:
            raise ValueError(f"bad slot schedule {self}")

    @property
    def rows(self) -> int:
        """Total batch rows of the pooled cache."""
        return self.n_masks * self.max_slots

    def mask_ids(self, device=None) -> torch.Tensor:
        """Constant per-row mask assignment [rows] (mask-major groups, the
        layout of ``masksembles.mask_ids_for_batch``)."""
        return torch.arange(self.n_masks, device=device) \
            .repeat_interleave(self.max_slots)

    def rows_for_slot(self, slot: int, device=None) -> torch.Tensor:
        """Batch rows of slot ``slot``'s group, one per mask [n_masks]."""
        return torch.arange(self.n_masks, device=device) * self.max_slots \
            + int(slot)

    def row_values(self, per_slot) -> torch.Tensor:
        """Broadcast a per-slot vector [max_slots] to per-row [rows] (e.g.
        per-slot decode positions -> per-row cache positions)."""
        return torch.as_tensor(per_slot).repeat(self.n_masks)

    def admits(self, other: "SlotSchedule") -> None:
        """Pool-admission hook for voxel-chunk work items: a PackedPlan's
        ``plan.slot_schedule(max_slots)`` must coincide with the pool's
        layout — the scan's sample axis is the pool's mask axis, so one
        batch-level loop order covers resident LM and voxel work. Raises
        ValueError on mismatch."""
        if self != other:
            raise ValueError(
                f"plan sample axis does not map onto the pool layout: "
                f"plan {other} vs pool {self} (n_masks must match)")

    def decode_traffic(self, d_in: int, k_hidden: int, d_out: int,
                       bytes_per_el: int = 2, *,
                       weight_bytes_per_el: int | None = None
                       ) -> "TrafficModel":
        """Per-decode-step FFN traffic of a full pool: the batch-level
        schedule over ``max_slots`` resident requests — the quantity
        continuous batching amortizes (weights touched N times a step
        however many requests are in flight). ``weight_bytes_per_el``
        prices the weight matrices apart (quantized serving)."""
        return traffic_model(Schedule("batch"), self.max_slots, self.n_masks,
                             d_in, k_hidden, d_out, bytes_per_el,
                             weight_bytes_per_el=weight_bytes_per_el)


def run_batch_level(apply_fn: ApplyFn, params: Params, x: torch.Tensor,
                    n_samples: int) -> torch.Tensor:
    """Sample-outer loop: the weights of sample i are used once while the
    whole batch streams through. Returns ``[N, B, ...]``."""
    return torch.stack([apply_fn(params, x, i) for i in range(n_samples)])


def run_sampling_level(apply_fn: ApplyFn, params: Params, x: torch.Tensor,
                       n_samples: int, chunk: int = 64) -> torch.Tensor:
    """Voxel-outer loop with an inner sample loop: the FPGA baseline, where
    every ``chunk`` of voxels re-loads all N weight sets. The batch is
    zero-padded to a multiple of ``chunk``. Returns ``[N, B, ...]`` (the
    values of :func:`run_batch_level`)."""
    b = x.shape[0]
    if b % chunk:
        pad = x.new_zeros((chunk - b % chunk,) + tuple(x.shape[1:]))
        x = torch.cat([x, pad])
    ys = torch.stack([torch.stack([apply_fn(params, xb, i)
                                   for i in range(n_samples)])
                      for xb in x.split(chunk)])   # [B/chunk, N, chunk, ...]
    ys = ys.movedim(1, 0).reshape(n_samples, -1, *ys.shape[3:])
    return ys[:, :b]


def run(schedule: Schedule, apply_fn: ApplyFn, params: Params,
        x: torch.Tensor, n_samples: int) -> torch.Tensor:
    if schedule.kind == "batch":
        return run_batch_level(apply_fn, params, x, n_samples)
    return run_sampling_level(apply_fn, params, x, n_samples, schedule.chunk)


def weight_load_counts(schedule: Schedule, batch: int, n_samples: int) -> int:
    """Paper §V-D: sampling-level = N × ceil(B/chunk) loads, batch-level =
    N."""
    if schedule.kind == "batch":
        return n_samples
    return n_samples * -(-batch // schedule.chunk)


@dataclasses.dataclass(frozen=True)
class TrafficModel:
    """Device-memory traffic + FLOPs of one N-sample evaluation."""
    weight_bytes: int          # total weight bytes moved from device memory
    act_bytes: int             # activation bytes (in + out, once)
    flops: int                 # dense MACs*2 over packed shapes
    weight_loads: int          # paper's load-count metric

    @property
    def total_bytes(self) -> int:
        return self.weight_bytes + self.act_bytes

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops / max(1, self.total_bytes)


def traffic_model(schedule: Schedule, batch: int, n_samples: int,
                  d_in: int, k_hidden: int, d_out: int,
                  bytes_per_el: int = 4, *,
                  weight_bytes_per_el: int | None = None) -> TrafficModel:
    """Analytic traffic of a packed 2-layer FFN under a schedule: the
    per-sample packed weight set is w1p [d_in, K] + w2p [K, d_out] (+ its
    biases); the schedule decides how many times it is read.
    ``weight_bytes_per_el`` prices the two matrices alone (1 for int8
    serving; biases stay at ``bytes_per_el``)."""
    wb = bytes_per_el if weight_bytes_per_el is None else weight_bytes_per_el
    per_sample_w = (d_in * k_hidden + k_hidden * d_out) * wb \
        + (k_hidden + d_out) * bytes_per_el
    loads = weight_load_counts(schedule, batch, n_samples)
    weight_bytes = per_sample_w * loads
    act_bytes = (batch * d_in + n_samples * batch * d_out) * bytes_per_el
    flops = 2 * n_samples * batch * (d_in * k_hidden + k_hidden * d_out)
    return TrafficModel(weight_bytes=weight_bytes, act_bytes=act_bytes,
                        flops=flops, weight_loads=loads)
