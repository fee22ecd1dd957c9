"""Analytic latency model — the GPU analogue of paper Eq. (2).

Paper (FPGA):  L_PU = R_M + R_A·(L+1) + ⌈N_b/N_PE⌉ − 1
  — multiplier pipeline fill, adder-tree depth, serialization over input
  chunks.

Here the same three ingredients map to
  * pipeline fill  → a fixed per-kernel launch/fill term;
  * adder tree     → padding waste: a product's contraction and output
    widths are priced padded to the matrix unit's tile;
  * ⌈N_b/N_PE⌉      → roofline: a product of padded shape (M̂, K̂, N̂) takes
    max(compute, weight + activation bytes over the memory rate).

This model drives the Phase-3 plan (``transform.plan_hardware``,
``plan.PackedPlan.modeled_latency``) and the Fig.-8-style sweep of block
size against on-chip memory (:func:`grid_sweep`). It is a *model*: its one
device is :data:`H100`, whose constants are the data sheet's except the
fill time (a chip-run measurement), and measured times come from
``chip_smoke.py``'s chip runs (``PERF.md``).
The formulas are the reference's (``repro.core.latency_model``), so any
spec with its fields prices as the reference does.
"""

from __future__ import annotations

import dataclasses
import math

__all__ = ["DeviceSpec", "H100", "matmul_time", "masked_ffn_latency",
           "RooflineTerms", "roofline_terms", "roofline_seconds",
           "grid_sweep"]


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """Per-device numbers the model prices with."""
    name: str
    peak_flops: float        # FLOP/s of the matrix unit, dense
    hbm_bw: float            # device-memory bytes/s
    link_bw: float           # bytes/s per direction to another device
    hbm_bytes: float         # device memory
    onchip_bytes: float      # fast on-chip memory a kernel's block may use
    tile: int                # matrix-unit tile the K and N widths pad to
    kernel_fill_us: float    # per-kernel launch/fill overhead


H100 = DeviceSpec(
    name="h100-sxm5-80gb",
    # NVIDIA H100 SXM5 80 GB data sheet: dense bf16 on the tensor cores
    peak_flops=989e12,
    # same data sheet: HBM3
    hbm_bw=3.35e12,
    # same data sheet: NVLink 900 GB/s in all, 450 GB/s each way
    link_bw=450e9,
    # same data sheet: 80 GB
    hbm_bytes=80e9,
    # NVIDIA's Hopper tuning guide: 228 KB of shared memory per SM (227 KB
    # a block)
    onchip_bytes=228 * 1024,
    # PTX ISA: a bf16 mma.sync/wgmma contracts k = 16 and an mma.sync
    # output tile is 16 rows by 8 or more columns; 16 is the unit priced
    tile=16,
    # measured on an H100 80GB HBM3 at 700 W by chip_smoke.py: the card's
    # own time of a one-element kernel launch (the moments kernel at
    # [1, 1, 1], 1.48 us in profiler events; PERF.md §6); the host's
    # launch path is not in it
    kernel_fill_us=1.5,
)


def _pad(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def matmul_time(m: int, k: int, n: int, spec: DeviceSpec = H100,
                bytes_per_el: int = 2, weight_resident: bool = False
                ) -> float:
    """Roofline time (s) of one (m,k)@(k,n) product on one device, rows
    padded to 8 and k, n to the spec's tile; ``weight_resident=True``
    drops the weight-stream term (batch-level scheme: weights on chip)."""
    mp, kp, np_ = _pad(m, 8), _pad(k, spec.tile), _pad(n, spec.tile)
    t_compute = 2.0 * mp * kp * np_ / spec.peak_flops
    w_bytes = 0 if weight_resident else kp * np_ * bytes_per_el
    a_bytes = (mp * kp + mp * np_) * bytes_per_el
    t_mem = (w_bytes + a_bytes) / spec.hbm_bw
    return max(t_compute, t_mem) + spec.kernel_fill_us * 1e-6


def masked_ffn_latency(batch: int, n_samples: int, d_in: int, hidden: int,
                       keep: int, d_out: int, *, packed: bool,
                       batch_level: bool, spec: DeviceSpec = H100,
                       bytes_per_el: int = 2) -> float:
    """Modeled latency (s) of one N-sample masked-FFN batch on one device.

    packed=False → mask-as-multiply over the full hidden dim (no skipping).
    batch_level=False → sampling-level order: weights re-streamed per voxel
      chunk of 64 (the FPGA on-chip batch); batch_level=True amortizes one
      weight load per sample.
    """
    h = keep if packed else hidden
    chunk = 64
    t = 0.0
    if batch_level:
        for _ in range(n_samples):
            t += matmul_time(batch, d_in, h, spec, bytes_per_el)
            t += matmul_time(batch, h, d_out, spec, bytes_per_el)
        return t
    for _ in range(max(1, math.ceil(batch / chunk))):
        for _ in range(n_samples):
            t += matmul_time(chunk, d_in, h, spec, bytes_per_el)
            t += matmul_time(chunk, h, d_out, spec, bytes_per_el)
    return t


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    """The three roofline terms, in seconds (per step, per device)."""
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)  # type: ignore[arg-type]

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)


def roofline_terms(flops: float, hbm_bytes: float, collective_bytes: float,
                   spec: DeviceSpec = H100) -> RooflineTerms:
    """compute = FLOPs / peak, memory = bytes / memory rate, collective =
    link bytes / per-direction link rate (all per device)."""
    return RooflineTerms(compute_s=flops / spec.peak_flops,
                         memory_s=hbm_bytes / spec.hbm_bw,
                         collective_s=collective_bytes / spec.link_bw)


def roofline_seconds(tm, spec: DeviceSpec = H100) -> float:
    """Eq.-2-analogue latency of one launch set: the roofline over a
    ``core.scheduler.TrafficModel``'s modeled FLOPs and bytes plus one
    ``kernel_fill_us`` per launch (``weight_loads`` holds the launch count
    in the decode and fused pricing)."""
    terms = roofline_terms(tm.flops, tm.total_bytes, 0.0, spec)
    return max(terms.compute_s, terms.memory_s) \
        + tm.weight_loads * spec.kernel_fill_us * 1e-6


def grid_sweep(batch: int, d_in: int, keep: int, d_out: int, n_samples: int,
               spec: DeviceSpec = H100) -> list[dict]:
    """Fig.-8 analogue: sweep the voxel block (the FPGA's "number of PEs")
    and report each choice's modeled latency and on-chip footprint (bf16
    operands, widths padded to ``spec.tile``) against
    ``spec.onchip_bytes``. A model only: the card's ``masked_ffn`` kernel
    runs one fixed voxel tile."""
    out = []
    for bm in (8, 16, 32, 64, 128, 256, 512):
        if bm > max(8, batch):
            break
        tiles = math.ceil(batch / bm)
        t = 0.0
        for _ in range(n_samples):
            t += matmul_time(bm, d_in, keep, spec) * tiles
            t += matmul_time(bm, keep, d_out, spec,
                             weight_resident=True) * tiles
        di, k, do = (_pad(v, spec.tile) for v in (d_in, keep, d_out))
        onchip = (bm * di + di * k + k * do + bm * k) * 2
        out.append({"block_batch": bm, "latency_s": t,
                    "onchip_bytes": onchip,
                    "fits_onchip": onchip <= spec.onchip_bytes})
    return out
