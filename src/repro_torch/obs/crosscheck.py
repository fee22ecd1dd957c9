"""Modeled-vs-measured cross-check (the port's twin of
``repro.obs.crosscheck``).

The port prices its hot paths analytically (``core.plan.PackedPlan.
traffic()`` / ``decode_traffic()`` -> ``core.scheduler.TrafficModel``).
:func:`model_fidelity` joins those modeled bytes and FLOPs to a measured
wall time: given the wall clock over N served units (tokens or voxels) and
the modeled traffic of one launch or step, it returns a JSON-safe
``model_fidelity`` block priced on a
:class:`~repro_torch.core.latency_model.DeviceSpec` (default ``H100``).

Reading the block: ``ratio_measured_to_modeled`` ~ 1 means the roofline
model explains the measurement; >> 1 means the run was nowhere near the
modeled card — the model prices the card's bytes and FLOPs and one fill
term a launch, not the host's part of a step. The block's keys are the
reference's, except ``device`` (``spec.name``) where the reference writes
``tpu``.

The pricing rule itself is ``core.latency_model.roofline_seconds``, shared
with ``core.plan.decode_modeled_latency``; it is re-exported here under the
reference's name. ``obs/__init__`` reaches this module lazily, as the
reference's does.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

from repro_torch.core import latency_model
from repro_torch.core.latency_model import roofline_seconds

if TYPE_CHECKING:
    from repro_torch.core.scheduler import TrafficModel

__all__ = ["roofline_seconds", "model_fidelity"]


def model_fidelity(*, measured_wall_s: float, n_units: int,
                   step_traffic: TrafficModel, units_per_step: int,
                   unit: str = "token",
                   device: latency_model.DeviceSpec = latency_model.H100,
                   stages: dict[str, TrafficModel] | None = None) -> dict:
    """Join measured wall time against modeled traffic -> the JSON-safe
    ``model_fidelity`` block.

    ``step_traffic`` prices ONE step/launch that serves ``units_per_step``
    units; ``measured_wall_s`` covers ``n_units`` served units end to end.
    ``stages`` (optional) is a named decomposition of the step's traffic
    (e.g. ``core.plan.decode_stage_traffic``) — each stage gets its own
    modeled seconds and byte share."""
    n_units = max(1, int(n_units))
    units_per_step = max(1, int(units_per_step))
    modeled_step_s = roofline_seconds(step_traffic, device)
    measured_per_unit = measured_wall_s / n_units
    modeled_per_unit = modeled_step_s / units_per_step
    bytes_per_unit = step_traffic.total_bytes / units_per_step
    block = {
        "unit": unit,
        "n_units": n_units,
        "device": device.name,
        "measured_s_per_unit": measured_per_unit,
        "modeled_s_per_unit": modeled_per_unit,
        "ratio_measured_to_modeled": (
            measured_per_unit / modeled_per_unit if modeled_per_unit > 0
            else float("nan")),
        "modeled_bytes_per_unit": bytes_per_unit,
        "modeled_flops_per_unit": step_traffic.flops / units_per_step,
        "achieved_bytes_per_s": (
            bytes_per_unit / measured_per_unit if measured_per_unit > 0
            else float("nan")),
        "hbm_bw_fraction": (
            bytes_per_unit / measured_per_unit / device.hbm_bw
            if measured_per_unit > 0 else float("nan")),
    }
    if stages:
        total_bytes = max(1, sum(t.total_bytes for t in stages.values()))
        block["stages"] = {
            name: {
                "modeled_bytes": t.total_bytes,
                "modeled_flops": t.flops,
                "modeled_s": roofline_seconds(t, device),
                "byte_share": t.total_bytes / total_bytes,
            } for name, t in stages.items()}
    return block
