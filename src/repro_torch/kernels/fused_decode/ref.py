"""Plain PyTorch version of the fused decode step. The decode chain's IR
and its plain math live beside the feed-forward chain in
``kernels/fused_plan/ref.py`` (as in the reference); this module names
them for the kernel package."""

from repro_torch.kernels.fused_plan.ref import (  # noqa: F401
    FusedDecodeSpec, FusedPlanUnsupported, decode_param_slots,
    fused_decode_ref)

__all__ = ["FusedDecodeSpec", "FusedPlanUnsupported", "decode_param_slots",
           "fused_decode_ref"]
