"""Plain PyTorch version of the fused decode step. The decode chain's IR
and its plain math live beside the feed-forward chain in
``kernels/fused_plan/ref.py`` (as in the reference); this module names
them for the kernel package, and states the kernel's split of an fp32
activation into bf16 parts (``split_bf16x3``, used by the tests)."""

import torch

from repro_torch.kernels.fused_plan.ref import (  # noqa: F401
    FusedDecodeSpec, FusedPlanUnsupported, decode_param_slots,
    fused_decode_ref)

__all__ = ["FusedDecodeSpec", "FusedPlanUnsupported", "decode_param_slots",
           "fused_decode_ref", "split_bf16x3"]


def split_bf16x3(x: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """fp32 ``x`` as three bf16 parts, each the remainder so far rounded to
    nearest (``csrc/dense_tile.cuh`` ``split_bf16x3``): ``hi = bf16(x)``,
    ``mid = bf16(x - hi)``, ``lo = bf16(x - hi - mid)``.

    x's 24 significant bits fall into three 8-bit pieces, so
    ``hi + mid + lo == x`` (for |x| above 2^-126, where no part leaves
    bf16's normal range), and a bf16 weight times each part is exact in
    fp32: the kernel's three tensor-core products on one weight fragment
    give the fp32 product over bf16 storage but for the order of the sums.
    """
    x = x.float()
    hi = x.to(torch.bfloat16)
    r = x - hi.float()
    mid = r.to(torch.bfloat16)
    lo = (r - mid.float()).to(torch.bfloat16)
    return hi, mid, lo
