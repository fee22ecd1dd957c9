"""Uncertainty aggregation + the paper's evaluation metrics.

Paper §VI-B: for every input, the N mask-samples give predictions whose
*mean* is the final estimate and whose *std* is the uncertainty; the reported
metric is relative variance ``std/mean``. The uncertainty *requirement*
(§III Phase 1) is monotonicity: less input noise (higher SNR) => lower RMSE
and lower uncertainty.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import torch

from repro_torch.kernels.moments import ops as moments_ops

__all__ = ["REL_UNC_EPS", "predictive_moments", "relative_uncertainty",
           "token_posterior", "rmse", "UncertaintyRequirements", "RequirementReport",
           "check_requirements"]

#: Floor on |mean| in the relative-uncertainty ratio std/|mean| — a pure
#: divide-by-zero guard, the reference's value.
REL_UNC_EPS = 1e-12


def predictive_moments(samples: torch.Tensor, axis: int = 0
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean, std) over the sample axis: fp32 accumulation, the variance
    centered and two-pass, std with ddof=0 (population), matching the
    reference Masksembles evaluation.

    Computed by the ``moments`` kernel (``kernels/moments``) on a CUDA
    tensor and by its plain version on a CPU tensor: the sample axis is
    moved to the front (a copy unless it is already there) and the other
    axes are flattened to the kernel's ``[N, B, P]``. fp16 is widened to
    fp32 for the reduction and the results cast back (the kernel stores
    fp32 and bf16). As in the reference, an empty sample axis gives NaN
    over the other axes, and empty other axes give empty results; neither
    launches anything."""
    s = samples.movedim(axis, 0)
    rest = s.shape[1:]
    if s.numel() == 0:
        out = torch.full(rest, float("nan"), dtype=s.dtype, device=s.device)
        return out, out.clone()
    wide = s.float() if s.dtype == torch.float16 else s
    mean, std = moments_ops.moments(
        wide.contiguous().reshape(s.shape[0], -1, rest[-1] if rest else 1))
    return (mean.reshape(rest).to(s.dtype), std.reshape(rest).to(s.dtype))


def relative_uncertainty(samples: torch.Tensor, axis: int = 0,
                         eps: float = REL_UNC_EPS) -> torch.Tensor:
    """Paper's metric: std / |mean| per prediction (relative variance)."""
    mean, std = predictive_moments(samples, axis=axis)
    return std / mean.abs().clamp_min(eps)


def token_posterior(logits: torch.Tensor, n: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mask-sample posterior of one LM serving step: logits [n*b, V]
    (mask-major rows) -> (mean log-probs [b, V], relative uncertainty of
    the argmax token [b]), in fp32.

    Shared by the per-op decode step and both prefill forms (one
    ``moments`` launch each on the card); the fused decode kernel's Welford
    epilogue matches it to fp tolerance. n=1 degenerates to plain log-probs
    with zero uncertainty."""
    logp = torch.log_softmax(logits.float(), -1)
    mean, std = predictive_moments(logp.reshape(n, -1, logp.shape[-1]))
    tok = mean.argmax(-1, keepdim=True)
    std_t = std.gather(-1, tok)[:, 0]
    mean_t = mean.gather(-1, tok)[:, 0]
    return mean, std_t / mean_t.abs().clamp_min(REL_UNC_EPS)


def rmse(pred: torch.Tensor, target: torch.Tensor, axis=None) -> torch.Tensor:
    sq = (pred - target) ** 2
    return torch.sqrt(sq.mean() if axis is None else sq.mean(dim=axis))


@dataclasses.dataclass(frozen=True)
class UncertaintyRequirements:
    """Phase-1 requirements (paper §III): formulated before training, used as
    the accept/iterate gate between Phase 2 and Phase 3.

    monotone_rmse / monotone_uncertainty: RMSE and mean relative uncertainty
      must be non-increasing as SNR increases (paper Figs. 6/7), up to
      ``tolerance`` of slack to absorb eval noise.
    max_rel_uncertainty: optional cap on mean relative uncertainty at the
      cleanest SNR (a confident model on clean data).
    """
    monotone_rmse: bool = True
    monotone_uncertainty: bool = True
    tolerance: float = 0.05
    max_rel_uncertainty: float | None = None


@dataclasses.dataclass(frozen=True)
class RequirementReport:
    satisfied: bool
    failures: tuple[str, ...]
    rmse_by_snr: Mapping[float, float]
    uncertainty_by_snr: Mapping[float, float]


def _monotone_decreasing(values: Sequence[float], tol: float) -> bool:
    return all(b <= a * (1.0 + tol) + 1e-12
               for a, b in zip(values, values[1:]))


def check_requirements(req: UncertaintyRequirements,
                       rmse_by_snr: Mapping[float, float],
                       uncertainty_by_snr: Mapping[float, float]
                       ) -> RequirementReport:
    """Evaluate Phase-2 results against Phase-1 requirements."""
    failures: list[str] = []
    snrs = sorted(rmse_by_snr)
    rmses = [float(rmse_by_snr[s]) for s in snrs]
    uncs = [float(uncertainty_by_snr[s]) for s in snrs]
    if req.monotone_rmse and not _monotone_decreasing(rmses, req.tolerance):
        failures.append(
            f"RMSE not decreasing with SNR: {dict(zip(snrs, rmses))}")
    if req.monotone_uncertainty and not _monotone_decreasing(
            uncs, req.tolerance):
        failures.append(
            f"uncertainty not decreasing with SNR: {dict(zip(snrs, uncs))}")
    if req.max_rel_uncertainty is not None and uncs and (
            uncs[-1] > req.max_rel_uncertainty):
        failures.append(f"uncertainty at SNR={snrs[-1]} is {uncs[-1]:.4f} > "
                        f"cap {req.max_rel_uncertainty}")
    return RequirementReport(satisfied=not failures, failures=tuple(failures),
                             rmse_by_snr=dict(zip(snrs, rmses)),
                             uncertainty_by_snr=dict(zip(snrs, uncs)))
