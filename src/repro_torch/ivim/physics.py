"""IVIM physics — paper Eq. (1) and clinical parameter ranges.

The intravoxel incoherent motion (IVIM) model (Le Bihan et al., 1988):

    S(b) / S(b=0) = f * exp(-b * D*) + (1 - f) * exp(-b * D)

with b the diffusion sensitization (s/mm^2), D the tissue diffusion
coefficient, D* the pseudo-diffusion coefficient and f the perfusion
fraction. The b-value ladder defaults to the 11-point clinical protocol; a
104-b-value profile mirrors the published dataset the paper's accelerator
sizes its PEs for (§VI-A).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["ParamRanges", "DEFAULT_RANGES", "CLINICAL_B_VALUES",
           "DENSE_B_VALUES", "ivim_signal", "sample_parameters"]

# 11-point clinical protocol (s/mm^2) used by IVIM-NET reference code.
CLINICAL_B_VALUES: tuple[float, ...] = (
    0.0, 10.0, 20.0, 30.0, 50.0, 75.0, 100.0, 150.0, 250.0, 400.0, 600.0)


def _validated_dense(values: tuple[float, ...]) -> tuple[float, ...]:
    """Import-time guard on the dense protocol size (every PE-capacity and
    kernel-shape assumption downstream rests on 104)."""
    if len(values) != 104:
        raise ValueError(
            f"dense IVIM protocol must carry 104 b-values (paper §VI-A "
            f"PE sizing), got {len(values)}")
    return values


# 104-b-value dense research protocol — the size the paper's PEs support.
DENSE_B_VALUES: tuple[float, ...] = _validated_dense(tuple(
    float(b) for b in np.concatenate([
        np.repeat([0.0, 10.0, 20.0, 30.0, 50.0, 75.0, 100.0, 150.0, 250.0,
                   400.0, 600.0], 8),
        np.linspace(5.0, 80.0, 16),
    ])))


@dataclasses.dataclass(frozen=True)
class ParamRanges:
    """Clinical ranges the synthetic generator draws from (uniform)."""
    d_min: float = 0.0005      # mm^2/s — tissue diffusion
    d_max: float = 0.003
    dstar_min: float = 0.01    # mm^2/s — pseudo-diffusion (perfusion)
    dstar_max: float = 0.1
    f_min: float = 0.0         # perfusion fraction
    f_max: float = 0.4
    s0_min: float = 0.8        # S(b=0), normalized around 1
    s0_max: float = 1.2


DEFAULT_RANGES = ParamRanges()


def ivim_signal(b_values: torch.Tensor, d: torch.Tensor, dstar: torch.Tensor,
                f: torch.Tensor, s0: torch.Tensor) -> torch.Tensor:
    """Paper Eq. (1), vectorized: parameters [...] x b_values [Nb] ->
    [..., Nb], the *unnormalized* S(b) = S0 (f e^{-b D*} + (1-f) e^{-b D})."""
    d, dstar, f, s0 = (a[..., None] for a in (d, dstar, f, s0))
    return s0 * (f * torch.exp(-b_values * dstar)
                 + (1.0 - f) * torch.exp(-b_values * d))


def sample_parameters(generator: torch.Generator, n: int,
                      ranges: ParamRanges = DEFAULT_RANGES
                      ) -> dict[str, torch.Tensor]:
    """Draw n voxels' worth of ground-truth IVIM parameters uniformly, on
    the generator's device."""
    def u(lo: float, hi: float) -> torch.Tensor:
        r = torch.rand(n, generator=generator, device=generator.device)
        return lo + r * (hi - lo)

    return {"D": u(ranges.d_min, ranges.d_max),
            "Dstar": u(ranges.dstar_min, ranges.dstar_max),
            "f": u(ranges.f_min, ranges.f_max),
            "S0": u(ranges.s0_min, ranges.s0_max)}
