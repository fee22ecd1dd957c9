"""Synthetic IVIM datasets with controlled noise — paper §III Phase 1 / §VI-A.

Uncertainty has no ground truth on collected data, so the paper requires
synthetic data: draw (D, D*, f, S0) from clinical ranges, compute S(b) from
Eq. (1), then corrupt with Gaussian noise of std S0/SNR. A dataset is a pure
function of its config: the seed makes a ``torch.Generator`` on the target
device, so a volume is made on the card in bulk.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import device as device_lib
from repro_torch.ivim import physics

__all__ = ["SNR_LEVELS", "SyntheticConfig", "make_dataset"]

SNR_LEVELS: tuple[float, ...] = (5.0, 15.0, 20.0, 30.0, 50.0)


@dataclasses.dataclass(frozen=True)
class SyntheticConfig:
    """One scenario: n voxels at a single SNR under a b-value protocol."""
    n_voxels: int = 10_000
    snr: float = 20.0
    b_values: tuple[float, ...] = physics.CLINICAL_B_VALUES
    seed: int = 0
    ranges: physics.ParamRanges = physics.DEFAULT_RANGES


def make_dataset(cfg: SyntheticConfig,
                 device: torch.device | str | None = None
                 ) -> dict[str, torch.Tensor | dict[str, torch.Tensor]]:
    """Generate one scenario on ``device`` (None -> the card). Returns
      signals [n, Nb] — noisy S divided by the measured S(b=0) (model input),
      clean   [n, Nb] — noise-free S/S0 (diagnostics),
      params  {D, Dstar, f, S0} [n] — ground truth.
    """
    dev = device_lib.resolve(device)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    params = physics.sample_parameters(gen, cfg.n_voxels, cfg.ranges)
    b = torch.tensor(cfg.b_values, dtype=torch.float32, device=dev)
    s = physics.ivim_signal(b, params["D"], params["Dstar"], params["f"],
                            params["S0"])                       # [n, Nb]
    noise_std = (params["S0"] / cfg.snr)[:, None]
    noisy = s + noise_std * torch.randn(s.shape, generator=gen, device=dev)
    b0 = int(torch.argmin(b))    # the b=0 (or smallest-b) measurement
    s0_meas = noisy[:, b0:b0 + 1].clamp_min(1e-6)
    return {"signals": noisy / s0_meas,
            "clean": s / s[:, b0:b0 + 1],
            "params": params}
