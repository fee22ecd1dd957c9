"""Synthetic IVIM datasets with controlled noise — paper §III Phase 1 / §VI-A.

Uncertainty has no ground truth on collected data, so the paper requires
synthetic data: draw (D, D*, f, S0) from clinical ranges, compute S(b) from
Eq. (1), then corrupt with Gaussian noise of std S0/SNR. A dataset is a pure
function of its config: the seed makes a ``torch.Generator`` on the target
device, so a volume is made on the card in bulk. :class:`Batcher` draws
training batches from it with the reference's host-side seeded
permutation, so the same signals give the same batches in both packages.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.ivim import physics

__all__ = ["SNR_LEVELS", "SyntheticConfig", "make_dataset", "Batcher"]

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


class Batcher:
    """Stateless seeded batch access: ``batch(step)`` is pure in
    ``(signals, batch_size, seed, step)``.

    Epoch ``e``'s shuffle is ``np.random.default_rng((seed, e))
    .permutation(n)`` on the host — the reference's permutation, so any
    step can be recomputed without replaying earlier ones — and a batch is
    the selected rows of the signals tensor, on its device.
    """

    def __init__(self, data: dict[str, torch.Tensor], batch_size: int,
                 seed: int = 0):
        self._signals = data["signals"]
        self._n = self._signals.shape[0]
        self._bs = batch_size
        self._seed = seed
        self._per_epoch = self._n // batch_size
        if self._per_epoch == 0:
            raise ValueError(f"batch_size {batch_size} > dataset size "
                             f"{self._n}")

    @property
    def batches_per_epoch(self) -> int:
        return self._per_epoch

    def batch(self, step: int) -> torch.Tensor:
        epoch, idx = divmod(int(step), self._per_epoch)
        perm = np.random.default_rng((self._seed, epoch)).permutation(self._n)
        sel = perm[idx * self._bs:(idx + 1) * self._bs]
        return self._signals[torch.from_numpy(sel).to(self._signals.device)]
