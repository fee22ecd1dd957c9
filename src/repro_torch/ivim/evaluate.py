"""Paper Figs. 6-7 evaluation: RMSE and relative uncertainty vs SNR.

For each SNR scenario, evaluate the trained uIVIM-NET with all masks, then:
  * RMSE of the reconstruction and of each predicted IVIM parameter against
    synthetic ground truth (Fig. 6),
  * mean relative uncertainty std/|mean| per parameter (Fig. 7),
and check the Phase-1 uncertainty requirements (monotone in SNR). The
moments of each scenario are computed once — one ``moments`` kernel launch
per SNR level on the card — and the relative uncertainty is derived from
them.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

from repro_torch import device as device_lib
from repro_torch.core import uncertainty as unc_lib
from repro_torch.ivim import data as data_lib
from repro_torch.ivim import model as model_lib

__all__ = ["evaluate_snr_sweep", "requirement_report"]


@torch.no_grad()
def evaluate_snr_sweep(model: model_lib.IvimNet,
                       snrs=data_lib.SNR_LEVELS, n_voxels: int = 2000,
                       seed: int = 1234,
                       device: torch.device | str | None = None
                       ) -> dict[float, dict[str, Any]]:
    """Returns ``{snr: {rmse_recon, rmse_params{name}, rel_unc{name}}}`` for
    the scenarios ``make_dataset(n_voxels, snr, seed + int(snr))`` on
    ``device`` (None -> the card)."""
    dev = device_lib.resolve(device)
    cfg = model.cfg
    out: dict[float, dict[str, Any]] = {}
    for snr in snrs:
        ds = data_lib.make_dataset(data_lib.SyntheticConfig(
            n_voxels=n_voxels, snr=float(snr), b_values=cfg.b_values,
            seed=seed + int(snr)), device=dev)
        samples = model_lib.apply_all_samples(model, ds["signals"])
        mean, std = unc_lib.predictive_moments(samples)        # [B, 4]
        rel = std / mean.abs().clamp_min(unc_lib.REL_UNC_EPS)
        recon = model_lib.reconstruct(cfg, mean)
        gt = ds["params"]
        out[float(snr)] = {
            "rmse_recon": float(unc_lib.rmse(recon, ds["clean"])),
            "rmse_params": {name: float(unc_lib.rmse(mean[:, i], gt[name]))
                            for i, name in enumerate(model_lib.PARAM_NAMES)},
            "rel_unc": {name: float(rel[:, i].mean())
                        for i, name in enumerate(model_lib.PARAM_NAMES)},
        }
    return out


def requirement_report(results: Mapping[float, Mapping[str, Any]],
                       req: unc_lib.UncertaintyRequirements | None = None
                       ) -> unc_lib.RequirementReport:
    """Phase-2 gate (paper §III): monotone RMSE + uncertainty in SNR."""
    req = req or unc_lib.UncertaintyRequirements(tolerance=0.15)
    rmse_by_snr = {s: r["rmse_recon"] for s, r in results.items()}
    unc_by_snr = {
        s: sum(r["rel_unc"].values()) / len(r["rel_unc"])
        for s, r in results.items()
    }
    return unc_lib.check_requirements(req, rmse_by_snr, unc_by_snr)
