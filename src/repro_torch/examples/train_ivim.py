"""End-to-end paper reproduction: train uIVIM-NET and reproduce
Figs. 6-7 (RMSE + uncertainty vs SNR) with the Phase-2 requirement gate.

    python -m repro_torch.examples.train_ivim [--steps 800] [--n-masks 4] \
        [--scale 2.0] [--dense-protocol] [--device cpu]

On the card the SNR sweep's posteriors run the ``moments`` kernel.
"""

from __future__ import annotations

import argparse

from repro_torch import device as device_lib
from repro_torch.ivim import evaluate as E
from repro_torch.ivim import model as M
from repro_torch.ivim import physics
from repro_torch.ivim import train as T

__all__ = ["run", "main"]


def run(steps: int = 800, n_masks: int = 4, scale: float = 2.0,
        dense_protocol: bool = False, device=None) -> dict:
    """Train on ``device`` (None -> the card), sweep the SNR levels over
    2,000 voxels each and gate the trends. Returns the config, the loss
    history, the sweep's results and the requirement report."""
    dev = device_lib.resolve(device)
    b_values = (physics.DENSE_B_VALUES if dense_protocol
                else physics.CLINICAL_B_VALUES)
    cfg = M.IvimConfig(b_values=b_values, n_masks=n_masks, scale=scale)
    model, hist = T.train(cfg, T.TrainConfig(steps=steps, batch_size=128,
                                             lr=3e-3),
                          log_every=100, device=dev)
    results = E.evaluate_snr_sweep(model, n_voxels=2000, device=dev)
    return {"cfg": cfg, "loss": hist, "results": results,
            "report": E.requirement_report(results)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=800)
    ap.add_argument("--n-masks", type=int, default=4)
    ap.add_argument("--scale", type=float, default=2.0)
    ap.add_argument("--dense-protocol", action="store_true",
                    help="use the 104-b-value research protocol")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    n_b = len(physics.DENSE_B_VALUES if args.dense_protocol
              else physics.CLINICAL_B_VALUES)
    print(f"training uIVIM-NET: {n_b} b-values, N={args.n_masks}, "
          f"scale={args.scale}, {args.steps} steps")
    r = run(args.steps, args.n_masks, args.scale, args.dense_protocol,
            args.device)
    results = r["results"]
    print(f"\n{'SNR':>5s} {'RMSE':>8s} " +
          "".join(f"{'rmse_' + p:>10s}" for p in M.PARAM_NAMES) +
          "".join(f"{'unc_' + p:>10s}" for p in M.PARAM_NAMES))
    for snr in sorted(results):
        row = results[snr]
        print(f"{snr:5.0f} {row['rmse_recon']:8.4f} " +
              "".join(f"{row['rmse_params'][p]:10.5f}"
                      for p in M.PARAM_NAMES) +
              "".join(f"{row['rel_unc'][p]:10.4f}" for p in M.PARAM_NAMES))
    report = r["report"]
    print(f"\nPhase-2 gate (paper Figs. 6-7 trends): "
          f"{'SATISFIED' if report.satisfied else 'NOT satisfied'}")
    for fail in report.failures:
        print("  -", fail)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
