"""Quickstart: the paper's flow in a few calls.

    python -m repro_torch.examples.quickstart [--device cpu]

1. Generate synthetic diffusion-MRI voxels from the IVIM equation (Eq. 1).
2. Convert IVIM-NET -> uIVIM-NET (fixed Masksembles masks) and train it
   with the physics reconstruction loss.
3. Predict IVIM parameters WITH uncertainty.
4. Phase 3: fold BN, apply mask-zero skipping, serve batch-level — check
   that the packed serving path gives the training form's numbers.

On the card the packed check runs the ``masked_ffn`` kernel (the per-op
tier) and the volume the ``fused_plan`` kernel in moments mode.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch import device as device_lib
from repro_torch.core import plan as plan_lib
from repro_torch.ivim import data as ivim_data
from repro_torch.ivim import model as ivim_model
from repro_torch.ivim import train as ivim_train
from repro_torch.serving import engine

__all__ = ["VOLUME", "packed_check", "serve_volume", "run", "main"]

#: The served volume's voxel grid: the first 16 x 16 x 2 voxels.
VOLUME = (16, 16, 2)


def packed_check(model: ivim_model.IvimNet, x: torch.Tensor, device=None
                 ) -> tuple[plan_lib.PackedPlan, torch.Tensor, float]:
    """Compile ``model`` to a PackedPlan (mask-zero skipping, batch-level
    schedule) and serve ``x`` through its per-op executor: (plan, samples
    [N, B, 4], max |samples - the training form's|)."""
    plan = ivim_model.pack_for_serving(model)
    served = ivim_model.packed_apply(plan, x, device=device)
    ref = ivim_model.apply_all_samples(model, x)
    return plan, served, float((served - ref).abs().max())


def serve_volume(plan: plan_lib.PackedPlan, volume: torch.Tensor,
                 device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """A whole scan in voxel chunks of 128 through the fused plan (one
    launch a chunk, the moments reduced in the kernel)."""
    return engine.predict_volume(plan, volume, chunk=128, device=device)


def run(device=None, *, steps: int = 300, log_every: int = 100) -> dict:
    """The flow on ``device`` (None -> the card). Returns the loss history,
    the first voxel's mean/std/truth, the packed check and the volume's
    moments."""
    dev = device_lib.resolve(device)
    # Phase 1: synthetic scenario (SNR 20)
    ds = ivim_data.make_dataset(ivim_data.SyntheticConfig(
        n_voxels=4000, snr=20.0, seed=0), device=dev)
    # Phase 2: DNN -> mask-based BayesNN, physics-loss training
    cfg = ivim_model.IvimConfig(n_masks=4, scale=2.0)
    model, hist = ivim_train.train(
        cfg, ivim_train.TrainConfig(steps=steps, batch_size=128, lr=3e-3),
        dataset=ds, log_every=log_every, device=dev)
    model.eval()
    x = ds["signals"][:8]
    mean, std = ivim_model.predict(model, x)
    # Phase 3: the serving form
    plan, _, err = packed_check(model, x, device=dev)
    n = VOLUME[0] * VOLUME[1] * VOLUME[2]
    volume = ds["signals"][:n].reshape(*VOLUME, cfg.width)
    vmean, vstd = serve_volume(plan, volume, device=dev)
    return {"cfg": cfg, "loss": hist, "mean": mean[0], "std": std[0],
            "truth": [ds["params"][p][0] for p in ivim_model.PARAM_NAMES],
            "keep": plan.pairs[0].keep, "max_err": err,
            "volume_shape": tuple(volume.shape), "volume_mean": vmean,
            "volume_std": vstd}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    r = run(args.device)
    print(f"loss: {r['loss'][0]:.4f} -> {r['loss'][-1]:.4f}")
    for i, name in enumerate(ivim_model.PARAM_NAMES):
        print(f"{name:>6s}: {float(r['mean'][i]):.5f} "
              f"+/- {float(r['std'][i]):.5f} "
              f"(truth {float(r['truth'][i]):.5f})")
    print(f"packed serving: hidden {r['cfg'].width} -> {r['keep']} "
          f"units/sample, max|err| vs training form = {r['max_err']:.2e}")
    cx, cy = VOLUME[0] // 2, VOLUME[1] // 2
    print(f"volume serving: {r['volume_shape']} -> mean/std "
          f"{tuple(r['volume_mean'].shape)}, D at center = "
          f"{float(r['volume_mean'][cx, cy, 0, 0]):.5f} "
          f"+/- {float(r['volume_std'][cx, cy, 0, 0]):.5f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
