"""The algorithm–hardware co-optimization flow (paper Fig. 1, Phases 1–3).

Phase 1 (Preparation): a dropout-equipped network spec + uncertainty
  requirements + synthetic-data recipe.
Phase 2 (Algorithm): replace dropout slots with fixed Masksembles masks,
  train, evaluate against the requirements; iterate hyperparameters
  (the paper grid-searches drop rate 0.1–0.9 and N ∈ {4,8,16,32,64}).
Phase 3 (Hardware): emit a hardware plan — packed weights (mask-zero
  skipping), a sample schedule (batch-level), and a modeled latency on the
  card — for the accepted model.

Architecture-agnostic: it operates on :class:`MlpSpec` (a chain of FC
layers with dropout positions — IVIM-NET's sub-networks and any "mainstream
network equipped with dropout layers", §III Phase 1). Random draws come
from a ``torch.Generator``; the masks from ``core/masks.py`` with the
reference's seeds, so they equal the reference's. :func:`params_from_jax`
carries a reference model's parameters over, for the parity tests.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core import latency_model, masks as masks_lib, masksembles
from repro_torch.core import plan as plan_lib
from repro_torch.core import scheduler as sched_lib
from repro_torch.core import uncertainty as unc_lib

Params = dict[str, Any]

__all__ = ["MlpSpec", "MaskedMlp", "convert", "params_from_jax",
           "HardwarePlan", "plan_hardware", "grid_search_space"]


@dataclasses.dataclass(frozen=True)
class MlpSpec:
    """A dropout-equipped FC chain: widths[0] → ... → widths[-1].

    dropout_after: indices of hidden layers followed by a dropout slot
      (those — and only those — receive masks).
    activation: zero-preserving nonlinearity name ('relu'|'gelu'|'silu');
      zero-preservation is what makes mask-zero skipping exact.
    final_activation: e.g. 'sigmoid' for IVIM-NET's encoder output.
    """
    widths: tuple[int, ...]
    dropout_after: tuple[int, ...]
    activation: str = "relu"
    final_activation: str | None = "sigmoid"

    def __post_init__(self) -> None:
        if len(self.widths) < 2:
            raise ValueError("need at least input and output widths")
        for i in self.dropout_after:
            if not 0 < i < len(self.widths) - 1:
                raise ValueError(f"dropout_after index {i} is not a hidden "
                                 f"layer")


@dataclasses.dataclass
class MaskedMlp:
    """Phase-2 artifact: an MLP whose dropout slots became fixed masks.
    ``params``: {"fc<i>": {w [d_in, d_out], b [d_out], masks [N, d_out]?}}
    tensors on one device."""
    spec: MlpSpec
    n_masks: int
    scale: float
    params: Params

    # ---- training form -----------------------------------------------------
    def apply(self, params: Params, x: torch.Tensor,
              mask_ids: torch.Tensor | None = None) -> torch.Tensor:
        n_layers = len(self.spec.widths) - 1
        if mask_ids is None:
            mask_ids = masksembles.mask_ids_for_batch(x.shape[0],
                                                      self.n_masks, x.device)
        act = plan_lib.ACTIVATIONS[self.spec.activation]
        h = x
        for i in range(n_layers):
            layer = params[f"fc{i}"]
            h = h @ layer["w"] + layer["b"]
            if i < n_layers - 1:
                h = act(h)
                if (i + 1) in self.spec.dropout_after:
                    h = h * layer["masks"][mask_ids]
            elif self.spec.final_activation:
                h = plan_lib.ACTIVATIONS[self.spec.final_activation](h)
        return h

    def apply_all_samples(self, params: Params, x: torch.Tensor
                          ) -> torch.Tensor:
        """[N, B, d_out] — every input under every mask (inference)."""
        xs, ids = masksembles.repeat_for_samples(x, self.n_masks)
        y = self.apply(params, xs, ids)
        return y.reshape(self.n_masks, x.shape[0], -1)

    def predict(self, params: Params, x: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """(mean, std) [B, d_out]: one ``moments`` launch on the card."""
        return unc_lib.predictive_moments(self.apply_all_samples(params, x))


def convert(spec: MlpSpec, n_masks: int, scale: float,
            generator: torch.Generator, dtype: torch.dtype = torch.float32,
            mask_seed: int = 0,
            device: torch.device | str | None = None) -> MaskedMlp:
    """Phase 2 conversion: DNN spec (+dropout slots) → mask-based BayesNN.
    Weights are He-normal draws from ``generator`` (on its device), layer
    by layer; the masks of layer i are ``MaskSpec(seed=mask_seed + i)``, as
    in the reference. Everything is stored on ``device`` (None -> the
    card)."""
    dev = device_lib.resolve(device)
    params: Params = {}
    for i in range(len(spec.widths) - 1):
        d_in, d_out = spec.widths[i], spec.widths[i + 1]
        layer = {k: v.to(dev, dtype) for k, v in
                 masksembles.dense_init(generator, d_in, d_out).items()}
        if (i + 1) in spec.dropout_after:
            mspec = masks_lib.MaskSpec(width=d_out, n_masks=n_masks,
                                       scale=scale, seed=mask_seed + i)
            layer["masks"] = torch.from_numpy(
                masks_lib.generate_masks(mspec).astype(np.float32)).to(
                    dev, dtype)
        params[f"fc{i}"] = layer
    return MaskedMlp(spec=spec, n_masks=n_masks, scale=scale, params=params)


def params_from_jax(model, device: torch.device | str | None = None
                    ) -> MaskedMlp:
    """A :class:`MaskedMlp` holding a reference ``MaskedMlp``'s spec and
    parameters (numpy arrays or anything ``np.asarray`` takes), as fp32 on
    ``device`` (None -> the card)."""
    dev = device_lib.resolve(device)
    s = model.spec
    spec = MlpSpec(widths=tuple(s.widths),
                   dropout_after=tuple(s.dropout_after),
                   activation=s.activation,
                   final_activation=s.final_activation)
    params = {name: {k: torch.tensor(np.asarray(v, np.float32), device=dev)
                     for k, v in layer.items()}
              for name, layer in model.params.items()}
    return MaskedMlp(spec=spec, n_masks=int(model.n_masks),
                     scale=float(model.scale), params=params)


def grid_search_space(widths_scales: Sequence[float] = (1.2, 1.5, 2.0, 3.0),
                      sample_counts: Sequence[int] = (4, 8, 16, 32, 64)):
    """Phase-2 hyperparameter grid (paper: drop rate 0.1–0.9 × N∈{4..64});
    scale is the Masksembles parameterization of drop rate."""
    for s in widths_scales:
        for n in sample_counts:
            yield {"scale": s, "n_masks": n}


# ---- Phase 3 ----------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HardwarePlan:
    """Phase-3 artifact: how to serve the accepted model on the card."""
    plan: plan_lib.PackedPlan            # compiled serving program (op IR)
    schedule: sched_lib.Schedule         # batch-level by default
    modeled_latency_s: float             # latency_model estimate per batch
    modeled_baseline_s: float            # sampling-level, unpacked estimate
    traffic: sched_lib.TrafficModel
    notes: tuple[str, ...] = ()

    @property
    def modeled_speedup(self) -> float:
        return self.modeled_baseline_s / max(self.modeled_latency_s, 1e-30)


def plan_hardware(model: MaskedMlp, batch: int,
                  spec: latency_model.DeviceSpec = latency_model.H100,
                  bytes_per_el: int = 2) -> HardwarePlan:
    """The compiled PackedPlan + schedule + modeled latency of a MaskedMlp.

    Compilation is :func:`plan.compile_mlp`'s; latency and traffic are
    priced from the plan's own op metadata at ``bytes_per_el`` (2: bf16
    operands, as the reference prices them) — the packed run on the
    batch-level schedule vs the unpacked sampling-level baseline on the
    same op list, so the ratio isolates the paper's two optimizations.
    """
    pplan = plan_lib.compile_mlp(model)
    notes = ("mask-zero skipping: packed dense per-sample weights",
             "batch-level schedule: weights loaded once per sample per batch",
             "sub-networks and masks share one batched sample axis")
    return HardwarePlan(
        plan=pplan, schedule=pplan.schedule,
        modeled_latency_s=pplan.modeled_latency(
            batch, spec=spec, bytes_per_el=bytes_per_el),
        modeled_baseline_s=pplan.modeled_latency(
            batch, spec=spec, packed=False, batch_level=False,
            bytes_per_el=bytes_per_el),
        traffic=pplan.traffic(batch, bytes_per_el), notes=notes)
