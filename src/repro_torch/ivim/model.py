"""IVIM-NET and uIVIM-NET — paper §IV (Fig. 2).

IVIM-NET is 4 identical, separate fully-connected sub-networks, one per IVIM
parameter (D, D*, f, S0). Each is

    linear -> BN -> ReLU -> dropout
    linear -> BN -> ReLU -> dropout
    linear (the "encoder") -> sigmoid -> C(.)

with layer width equal to the number of b-values; C(.) maps the sigmoid
output affinely into the parameter's clinical range. uIVIM-NET replaces the
dropout slots with fixed Masksembles masks; inference evaluates every voxel
under every mask to give mean (prediction) and std (uncertainty).

:class:`IvimNet` keeps the reference's parameter tree: every leaf stacked
``[4, ...]`` over sub-networks (the 4 run as one batched product), BN
running statistics and the masks as buffers. Its ``forward`` is the
reference's ``apply`` (``train`` is the module's training mode). :func:`params_from_jax` builds
one from the reference's ``(params, state)`` trees, so both packages compute
the same thing in the tests.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch
from torch import nn

from repro_torch import device as device_lib
from repro_torch.core import masks as masks_lib
from repro_torch.core import masksembles, uncertainty
from repro_torch.core import plan as plan_lib
from repro_torch.ivim import physics

Params = dict[str, Any]

__all__ = ["IvimConfig", "PARAM_NAMES", "IvimNet", "init", "params_from_jax",
           "apply_all_samples", "predict", "reconstruct", "fold_bn",
           "pack_for_serving", "packed_apply"]

PARAM_NAMES = ("D", "Dstar", "f", "S0")
_BN_MOMENTUM = 0.1
_BN_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class IvimConfig:
    """uIVIM-NET configuration.

    b_values: acquisition protocol; network width == len(b_values).
    n_masks/scale: Masksembles hyperparameters; n_masks=0 disables masking
      (plain IVIM-NET).
    out_ranges: C(.) output ranges per parameter, (lo, hi).
    """
    b_values: tuple[float, ...] = physics.CLINICAL_B_VALUES
    n_masks: int = 4
    scale: float = 2.0
    use_batchnorm: bool = True
    mask_seed: int = 0
    out_ranges: tuple[tuple[float, float], ...] = (
        (0.0, 0.005),    # D
        (0.005, 0.2),    # D*
        (0.0, 0.7),      # f
        (0.8, 1.2),      # S0
    )

    @property
    def width(self) -> int:
        return len(self.b_values)

    @property
    def bayesian(self) -> bool:
        return self.n_masks > 0


@functools.lru_cache(maxsize=32)
def _const(values: tuple[float, ...], device: torch.device,
           dtype: torch.dtype) -> torch.Tensor:
    # Made once per (values, device, dtype): a host-to-card copy on every
    # forward would stall each training step.
    return torch.tensor(values, dtype=dtype, device=device)


def _param_dict(leaves: Params) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v) for k, v in leaves.items()})


class IvimNet(nn.Module):
    """uIVIM-NET with the 4 sub-networks stacked on a leading axis.

    ``params``/``state`` are the reference's trees as tensors:
    fc1/fc2/enc {w [4, d_in, d_out], b [4, d_out]}, bn1/bn2 {gamma, beta}
    [4, W] and mask1/mask2 [N, W]; state bn1/bn2 {mean, var} [4, W].
    ``forward(x, mask_ids)`` maps [B, Nb] -> [B, 4] in the clinical ranges,
    with BN on batch statistics in training mode (updating the running
    buffers) and on the running statistics in eval mode.
    """

    def __init__(self, cfg: IvimConfig, params: Params, state: Params):
        super().__init__()
        self.cfg = cfg
        self.fc1 = _param_dict(params["fc1"])
        self.fc2 = _param_dict(params["fc2"])
        self.enc = _param_dict(params["enc"])
        if cfg.use_batchnorm:
            self.bn1 = _param_dict(params["bn1"])
            self.bn2 = _param_dict(params["bn2"])
            for i in (1, 2):
                self.register_buffer(f"bn{i}_mean", state[f"bn{i}"]["mean"])
                self.register_buffer(f"bn{i}_var", state[f"bn{i}"]["var"])
        if cfg.bayesian:
            self.register_buffer("mask1", params["mask1"])
            self.register_buffer("mask2", params["mask2"])

    def trees(self) -> tuple[Params, Params]:
        """The reference-shaped ``(params, state)`` views of this module's
        own tensors (what ``plan.compile_ivim`` consumes)."""
        params: Params = {k: dict(getattr(self, k).items())
                          for k in ("fc1", "fc2", "enc")}
        state: Params = {}
        if self.cfg.use_batchnorm:
            for i in (1, 2):
                params[f"bn{i}"] = dict(getattr(self, f"bn{i}").items())
                state[f"bn{i}"] = {"mean": getattr(self, f"bn{i}_mean"),
                                   "var": getattr(self, f"bn{i}_var")}
        if self.cfg.bayesian:
            params["mask1"], params["mask2"] = self.mask1, self.mask2
        return params, state

    def _bn(self, i: int, h: torch.Tensor, train: bool) -> torch.Tensor:
        bn = getattr(self, f"bn{i}")
        mean_buf = getattr(self, f"bn{i}_mean")
        var_buf = getattr(self, f"bn{i}_var")
        if train:
            mean = h.mean(dim=1)
            var = h.var(dim=1, correction=0)
            with torch.no_grad():
                mean_buf.copy_((1 - _BN_MOMENTUM) * mean_buf
                               + _BN_MOMENTUM * mean)
                var_buf.copy_((1 - _BN_MOMENTUM) * var_buf
                              + _BN_MOMENTUM * var)
        else:
            mean, var = mean_buf, var_buf
        return ((h - mean[:, None]) * torch.rsqrt(var[:, None] + _BN_EPS)
                * bn["gamma"][:, None] + bn["beta"][:, None])

    def _forward(self, x: torch.Tensor, mask_ids: torch.Tensor | None,
                 train: bool) -> torch.Tensor:
        cfg = self.cfg
        m1 = m2 = None
        if cfg.bayesian:
            if mask_ids is None:
                mask_ids = masksembles.mask_ids_for_batch(
                    x.shape[0], cfg.n_masks, x.device)
            m1, m2 = self.mask1[mask_ids], self.mask2[mask_ids]
        h = torch.matmul(x, self.fc1["w"]) + self.fc1["b"][:, None, :]
        if cfg.use_batchnorm:
            h = self._bn(1, h, train)
        h = torch.relu(h)                             # [4, B, W]
        if m1 is not None:
            h = h * m1
        h = torch.matmul(h, self.fc2["w"]) + self.fc2["b"][:, None, :]
        if cfg.use_batchnorm:
            h = self._bn(2, h, train)
        h = torch.relu(h)
        if m2 is not None:
            h = h * m2
        z = torch.matmul(h, self.enc["w"]) + self.enc["b"][:, None, :]
        sig = torch.sigmoid(z[..., 0])                # [4, B]
        lo = _const(tuple(r[0] for r in cfg.out_ranges), sig.device,
                    sig.dtype)[:, None]
        hi = _const(tuple(r[1] for r in cfg.out_ranges), sig.device,
                    sig.dtype)[:, None]
        return (lo + sig * (hi - lo)).T               # C(.) -> [B, 4]

    def forward(self, x: torch.Tensor,
                mask_ids: torch.Tensor | None = None) -> torch.Tensor:
        """x [B, Nb] -> IVIM parameters [B, 4]. ``mask_ids`` [B] picks each
        example's mask (default: the contiguous-group training layout)."""
        return self._forward(x, mask_ids, self.training)


def _stack(trees: list[Params]) -> Params:
    return {k: _stack([t[k] for t in trees]) if isinstance(trees[0][k], dict)
            else torch.stack([t[k] for t in trees]) for k in trees[0]}


def init(cfg: IvimConfig, generator: torch.Generator,
         device: torch.device | str | None = None) -> IvimNet:
    """Random uIVIM-NET: He-normal weights drawn from ``generator``, zero
    biases, identity BN, masks from the seeded Masksembles construction;
    moved to ``device`` (None -> the card)."""
    dev = device_lib.resolve(device)
    w = cfg.width
    subnets = [{"fc1": masksembles.dense_init(generator, w, w),
                "fc2": masksembles.dense_init(generator, w, w),
                "enc": masksembles.dense_init(generator, w, 1)}
               for _ in PARAM_NAMES]
    params = _stack(subnets)
    state: Params = {}
    g = len(PARAM_NAMES)
    if cfg.use_batchnorm:
        for slot in ("bn1", "bn2"):
            params[slot] = {"gamma": torch.ones(g, w),
                            "beta": torch.zeros(g, w)}
            state[slot] = {"mean": torch.zeros(g, w), "var": torch.ones(g, w)}
    if cfg.bayesian:
        for slot in ("mask1", "mask2"):
            spec = masks_lib.MaskSpec(width=w, n_masks=cfg.n_masks,
                                      scale=cfg.scale,
                                      seed=cfg.mask_seed + (slot == "mask2"))
            params[slot] = torch.from_numpy(
                masks_lib.generate_masks(spec).astype(np.float32))
    to = plan_lib.tree_map
    return IvimNet(cfg, to(lambda t: t.to(dev), params),
                   to(lambda t: t.to(dev), state))


def params_from_jax(cfg: IvimConfig, params: Params, state: Params,
                    device: torch.device | str | None = None) -> IvimNet:
    """An :class:`IvimNet` holding the reference's ``(params, state)``
    trees (numpy arrays or anything ``np.asarray`` takes), as fp32 on
    ``device`` (None -> the card)."""
    dev = device_lib.resolve(device)

    def conv(a) -> torch.Tensor:      # a copy: the module owns its tensors
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    return IvimNet(cfg, plan_lib.tree_map(conv, params),
                   plan_lib.tree_map(conv, state))


@torch.no_grad()
def apply_all_samples(model: IvimNet, x: torch.Tensor) -> torch.Tensor:
    """Inference: every voxel under every mask -> [N, B, 4] (BN on the
    running statistics, whatever the module's mode)."""
    cfg = model.cfg
    if not cfg.bayesian:
        return model._forward(x, None, train=False)[None]
    xs, ids = masksembles.repeat_for_samples(x, cfg.n_masks)
    y = model._forward(xs, ids, train=False)
    return y.reshape(cfg.n_masks, x.shape[0], len(PARAM_NAMES))


def predict(model: IvimNet, x: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean [B, 4], std [B, 4]) — prediction + uncertainty (paper §IV)."""
    return uncertainty.predictive_moments(apply_all_samples(model, x))


def reconstruct(cfg: IvimConfig, ivim_params: torch.Tensor) -> torch.Tensor:
    """Eq. (1): normalized signals [..., Nb] from predictions [..., 4]."""
    d, dstar, f, s0 = (ivim_params[..., i] for i in range(4))
    b = _const(cfg.b_values, ivim_params.device, ivim_params.dtype)
    return physics.ivim_signal(b, d, dstar, f, s0)


# ---- Phase-3 serving form: compiled by the core mask pipeline --------------


@torch.no_grad()
def fold_bn(model: IvimNet) -> Params:
    """Inference-mode BN folded into the preceding dense: the params tree
    with plain fc1/fc2 (w', b') and no bn — exact at eval time."""
    params, state = model.trees()
    if not model.cfg.use_batchnorm:
        return params
    return plan_lib.fold_bn_ivim(params, state)


def pack_for_serving(model: IvimNet) -> plan_lib.PackedPlan:
    """Mask-zero skipping over the fc1 -> fc2 -> enc chain (paper §V-C):
    one PackedPair plus the sigmoid OutputHead, the 4 sub-networks
    flattened onto the kernel sample axis, on the model's device."""
    return plan_lib.compile_ivim(model.cfg, *model.trees())


def packed_apply(plan: plan_lib.PackedPlan, x: torch.Tensor, *,
                 fused: bool = False,
                 device: torch.device | str | None = None) -> torch.Tensor:
    """Batch-level packed inference: [B, Nb] -> samples [N, B, 4]. The
    per-op executor launches the masked_ffn kernel for the PackedPair;
    ``fused=True`` runs the whole chain in ONE fused_plan launch."""
    if fused:
        return plan_lib.execute_fused(plan, x, device=device)
    return plan_lib.execute(plan, x, device=device)
