"""Optimizers — AdamW and Adafactor over the parameter tree (the port's
twin of ``repro.optim.optimizers``; not ``torch.optim``).

All updaters share the reference's signature and state trees:

    state = opt.init(params)
    params, state = opt.update(grads, state, params)

AdamW's state is ``{"mu", "nu", "step", "gnorm"}`` and Adafactor's
``{"v": {"vr", "vc"} | {"v"} per leaf, "step", "gnorm"}``, fp32 moments
beside the parameters, so checkpoints carry over both ways. The learning
rate comes from ``state["step"]`` inside the update (a 0-d tensor on the
parameters' device: the step needs no host read).

The update runs in place under ``torch.no_grad()``: parameters and moments
are overwritten, and the trees passed in are the trees returned. Each
update is computed in fp32 and cast back to the parameter's dtype; the
global-norm clip multiplies in the gradient's own dtype. Leaves on a path
through ``"masks"`` (the Masksembles constants) are never
updated or decayed, but their gradients count in the clip's norm, as in
the reference. Stacked leaves (``ndim >= 3``, more than one repeat) are
updated one layer slice at a time, as the reference's ``lax.map`` does:
Adafactor's row-mean and RMS clip are per slice, not per stack.

Divisions whose both sides are tensors stay true divisions on the card
(CUDA divides by a Python number as a multiply by its reciprocal).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.core import tree as tree_lib

Params = Any

__all__ = ["OptimizerConfig", "cosine_schedule", "clip_by_global_norm",
           "adamw", "adafactor", "build_optimizer", "Optimizer"]


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"               # adamw | adafactor
    lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.999                 # adafactor: decay exponent source
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), x, dtype=torch.float32, device=like.device)


def cosine_schedule(cfg: OptimizerConfig, step: torch.Tensor
                    ) -> torch.Tensor:
    """Linear warmup to ``lr``, then a cosine decay to ``min_lr_ratio *
    lr`` at ``decay_steps``; fp32 0-d on ``step``'s device."""
    s = torch.as_tensor(step).float()
    warm = torch.clamp(s / _f32(max(cfg.warmup_steps, 1), s), max=1.0)
    t = torch.clamp((s - cfg.warmup_steps)
                    / _f32(max(cfg.decay_steps - cfg.warmup_steps, 1), s),
                    0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def _global_norm(grads: Params) -> torch.Tensor:
    sq = [torch.sum(torch.square(g.float())) for g in tree_lib.leaves(grads)]
    total = sq[0]
    for s in sq[1:]:
        total = total + s
    return torch.sqrt(total)


def clip_by_global_norm(grads: Params, max_norm: float
                        ) -> tuple[Params, torch.Tensor]:
    """(grads scaled so their global norm is at most ``max_norm``, the norm
    before). The squared sums are taken in fp32; the scale multiplies in
    each gradient's own dtype. New tensors: ``grads`` is left as it
    was."""
    gnorm = _global_norm(grads)
    scale = torch.clamp(_f32(max_norm, gnorm)
                        / torch.clamp(gnorm, min=1e-12), max=1.0)
    return tree_lib.tree_map(lambda g: g * scale.to(g.dtype), grads), gnorm


#: Leaves on a path through this key (the Masksembles constants) are kept
#: out of weight decay and updates.
_FROZEN = "masks"


def _is_frozen(path: tuple) -> bool:
    return _FROZEN in path


#: Stacked leaves of this many dims or more (leading dim = layer repeats)
#: are updated one slice at a time.
_MAP_NDIM = 3


def _slices(*leaves: torch.Tensor):
    """Yield the update's operands slice by slice over axis 0 for a stacked
    leaf, or once whole (``_maybe_map`` of the reference)."""
    lead = leaves[0]
    if lead.ndim >= _MAP_NDIM and lead.shape[0] > 1:
        for i in range(lead.shape[0]):
            yield tuple(t[i] for t in leaves)
    else:
        yield leaves


@dataclasses.dataclass(frozen=True)
class Optimizer:
    cfg: OptimizerConfig
    init: Callable[[Params], Params]
    update: Callable[[Params, Params, Params], tuple[Params, Params]]


def _zeros32(p: torch.Tensor, shape=None) -> torch.Tensor:
    return torch.zeros(p.shape if shape is None else shape,
                       dtype=torch.float32, device=p.device)


def _scalar_state(params: Params) -> dict:
    dev = tree_lib.leaves(params)[0].device
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "gnorm": torch.zeros((), dtype=torch.float32, device=dev)}


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def adamw(cfg: OptimizerConfig) -> Optimizer:
    def init(params: Params) -> Params:
        return {"mu": tree_lib.tree_map(_zeros32, params),
                "nu": tree_lib.tree_map(_zeros32, params),
                **_scalar_state(params)}

    @torch.no_grad()
    def update(grads, state, params):
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
        step = state["step"] + 1
        lr = cosine_schedule(cfg, step)
        c = step.float()
        bias1 = 1 - torch.pow(_f32(cfg.b1, c), c)
        bias2 = 1 - torch.pow(_f32(cfg.b2, c), c)

        def one(p, g, mu, nu):
            g = g.float()
            mu.copy_(cfg.b1 * mu + (1 - cfg.b1) * g)
            nu.copy_(cfg.b2 * nu + (1 - cfg.b2) * g * g)
            u = (mu / bias1) / (torch.sqrt(nu / bias2) + cfg.eps)
            pf = p.float()
            u = u + cfg.weight_decay * pf
            p.copy_((pf - lr * u).to(p.dtype))

        for (path, p), g, mu, nu in zip(
                tree_lib.flatten_with_path(params), tree_lib.leaves(grads),
                tree_lib.leaves(state["mu"]), tree_lib.leaves(state["nu"])):
            if _is_frozen(path):
                continue
            for ops in _slices(p, g, mu, nu):
                one(*ops)
        state.update(step=step, gnorm=gnorm)
        return params, state

    return Optimizer(cfg, init, update)


# ---------------------------------------------------------------------------
# Adafactor (factored second moments)
# ---------------------------------------------------------------------------


def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def _is_moment(x) -> bool:
    return isinstance(x, dict) and ("vr" in x or "v" in x)


def adafactor(cfg: OptimizerConfig) -> Optimizer:
    def init(params: Params) -> Params:
        def state_for(p):
            if _factored(p.shape):
                return {"vr": _zeros32(p, p.shape[:-1]),
                        "vc": _zeros32(p, p.shape[:-2] + p.shape[-1:])}
            return {"v": _zeros32(p)}

        return {"v": tree_lib.tree_map(state_for, params),
                **_scalar_state(params)}

    @torch.no_grad()
    def update(grads, state, params):
        if cfg.clip_norm > 0:
            grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
        else:
            # the per-tensor RMS clip below bounds the steps already
            gnorm = _scalar_state(params)["gnorm"]
        step = state["step"] + 1
        lr = cosine_schedule(cfg, step)
        c = step.float()
        beta2 = 1.0 - torch.pow(c, -0.8)   # Adafactor's decaying beta2

        def finish(p, u):
            # update clipping (RMS <= 1) as in the Adafactor paper
            rms = torch.sqrt(torch.mean(u * u) + 1e-30)
            u = u / torch.clamp(rms, min=1.0)
            pf = p.float()
            u = u + cfg.weight_decay * pf
            p.copy_((pf - lr * u).to(p.dtype))

        def one_factored(p, g, vr, vc):
            g = g.float()
            g2 = g * g + 1e-30
            vr.copy_(beta2 * vr + (1 - beta2) * torch.mean(g2, -1))
            vc.copy_(beta2 * vc + (1 - beta2) * torch.mean(g2, -2))
            denom = (vr[..., None] / torch.mean(vr, -1, keepdim=True)[..., None]
                     * vc[..., None, :])
            finish(p, g * torch.rsqrt(denom + cfg.eps))

        def one_full(p, g, v):
            g = g.float()
            v.copy_(beta2 * v + (1 - beta2) * (g * g + 1e-30))
            finish(p, g * torch.rsqrt(v + cfg.eps))

        moments = [m for _, m in tree_lib.flatten_with_path(
            state["v"], is_leaf=_is_moment)]
        for (path, p), g, v in zip(tree_lib.flatten_with_path(params),
                                   tree_lib.leaves(grads), moments):
            if _is_frozen(path):
                continue
            if "vr" in v:
                for ops in _slices(p, g, v["vr"], v["vc"]):
                    one_factored(*ops)
            else:
                for ops in _slices(p, g, v["v"]):
                    one_full(*ops)
        state.update(step=step, gnorm=gnorm)
        return params, state

    return Optimizer(cfg, init, update)


def build_optimizer(cfg: OptimizerConfig) -> Optimizer:
    if cfg.name == "adamw":
        return adamw(cfg)
    if cfg.name == "adafactor":
        return adafactor(cfg)
    raise ValueError(f"unknown optimizer {cfg.name}")
