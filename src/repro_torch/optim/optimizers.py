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
Adafactor's row-mean and RMS clip are per slice, not per stack. A factored
slice of more than ``_CHUNK_ELEMS`` elements whose whole-slice update would
not fit (on the card: its fp32 temporaries against the free memory, as at
arctic-480b's one-layer expert stack, [128, 7168, 4864]; on the host:
always) is updated a block of rows at a time, in three passes (the moments,
the RMS of the whole slice's update, the step), so that its fp32
temporaries size with one block: the clip still spans the whole slice, as
in the reference.

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


#: Factored slices above this many elements take Adafactor's blocked update
#: where the whole-slice form does not fit, in blocks of at most this many
#: (1 GB an fp32 block).
_CHUNK_ELEMS = 1 << 28
#: Bytes of fp32 temporaries the whole-slice update holds at once, per
#: element of the slice: eight copies (25.5 measured at qwen2-vl-72b's
#: [152064, 8192] embedding on an H100).
_WHOLE_BYTES = 32


def _whole_fits(numel: int, device: torch.device) -> bool:
    """Whether a factored slice of ``numel`` elements takes the whole-slice
    update: at most ``_CHUNK_ELEMS``, or, on the card, temporaries that fit
    in the memory it has free (the caching allocator's free blocks
    included). A larger slice on the host takes the blocked update."""
    if numel <= _CHUNK_ELEMS:
        return True
    if device.type != "cuda":
        return False
    free, _ = torch.cuda.mem_get_info(device)
    free += (torch.cuda.memory_reserved(device)
             - torch.cuda.memory_allocated(device))
    return _WHOLE_BYTES * numel <= free


def _row_blocks(n: int, r: int, c: int, limit: int):
    """Blocks (n0, n1, r0, r1) covering an [n, r, c] slice, each at most
    ``limit`` elements (or one row): whole [r, c] matrices where one fits,
    else row ranges of one matrix."""
    if r * c <= limit:
        step = max(1, limit // (r * c))
        return [(i, min(i + step, n), 0, r) for i in range(0, n, step)]
    rows = max(1, limit // c)
    return [(i, i + 1, j, min(j + rows, r))
            for i in range(n) for j in range(0, r, rows)]


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

        def step_by(p, u, rms):
            u = u / torch.clamp(rms, min=1.0)
            pf = p.float()
            u = u + cfg.weight_decay * pf
            p.copy_((pf - lr * u).to(p.dtype))

        def finish(p, u):
            # update clipping (RMS <= 1) as in the Adafactor paper
            step_by(p, u, torch.sqrt(torch.mean(u * u) + 1e-30))

        def blocked_factored(p, g, vr, vc):
            # the moments a block at a time (vc from the column sums of
            # every block), then the update's sum of squares over the
            # whole slice, then the step: each block's update is computed
            # twice rather than held
            r, c = p.shape[-2:]
            p3, g3 = p.view(-1, r, c), g.reshape(-1, r, c)
            vr2, vc2 = vr.view(-1, r), vc.view(-1, c)
            blocks = _row_blocks(p3.shape[0], r, c, _CHUNK_ELEMS)
            cols = torch.zeros_like(vc2)
            for n0, n1, r0, r1 in blocks:
                gb = g3[n0:n1, r0:r1].float()
                g2 = gb * gb + 1e-30
                rows = vr2[n0:n1, r0:r1]
                rows.copy_(beta2 * rows + (1 - beta2) * torch.mean(g2, -1))
                cols[n0:n1] += g2.sum(-2)
                del gb, g2
            vc2.copy_(beta2 * vc2 + (1 - beta2) * (cols / r))
            scale = vr2 / torch.mean(vr2, -1, keepdim=True)

            def update(n0, n1, r0, r1):
                denom = scale[n0:n1, r0:r1, None] * vc2[n0:n1, None, :]
                return g3[n0:n1, r0:r1].float() * torch.rsqrt(denom
                                                              + cfg.eps)

            sq = torch.zeros((), dtype=torch.float32, device=p.device)
            for blk in blocks:
                u = update(*blk)
                sq += torch.sum(u * u)
                del u
            rms = torch.sqrt(sq / p.numel() + 1e-30)
            for n0, n1, r0, r1 in blocks:
                step_by(p3[n0:n1, r0:r1], update(n0, n1, r0, r1), rms)

        def one_factored(p, g, vr, vc):
            if not _whole_fits(p.numel(), p.device):
                blocked_factored(p, g, vr, vc)
                return
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
