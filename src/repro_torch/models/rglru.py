"""RecurrentGemma building blocks: the RG-LRU, its short causal conv and the
gated recurrent block (the port's twin of ``repro.models.rglru``).

RG-LRU (De et al., arXiv:2402.19427):
    r_t = sigmoid(W_a x_t + b_a)            (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)            (input gate)
    a_t = a ^ (c * r_t),  a = sigmoid(Lambda)   (per-channel, c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The gates are computed in PyTorch (fp32); the prefill's recurrence over
time is the ``rglru_scan`` kernel (``kernels/rglru_scan``: one pass over
the gates with the carry in a register, where the reference runs
``jax.lax.associative_scan``), reached through the autograd Function
``RGLRUScan``, so that training differentiates it with the kernel's
backward (the same recurrence in reverse time). Decode is the one-step
recurrence.

Block: ``y = W_out(GeLU(W_gate x) * RG-LRU(conv1d_4(W_in x)))``.

The parameter layout is the reference's (``wgate``, ``win``, ``wout``,
``conv``, ``lru.{wa, wx, lambda}``). ``lambda`` (:data:`FP32_PARAMS`) and
the state ``h`` stay fp32 whatever the model's dtype.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core import plan as plan_lib
from repro_torch.kernels.rglru_scan import ops as scan_ops
from repro_torch.models import layers

Params = dict[str, Any]

__all__ = ["FP32_PARAMS", "rglru_init", "rglru_scan", "rglru_step",
           "rec_block_init", "rec_block_apply", "rec_block_step",
           "rec_state_init", "rec_state_specs"]

#: Parameters kept in fp32 in a model of any dtype: rounding the decay
#: parameter would move every a_t.
FP32_PARAMS = ("lambda",)

_C = 8.0  # RG-LRU exponent constant
_MIN_RAD, _MAX_RAD = 0.9, 0.999


def rglru_init(gen: torch.Generator, width: int, dtype) -> Params:
    # Lambda so that a = sigmoid(Lambda) lands in [0.9, 0.999]
    u = torch.rand((width,), generator=gen, device=gen.device)
    a = _MIN_RAD + u * (_MAX_RAD - _MIN_RAD)
    return {"wa": layers.dense_init(gen, width, width, dtype, bias=True),
            "wx": layers.dense_init(gen, width, width, dtype, bias=True),
            "lambda": torch.log(a / (1 - a)).float()}


def _gate_math(za: torch.Tensor, zx: torch.Tensor, x: torch.Tensor,
               lam: torch.Tensor):
    """The gates from the two projections (elementwise over [B, S, W],
    ``lambda`` broadcast over W) -> (a, b) fp32."""
    r = torch.sigmoid(za.float())
    i = torch.sigmoid(zx.float())
    log_a_base = F.logsigmoid(lam)                      # log a  (< 0)
    log_a = _C * r * log_a_base                         # a_t = a^(c r_t)
    a = torch.exp(log_a)
    gated_x = i * x.float()
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * gated_x
    return a, b


def _gates(p: Params, x: torch.Tensor):
    return _gate_math(layers.dense(p["wa"], x), layers.dense(p["wx"], x), x,
                      p["lambda"])


def _gate_scan(za, zx, x, lam) -> torch.Tensor:
    a, b = _gate_math(za, zx, x, lam)
    return scan_ops.RGLRUScan.apply(a, b)


def _on_local_shards(fn, za, zx, x, lam) -> torch.Tensor:
    """``fn(za, zx, x, lam)`` -> h [B, S, W]; on DTensors, run on each
    rank's local shard (``local_map``): the gates and the scan are
    independent across batch and width, so a [B, S, W] layout sharded over
    B and W needs no collective, and on the card each rank's shard is one
    kernel launch. ``lambda`` follows W's shards; its gradient is partial
    over the mesh dims that shard B. A sequence shard raises
    ``ValueError`` (the recurrence crosses it); otherwise, under an
    ambient mesh, the operands take the layout B over the batch axes and W
    over "model" (a hint, as ``layers.constrain``)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not isinstance(x, DTensor):
        return fn(za, zx, x, lam)
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    if any(d.is_shard(1) for d in x.placements):
        raise ValueError(f"rglru_scan: the sequence dim of x {x.placements} "
                         f"is sharded; the recurrence runs over the whole "
                         f"sequence on one rank")
    # DTensor's propagation may leave B sharded over "model" as well:
    # state the scan's layout; a partial sum is reduced first, and the
    # operands share x's layout
    x = layers.constrain(x, ("batch", None, "model"))
    pl = tuple(Replicate() if d.is_partial() else d for d in x.placements)
    za, zx, x = (t.redistribute(mesh, pl) for t in (za, zx, x))
    lam_pl = tuple(Shard(0) if d.is_shard(2) else Replicate() for d in pl)
    lam = lam.redistribute(mesh, lam_pl)
    lam_grad = tuple(Shard(0) if d.is_shard(2) else
                     Partial() if d.is_shard(0) else Replicate()
                     for d in pl)
    return local_map(fn, out_placements=(pl,),
                     in_placements=(pl, pl, pl, lam_pl),
                     in_grad_placements=(pl, pl, pl, lam_grad),
                     device_mesh=mesh)(za, zx, x, lam)


def rglru_scan(p: Params, x: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Prefill and training: x [B, S, W] -> (y [B, S, W] in x's dtype,
    final state [B, W] fp32); the recurrence is one ``rglru_scan`` launch
    on the card, and its gradient one backward launch (on DTensors: one
    each a rank, on its local shard)."""
    hh = _on_local_shards(_gate_scan, layers.dense(p["wa"], x),
                          layers.dense(p["wx"], x), x, p["lambda"])
    return hh.to(x.dtype), hh[:, -1]


def rglru_step(p: Params, x: torch.Tensor, h: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode: x [B, W], h [B, W] fp32 -> (y in x's dtype, h_new fp32)."""
    a, b = _gates(p, x[:, None, :])
    h_new = a[:, 0] * h + b[:, 0]
    return h_new.to(x.dtype), h_new


# ---------------------------------------------------------------------------
# full recurrent block (gate branch * LRU branch)
# ---------------------------------------------------------------------------


def rec_block_init(gen: torch.Generator, cfg, dtype) -> Params:
    d = cfg.d_model
    w = cfg.lru_width or d
    conv = torch.randn((cfg.conv_width, w), generator=gen, device=gen.device)
    return {
        "wgate": layers.dense_init(gen, d, w, dtype),
        "win": layers.dense_init(gen, d, w, dtype),
        "wout": layers.dense_init(gen, w, d, dtype,
                                  scale=1.0 / math.sqrt(w)),
        "conv": (conv / math.sqrt(cfg.conv_width)).to(dtype),
        "lru": rglru_init(gen, w, dtype),
    }


def _causal_conv(w: torch.Tensor, x: torch.Tensor,
                 state: torch.Tensor | None = None):
    """Depthwise causal conv over time in x's dtype, taps summed in order:
    x [B, S, W], w [K, W] -> (y [B, S, W], new state [B, K-1, W])."""
    kw = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], kw - 1, x.shape[2]))
    xp = torch.cat([state, x], 1)
    s = x.shape[1]
    y = sum(xp[:, i:i + s] * w[i] for i in range(kw))
    return y, (xp[:, -(kw - 1):] if kw > 1 else state)


def rec_state_specs(batch: int, cfg, dtype) -> dict[str, tuple]:
    """``{leaf: (shape, dtype)}`` of one block's state: ``h`` fp32 and the
    conv window in the model's dtype."""
    w = cfg.lru_width or cfg.d_model
    return {"h": ((batch, w), torch.float32),
            "conv": ((batch, cfg.conv_width - 1, w), dtype)}


def rec_state_init(batch: int, cfg, dtype, device=None) -> Params:
    """A zero state."""
    return {name: torch.zeros(shape, dtype=dt, device=device)
            for name, (shape, dt) in rec_state_specs(batch, cfg,
                                                     dtype).items()}


def rec_block_apply(p: Params, x: torch.Tensor, cfg
                    ) -> tuple[torch.Tensor, Params]:
    """Prefill: x [B, S, D] -> (y [B, S, D], final recurrent state)."""
    act = plan_lib.activation_fn("gelu")
    gate = act(layers.dense(p["wgate"], x))
    u = layers.dense(p["win"], x)
    u, conv_state = _causal_conv(p["conv"], u)
    lru_out, h_last = rglru_scan(p["lru"], u)
    y = layers.dense(p["wout"], gate * lru_out)
    return y, {"h": h_last, "conv": conv_state}


def rec_block_step(p: Params, x: torch.Tensor, state: Params, cfg
                   ) -> tuple[torch.Tensor, Params]:
    """Decode: x [B, D] -> (y [B, D], new state)."""
    act = plan_lib.activation_fn("gelu")
    gate = act(layers.dense(p["wgate"], x))
    u = layers.dense(p["win"], x)
    u3, conv_state = _causal_conv(p["conv"], u[:, None, :], state["conv"])
    lru_out, h_new = rglru_step(p["lru"], u3[:, 0, :], state["h"])
    y = layers.dense(p["wout"], gate * lru_out)
    return y, {"h": h_new, "conv": conv_state}
