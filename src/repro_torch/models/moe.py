"""Mixture-of-Experts FFN — GShard-style grouped top-k capacity routing (the
port's twin of ``repro.models.moe``).

Tokens are split into groups of ``moe_group_size`` (every row of the batch
shares the grouping); within each group every token picks its top-k
experts and takes a capacity slot in each, in token-major order.
Over-capacity tokens are dropped: their expert output is zero and the
residual stream carries them through. Dispatch and combine are one-hot
products and the expert FFNs one batched product per weight, all over the
whole expert stack, as in the reference (no kernel of its own: these are
plain matrix products). A dropped token makes a row's output depend on the
other rows of its group, so pooled and one-shot serving agree only where
the capacity drops nothing.

Masksembles over expert hidden units: each token's mask id rides the
dispatch one-hot, so each capacity slot knows which fixed mask to apply to
its expert's hidden layer (the router is untouched).

Top-k breaks ties by the lower expert index, as ``jax.lax.top_k`` does
(``torch.topk`` does not promise an order among equal values): router
logits out of a bf16 dense layer tie at full width.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.core import plan as plan_lib
from repro_torch.models import layers

Params = dict[str, Any]

__all__ = ["moe_init", "moe_apply", "top_k"]


def moe_init(gen: torch.Generator, cfg, dtype) -> Params:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    scale = 1.0 / math.sqrt(d)
    p: Params = {
        "router": layers.dense_init(gen, d, e, dtype),
        # experts stacked on a leading E axis
        "weg": layers._randn(gen, (e, d, f), scale, dtype),
        "weu": layers._randn(gen, (e, d, f), scale, dtype),
        "wed": layers._randn(gen, (e, f, d), 1.0 / math.sqrt(f), dtype),
    }
    if cfg.moe_dense_residual:      # arctic: dense FFN in parallel
        p["dense"] = layers.ffn_init(gen, cfg, dtype=dtype)
    if cfg.bayesian:
        p["masks"] = layers.mask_table(cfg, f, dtype, gen.device)
    return p


def _capacity(cfg, group: int) -> int:
    c = int(cfg.capacity_factor * cfg.top_k * group / cfg.n_experts)
    return max(cfg.top_k, min(group, c))


def _group_size(cfg, tokens: int) -> int:
    """``moe_group_size``, or the reference's divisor of ``tokens`` near it
    when it does not divide them."""
    group = min(cfg.moe_group_size, tokens)
    if tokens % group:
        group = tokens // max(1, tokens // group)   # largest divisor <= group
        while tokens % group:
            group += 1
    return group


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries of the last axis, largest first, equal values
    in index order (``jax.lax.top_k``'s order): a stable descending
    sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_apply(p: Params, x: torch.Tensor, cfg,
              mask_ids: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (y [B, S, D], aux_loss fp32 scalar).

    aux_loss is the standard load-balancing loss (mean over groups of
    E * sum_e f_e * P_e), weighted by the caller."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    tokens = b * s
    group = _group_size(cfg, tokens)
    n_groups = tokens // group
    cap = _capacity(cfg, group)

    xt = x.reshape(n_groups, group, d)
    logits = layers.dense(p["router"], xt).float()              # [G,T,E]
    probs = torch.softmax(logits, -1)

    # top-k selection; slot assignment by prefix-sum position per expert
    topv, topi = top_k(probs, k)                                # [G,T,k]
    experts = torch.arange(e, device=x.device)
    onehot = (topi[..., None] == experts).float()               # [G,T,k,E]
    # position of each (token, choice) within its expert's queue
    pos = torch.cumsum(onehot.reshape(n_groups, group * k, e), 1)
    pos = pos.reshape(n_groups, group, k, e) * onehot - 1.0     # [G,T,k,E]
    keep = (pos >= 0) & (pos < cap)
    gate = topv[..., None] * keep                               # [G,T,k,E]
    # one-hot of the slot; a dropped (token, choice) has none
    slot_oh = ((pos[..., None] == torch.arange(cap, device=x.device))
               & keep[..., None])                               # [G,T,k,E,C]
    # at most one choice of a token lands on an expert: the sums over k
    # below add one term
    dispatch = (onehot[..., None] * slot_oh).sum(2).to(x.dtype)  # [G,T,E,C]
    combine = (gate[..., None] * slot_oh).sum(2)                # fp32

    # ---- dispatch -> expert FFN -> combine --------------------------------
    # Expert-parallel activation layout (the reference's hints; identity
    # without a mesh): slot tensors shard the expert dim over "model" and
    # the group dim over the batch axes — unless the groups nest inside
    # sequence shards (moe_local_groups).
    ep = None if cfg.moe_local_groups else ("batch", "model", None, None)
    xe = torch.einsum("gtec,gtd->gecd", dispatch, xt)           # [G,E,C,D]
    xe = layers.constrain(xe, ep) if ep else xe
    act = plan_lib.activation_fn("silu" if cfg.activation == "silu"
                                 else "gelu")
    h = act(torch.einsum("gecd,edf->gecf", xe, p["weg"])) * \
        torch.einsum("gecd,edf->gecf", xe, p["weu"])            # [G,E,C,F]
    h = layers.constrain(h, ep) if ep else h
    if mask_ids is not None and "masks" in p:
        # route each token's mask id through the same dispatch
        mid = mask_ids.to(x.dtype)
        mid = mid[:, None].expand(b, s).reshape(n_groups, group)
        slot_mid = torch.einsum("gtec,gt->gec", dispatch, mid)  # [G,E,C]
        # the gather as a one-hot product: the same values (one term a
        # sum), and a backward that is a matrix product, deterministic,
        # where an indexed gather's backward accumulates in any order
        pick = torch.nn.functional.one_hot(
            slot_mid.long(), p["masks"].shape[0]).to(p["masks"].dtype)
        h = h * (pick @ p["masks"])                             # [G,E,C,F]
    ye = torch.einsum("gecf,efd->gecd", h, p["wed"])            # [G,E,C,D]
    ye = layers.constrain(ye, ep) if ep else ye
    y = torch.einsum("gtec,gecd->gtd", combine.to(x.dtype), ye)

    # ---- aux load-balancing loss -------------------------------------------
    f_e = (onehot[..., 0, :] if k == 1 else onehot.sum(2)).mean(1)
    p_e = probs.mean(1)
    aux = (f_e * p_e).sum(-1).mean() * e

    y = y.reshape(b, s, d)
    if "dense" in p:                # arctic's parallel dense residual
        y = y + layers.ffn_apply(p["dense"], x, cfg, mask_ids=mask_ids)
    return y, aux
