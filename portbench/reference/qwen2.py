"""Plain fp32 Qwen2 decoder with Masksembles FFN masks: the reference the
LM cells are judged by.

The block as the Qwen2 report (arXiv:2407.10671, section 2.2) and the
model's config state it: pre-RMSNorm (scale only, eps ``norm_eps``),
grouped-query attention with biases on the q, k and v products, rotary
embeddings over every channel of a head (split-half convention, base
``rope_theta``), causal softmax attention at 1/sqrt(dh), a SwiGLU FFN whose
hidden units are multiplied by the fixed mask of the row, a final RMSNorm
and an untied output head. One request at a time, the masks as its rows,
layer by layer, each layer's bf16 weights widened to fp32 only while that
layer runs. Plain PyTorch; imports nothing of the program.

``quant="fp8"`` is the control: the same pass with every linear layer's
weight (per output column) and input (per row) rounded to float8 e4m3.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

__all__ = ["LAYER_KEYS", "posterior"]

FP8_MAX = 448.0

#: A layer's weights as ``layer(l)`` gives them.
LAYER_KEYS = ("ln1_w", "wq", "bq", "wk", "bk", "wv", "bv", "wo", "ln2_w",
              "wg", "wu", "wd")


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    scale = t.abs().amax(dim, keepdim=True).clamp_min(1e-12) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def _linear(x: torch.Tensor, w: torch.Tensor, quant: str) -> torch.Tensor:
    if quant == "fp8":
        return _fp8(x, -1) @ _fp8(w, 0)
    return x @ w


def _rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x [N, H, L, dh]: rotate every channel, split-half."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = pos.float()[:, None] * freqs                    # [L, half]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


@torch.no_grad()
def posterior(cfg: dict, layer: Callable[[int], dict], embed: torch.Tensor,
              head: dict, masks: torch.Tensor, tokens: torch.Tensor,
              first: int, quant: str = "") -> tuple[torch.Tensor,
                                                     torch.Tensor]:
    """The masks' posterior at positions ``first`` .. L-1 of one sequence.

    ``cfg``: n_layers, n_heads, n_kv_heads, head_dim, rope_theta, norm_eps.
    ``layer(l)`` gives layer l's fp32 weights (:data:`LAYER_KEYS`): ln1_w,
    wq [D, H*dh], bq [H*dh], wk, wv [D, Hkv*dh], bk, bv [Hkv*dh],
    wo [H*dh, D], ln2_w, wg, wu [D, F], wd [F, D]. ``embed`` [V, D];
    ``head``: norm_w, unembed [D, V]; ``masks`` [N, F]; ``tokens`` [L].

    Returns (mean log-probs [L - first, V], std [L - first, V]) over the N
    masks (population std), fp32."""
    n = masks.shape[0]
    h, hkv = cfg["n_heads"], cfg["n_kv_heads"]
    dh = cfg["head_dim"]
    eps, theta = cfg["norm_eps"], cfg["rope_theta"]
    seq = tokens.shape[0]
    pos = torch.arange(seq, device=tokens.device)
    x = embed[tokens.long()].float()[None].repeat(n, 1, 1)   # [N, L, D]
    causal = torch.ones(seq, seq, dtype=torch.bool,
                        device=x.device).tril()
    m = masks.float()[:, None, :]
    for li in range(cfg["n_layers"]):
        p = layer(li)
        xn = _rmsnorm(x, p["ln1_w"], eps)
        q = (_linear(xn, p["wq"], quant) + p["bq"]).view(
            n, seq, h, dh).transpose(1, 2)
        k = (_linear(xn, p["wk"], quant) + p["bk"]).view(
            n, seq, hkv, dh).transpose(1, 2)
        v = (_linear(xn, p["wv"], quant) + p["bv"]).view(
            n, seq, hkv, dh).transpose(1, 2)
        q, k = _rope(q, pos, theta), _rope(k, pos, theta)
        k = k.repeat_interleave(h // hkv, 1)
        v = v.repeat_interleave(h // hkv, 1)
        s = (q @ k.transpose(-1, -2)) / math.sqrt(dh)
        s = s.masked_fill(~causal, float("-inf"))
        o = torch.softmax(s, -1) @ v                          # [N, H, L, dh]
        del s, q, k, v
        x = x + _linear(o.transpose(1, 2).reshape(n, seq, h * dh), p["wo"],
                        quant)
        xn = _rmsnorm(x, p["ln2_w"], eps)
        g = _linear(xn, p["wg"], quant)
        g = g * torch.sigmoid(g) * _linear(xn, p["wu"], quant) * m
        x = x + _linear(g, p["wd"], quant)
        del g, xn, o, p
    xs = _rmsnorm(x[:, first:], head["norm_w"], eps)
    logp = torch.log_softmax(_linear(xs, head["unembed"], quant), -1)
    mean = logp.mean(0)
    std = torch.sqrt(((logp - mean) ** 2).mean(0))
    return mean, std
