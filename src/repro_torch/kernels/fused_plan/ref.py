"""Fused whole-plan executor: spec IR + the plain PyTorch versions.

This module owns the contract between ``core/plan.lower_fused`` and the CUDA
kernels of ``csrc/fused_plan.cu``: a :class:`FusedSpec` is a flat, hashable
chain of dense/elementwise steps over a running hidden state, with every
weight either sample-shared or per-sample-row (``n_rows = groups × n_masks``
packed weight sets). :func:`fused_plan_ref` and :func:`fused_moments_ref`
run the chain with plain tensor products — the same contraction order as the
per-op ``plan.execute`` path. The wrappers in ``ops.py`` take them for CPU
tensors; ``chip_smoke.py`` holds the kernels to them on the card.

Params travel as a flat tuple ordered by :func:`param_slots`: for each dense
step, ``w``, then its scale ``ws`` when the weight is int8, then (if present)
shared bias ``b`` and per-sample bias ``bp``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.nn.functional as F

__all__ = ["FusedStep", "FusedSpec", "FusedPlanUnsupported", "ACTIVATIONS",
           "act_fn", "split_prefix", "param_slots", "fused_plan_ref",
           "fused_moments_ref", "REL_UNC_EPS", "FusedDecodeSpec",
           "check_prefill_paddable", "decode_param_slots", "norm_fn",
           "rope_rotate", "welford_posterior", "decode_attn_ref",
           "decode_ffn_ref", "fused_decode_ref"]


class FusedPlanUnsupported(NotImplementedError):
    """Raised when a PackedPlan cannot run through the fused executor
    (unknown op kind, or a per-row footprint the kernel cannot hold in
    shared memory). Callers fall back to the per-op ``plan.execute``."""


#: The one activation-name table of the port (core/plan resolves its op
#: activations here too). GELU is the tanh form: ``jax.nn.gelu``'s default,
#: and the form the CUDA kernels compute.
ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "relu": torch.relu, "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu, "sigmoid": torch.sigmoid, "tanh": torch.tanh,
    "identity": lambda x: x,
}


def act_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """Resolve an activation name ('gelu_mlp' is the plain-MLP gelu)."""
    return ACTIVATIONS["gelu" if name == "gelu_mlp" else name]


@dataclasses.dataclass(frozen=True)
class FusedStep:
    """One step of the fused chain.

    kind='dense': ``h @ w (+ b) (+ bp[n]) -> activation`` with ``w`` indexed
    by the sample row when ``per_sample`` (``[n_rows, d_in, d_out]``) and
    shared (``[d_in, d_out]``) otherwise. kind='act': bare elementwise
    nonlinearity (no params; only emitted when it cannot fuse into the
    preceding dense). ``w_dtype`` tags the weight's storage: "" (native
    fp32) or "int8", which carries a per-output-channel bf16 scale ``ws``
    (``w.shape[:-2] + (1, d_out)``) dequantized next to the product, with
    bf16 biases.

    The serving-decode kinds (:class:`FusedDecodeSpec` chains):

    kind='norm': rms/layer norm (``norm`` selects which; params ``scale``
    [+ ``bias`` iff ``shared_bias``]) of the residual stream.

    kind='attn': one attention sub-layer — q/k/v projections (+ bias iff
    ``qkv_bias``), RoPE over the leading ``rot_dim`` lanes of each head,
    attention over the row's cache with the fresh k/v appended (the slot
    the per-op path would overwrite is masked out), output projection.
    params ``wq [,bq], wk [,bk], wv [,bv], wo``.

    kind='ffn': the (optionally ``gated``, optionally Bayesian) FFN.
    Masked form (``masked``): params ``[wg,] wu [,bu], wd [,bd], mask`` with
    ``mask`` the pre-gathered per-row mask matrix ``[R, d_hidden]``; packed
    per-sample form (``per_sample``): ``[wgp,] wup, wdp`` shaped
    ``[N, d, K]`` / ``[N, K, d]``, row ``r`` using sample ``r // (R/N)``.
    """
    kind: str                # 'dense' | 'act' | 'norm' | 'attn' | 'ffn'
    activation: str | None = None
    per_sample: bool = False
    shared_bias: bool = False
    sample_bias: bool = False
    d_in: int = 0
    d_out: int = 0
    # --- decode-chain fields (defaults keep feed-forward specs unchanged) --
    norm: str = "rmsnorm"           # kind='norm': 'rmsnorm' | 'layernorm'
    n_heads: int = 0                # kind='attn'
    n_kv_heads: int = 0
    head_dim: int = 0
    rot_dim: int = 0                # rotated lanes per head (partial RoPE)
    window: int = 0                 # local attention window (0 = global)
    qkv_bias: bool = False
    gated: bool = False             # kind='ffn': gated (SwiGLU/GeGLU) form
    masked: bool = False            # kind='ffn': mask-matrix multiply form
    ffn_bias: bool = False          # kind='ffn': plain-MLP biases on wu/wd
    d_hidden: int = 0               # kind='ffn': hidden width (F or keep K)
    w_dtype: str = ""


@dataclasses.dataclass(frozen=True)
class FusedSpec:
    """Static description of a whole-plan fused execution (hashable — the
    cache key of the kernel's step layout in ``ops.py``)."""
    steps: tuple[FusedStep, ...]
    n_rows: int                     # kernel sample axis (groups × n_masks)
    n_masks: int
    groups: int
    d_in: int                       # chain input width
    d_out: int                      # final per-row output width

    def __post_init__(self) -> None:
        if self.n_rows != self.groups * self.n_masks:
            raise ValueError(f"n_rows {self.n_rows} != groups*n_masks")
        if not any(s.kind == "dense" for s in self.steps):
            raise FusedPlanUnsupported("fused chain has no dense step")
        for s in self.steps:
            if s.kind not in ("dense", "act"):
                raise FusedPlanUnsupported(f"step kind {s.kind!r}")
            if s.w_dtype not in ("", "int8"):
                raise ValueError(f"unknown weight dtype {s.w_dtype!r}")

    @property
    def weight_elements(self) -> int:
        """Total weight+bias elements of the chain."""
        tot = 0
        for s in self.steps:
            if s.kind != "dense":
                continue
            rows = self.n_rows if s.per_sample else 1
            tot += rows * s.d_in * s.d_out
            if s.shared_bias:
                tot += s.d_out
            if s.sample_bias:
                tot += self.n_rows * s.d_out
        return tot


def split_prefix(spec: FusedSpec) -> int:
    """Index of the first step that depends on the sample row: steps before
    it are the shared prefix, which the moments kernel runs once per batch
    tile instead of once per row."""
    for i, st in enumerate(spec.steps):
        if st.per_sample or st.sample_bias:
            return i
    return len(spec.steps)


def param_slots(spec: FusedSpec) -> tuple[tuple[int, str], ...]:
    """Flat param ordering: (step index, 'w'|'ws'|'b'|'bp') per array;
    'ws' follows 'w' iff the step's weight is quantized (``w_dtype``)."""
    slots: list[tuple[int, str]] = []
    for i, st in enumerate(spec.steps):
        if st.kind != "dense":
            continue
        slots.append((i, "w"))
        if st.w_dtype:
            slots.append((i, "ws"))
        if st.shared_bias:
            slots.append((i, "b"))
        if st.sample_bias:
            slots.append((i, "bp"))
    return tuple(slots)


def _slot_table(spec: FusedSpec, params: tuple[torch.Tensor, ...]
                ) -> dict[tuple[int, str], torch.Tensor]:
    slots = param_slots(spec)
    if len(slots) != len(params):
        raise ValueError(f"fused spec expects {len(slots)} params, "
                         f"got {len(params)}")
    return dict(zip(slots, params))


def fused_plan_ref(spec: FusedSpec, x: torch.Tensor,
                   params: tuple[torch.Tensor, ...]) -> torch.Tensor:
    """Plain version: x [B, d_in] -> per-row samples [n_rows, B, d_out].

    Shared prefix steps run once on [B, d]; the first per-sample step
    introduces the row axis and the rest of the chain is sample-major
    batched products (the batch-level contraction order). An int8 weight
    is dequantized next to its product, ``float(q) * float(ws)``, and bf16
    biases widen at the add.
    """
    table = _slot_table(spec, params)
    h = x
    for i, st in enumerate(spec.steps):
        if st.kind == "act":
            h = act_fn(st.activation)(h)
            continue
        w = table[(i, "w")]
        if st.w_dtype:
            w = w.float() * table[(i, "ws")].float()
        if st.per_sample:
            y = torch.matmul(h, w)      # [B,d]|[N,B,d] x [N,d,k] -> [N,B,k]
        else:
            y = h @ w
        if st.shared_bias:
            y = y + table[(i, "b")]
        if st.sample_bias:
            bp = table[(i, "bp")]
            if y.ndim == 2:             # per-sample bias on a shared value
                y = y[None] + bp[:, None, :]
            else:
                y = y + bp[:, None, :]
        if st.activation:
            y = act_fn(st.activation)(y)
        h = y
    if h.ndim == 2:                     # fully shared chain: rows identical
        h = h[None].expand((spec.n_rows,) + tuple(h.shape))
    return h


def fused_moments_ref(spec: FusedSpec, x: torch.Tensor,
                      params: tuple[torch.Tensor, ...]
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the in-kernel moments epilogue: x [B, d_in] ->
    (mean [B, groups·d_out], std [B, groups·d_out]); the reduction is over
    the ``n_masks`` rows *within* each group (ddof=0), matching
    ``uncertainty.predictive_moments`` of the group-unflattened samples."""
    s = fused_plan_ref(spec, x, params)          # [G·N, B, do]
    g, n = spec.groups, spec.n_masks
    b, do = s.shape[1], s.shape[2]
    sg = s.reshape(g, n, b, do)
    mean = sg.mean(dim=1).movedim(0, 1).reshape(b, g * do)
    std = sg.std(dim=1, correction=0).movedim(0, 1).reshape(b, g * do)
    return mean, std


# ---------------------------------------------------------------------------
# fused serving-decode chain (FusedDecodeSpec)
# ---------------------------------------------------------------------------

#: Same value as core/uncertainty.REL_UNC_EPS (kept here so the kernel tier
#: imports nothing of the compiler or metrics modules).
REL_UNC_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class FusedDecodeSpec:
    """Static description of one fused serving decode step (hashable).

    ``steps`` is the unrolled per-layer chain
    ``(norm, attn, norm, ffn) × L + (norm, dense-lm-head)``; each 'attn'
    step owns one cache entry (in step order). Rows are mask-major: row
    ``r`` of the pool is mask-sample ``r // b`` of request column ``r % b``
    with ``b = rows / n_samples``; the posterior epilogue reduces the
    log-prob rows of each column over its ``n_samples`` group with a
    running Welford (mean, M2) and returns ``(mean_logp [b, V],
    rel_unc [b])``.
    """
    steps: tuple[FusedStep, ...]
    n_samples: int                  # posterior sample count (1 = degenerate)
    d_model: int
    vocab: int
    kv_dtype: str = ""              # cache storage dtype tag ("" = model's)

    def __post_init__(self) -> None:
        if self.n_samples < 1:
            raise ValueError(f"n_samples {self.n_samples} < 1")
        if not any(s.kind == "attn" for s in self.steps):
            raise FusedPlanUnsupported("fused decode chain has no attention")

    @property
    def n_attn(self) -> int:
        """Cache entries consumed (one per 'attn' step, in step order)."""
        return sum(s.kind == "attn" for s in self.steps)


def check_prefill_paddable(spec: FusedDecodeSpec) -> FusedDecodeSpec:
    """Gate for the bucketed (zero-padded length-bucket) prefill: raise
    :class:`FusedPlanUnsupported` unless padding a prompt to a bucket is
    exact for this chain. A local-attention step's rolling cache (slot =
    pos % window) lets pad-tail writes overwrite real trailing positions,
    which no trim can undo; global attention keeps slot == position."""
    for st in spec.steps:
        if st.kind == "attn" and st.window:
            raise FusedPlanUnsupported(
                "local-attention rolling cache cannot take padded-bucket "
                "prefill (pad positions would evict real context)")
    return spec


def decode_param_slots(spec: FusedDecodeSpec) -> tuple[tuple[int, str], ...]:
    """Flat param ordering of a decode chain: (step index, name) per array."""
    slots: list[tuple[int, str]] = []
    for i, st in enumerate(spec.steps):
        if st.kind == "norm":
            slots.append((i, "scale"))
            if st.shared_bias:
                slots.append((i, "bias"))
        elif st.kind == "attn":
            for w, b in (("wq", "bq"), ("wk", "bk"), ("wv", "bv")):
                slots.append((i, w))
                if st.qkv_bias:
                    slots.append((i, b))
            slots.append((i, "wo"))
        elif st.kind == "ffn":
            if st.per_sample:
                slots += [(i, n) for n in
                          (("wgp",) if st.gated else ()) + ("wup", "wdp")]
            else:
                if st.gated:
                    slots.append((i, "wg"))
                slots.append((i, "wu"))
                if st.ffn_bias:
                    slots.append((i, "bu"))
                slots.append((i, "wd"))
                if st.ffn_bias:
                    slots.append((i, "bd"))
                if st.masked:
                    slots.append((i, "mask"))
        elif st.kind == "dense":
            slots.append((i, "w"))
            if st.shared_bias:
                slots.append((i, "b"))
        elif st.kind != "act":
            raise FusedPlanUnsupported(f"step kind {st.kind!r} in decode "
                                       f"chain")
    return tuple(slots)


def decode_step_params(spec: FusedDecodeSpec,
                       params: tuple[torch.Tensor, ...]
                       ) -> list[dict[str, torch.Tensor]]:
    """The flat params regrouped per step: ``[{name: tensor}]``, one dict
    per step of ``spec.steps``."""
    slots = decode_param_slots(spec)
    if len(slots) != len(params):
        raise ValueError(f"decode spec expects {len(slots)} params, "
                         f"got {len(params)}")
    per: list[dict[str, torch.Tensor]] = [{} for _ in spec.steps]
    for (i, name), arr in zip(slots, params):
        per[i][name] = arr
    return per


def norm_fn(h: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor | None,
            kind: str, eps: float = 1e-6) -> torch.Tensor:
    """fp32 rms/layer norm — the same math as models/layers.norm_apply."""
    hf = h.float()
    if kind == "rmsnorm":
        y = hf * torch.rsqrt((hf * hf).mean(-1, keepdim=True) + eps)
    else:
        mu = hf.mean(-1, keepdim=True)
        var = hf.var(-1, keepdim=True, correction=0)
        y = (hf - mu) * torch.rsqrt(var + eps)
    y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y


def rope_rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                rot: int) -> torch.Tensor:
    """Split-half RoPE on one head: x [R, dh], cos/sin [R, rot/2]."""
    if rot == 0:
        return x
    half = rot // 2
    x1, x2, xp = x[:, :half], x[:, half:rot], x[:, rot:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return torch.cat([out, xp], -1) if rot < x.shape[-1] else out


def welford_posterior(logp: torch.Tensor, n: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Posterior of one decode step via running Welford over the mask axis:
    logp [n·b, V] (mask-major rows) -> (mean_logp [b, V], rel_unc [b])."""
    b = logp.shape[0] // n
    mean = logp[:b]
    m2 = torch.zeros_like(mean)
    for k in range(1, n):
        y = logp[k * b:(k + 1) * b]
        delta = y - mean
        mean = mean + delta / (k + 1)
        m2 = m2 + delta * (y - mean)
    std = torch.sqrt(m2 / n)
    tok = mean.argmax(-1, keepdim=True)
    std_t = std.gather(-1, tok)[:, 0]
    mean_t = mean.gather(-1, tok)[:, 0]
    return mean, std_t / mean_t.abs().clamp_min(REL_UNC_EPS)


def decode_attn_ref(st: FusedStep, h: torch.Tensor,
                    p: dict[str, torch.Tensor], cache, pos: torch.Tensor,
                    cos: torch.Tensor, sin: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One 'attn' step: h [R, d] fp32 -> (sub-layer output [R, d],
    k_new [R, hkv, dh], v_new [R, hkv, dh]), all fp32.

    The fresh k/v are appended as an extra key slot and the cache slot the
    per-op ``kv_cache_update`` would overwrite (``slot = (pos % window) %
    smax``) is masked out, so the attended set is exactly the per-op path's
    post-update cache. Weights and cache reads are upcast to fp32."""
    hh, hkv, dh, rot = st.n_heads, st.n_kv_heads, st.head_dim, st.rot_dim
    q = h @ p["wq"].float()
    k = h @ p["wk"].float()
    v = h @ p["wv"].float()
    if st.qkv_bias:
        q = q + p["bq"].float()
        k = k + p["bk"].float()
        v = v + p["bv"].float()
    kc, vc, kpos = cache
    smax = kc.shape[2]
    slot = ((pos % st.window) if st.window else pos) % smax        # [R]
    valid = (kpos >= 0) & (kpos <= pos[:, None]) \
        & (torch.arange(smax, device=h.device)[None, :] != slot[:, None])
    scale = 1.0 / math.sqrt(dh)
    k_heads = [rope_rotate(k[:, j * dh:(j + 1) * dh], cos, sin, rot)
               for j in range(hkv)]
    outs = []
    for i in range(hh):
        j = i // (hh // hkv)
        qi = rope_rotate(q[:, i * dh:(i + 1) * dh], cos, sin, rot)
        s_old = (qi[:, None, :] * kc[:, j].float()).sum(-1) * scale
        s_new = (qi * k_heads[j]).sum(-1) * scale
        s_all = torch.cat([torch.where(valid, s_old, -1e30),
                           s_new[:, None]], -1)                    # [R, S+1]
        pr = torch.softmax(s_all, -1)
        oi = (pr[:, :smax, None] * vc[:, j].float()).sum(1) \
            + pr[:, smax:] * v[:, j * dh:(j + 1) * dh]
        outs.append(oi)
    y = torch.cat(outs, -1) @ p["wo"].float()
    k_new = torch.stack(k_heads, 1)                                # [R,hkv,dh]
    v_new = torch.stack([v[:, j * dh:(j + 1) * dh] for j in range(hkv)], 1)
    return y, k_new, v_new


def decode_ffn_ref(st: FusedStep, h: torch.Tensor,
                   p: dict[str, torch.Tensor]) -> torch.Tensor:
    """One 'ffn' step: h [R, d] -> sub-layer output [R, d] (pre-residual)."""
    act = act_fn(st.activation)
    if st.per_sample:                   # packed per-sample serving weights
        n = p["wup"].shape[0]
        b = h.shape[0] // n
        outs = []
        for m in range(n):
            hm = h[m * b:(m + 1) * b]
            if st.gated:
                mid = act(hm @ p["wgp"][m].float()) * (hm @ p["wup"][m].float())
            else:
                mid = act(hm @ p["wup"][m].float())
            outs.append(mid @ p["wdp"][m].float())
        return torch.cat(outs, 0)
    up = h @ p["wu"].float()
    if st.ffn_bias:
        up = up + p["bu"].float()
    mid = act(h @ p["wg"].float()) * up if st.gated else act(up)
    if st.masked:
        mid = mid * p["mask"].float()
    y = mid @ p["wd"].float()
    if st.ffn_bias:
        y = y + p["bd"].float()
    return y


def fused_decode_ref(spec: FusedDecodeSpec, x: torch.Tensor,
                     params: tuple[torch.Tensor, ...],
                     caches: tuple[torch.Tensor, ...],
                     pos: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Plain version of the fused decode step.

    x [R, d_model] (embedded tokens), params per ``decode_param_slots``
    order, caches the flattened ``(k [R,hkv,S,dh], v, kpos [R,S])`` triples
    (one per 'attn' step, in step order), pos [R] (per-row decode
    positions, -1 = inactive row), cos/sin [R, rot/2] ->
    ``(mean_logp [b, V], rel_unc [b], k_new, v_new)`` with k_new/v_new
    ``[n_attn, R, hkv, dh]`` in x's dtype (the caller commits them to the
    cache). All compute in fp32.
    """
    per = decode_step_params(spec, params)
    resid = x.float()
    h = resid
    knews, vnews = [], []
    for st, p in zip(spec.steps, per):
        if st.kind == "norm":
            h = norm_fn(resid, p["scale"], p.get("bias"), st.norm)
        elif st.kind == "attn":
            ai = len(knews)
            y, kn, vn = decode_attn_ref(st, h, p, caches[3 * ai: 3 * ai + 3],
                                        pos, cos, sin)
            resid = resid + y
            h = resid
            knews.append(kn)
            vnews.append(vn)
        elif st.kind == "ffn":
            resid = resid + decode_ffn_ref(st, h, p)
            h = resid
        elif st.kind == "dense":
            h = h @ p["w"].float()
            if st.shared_bias:
                h = h + p["b"].float()
            if st.activation:
                h = act_fn(st.activation)(h)
        elif st.kind == "act":
            h = act_fn(st.activation)(h)
        else:
            raise FusedPlanUnsupported(f"step {st!r} in decode chain")
    logp = torch.log_softmax(h.float(), -1)
    mean, rel = welford_posterior(logp, spec.n_samples)
    return (mean, rel, torch.stack(knews).to(x.dtype),
            torch.stack(vnews).to(x.dtype))
