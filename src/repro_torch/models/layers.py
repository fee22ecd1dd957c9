"""Functional layers of the transformer stacks (the port's twin of
``repro.models.layers``: norms, RoPE and M-RoPE, attention, FFN,
embeddings).

Parameters are plain nested dicts of tensors, as in the reference, with the
same leaf names (wq/wk/wv/wo, wg/wu/wd, embed/unembed, masks), so a
reference checkpoint maps onto them one to one
(``transformer.params_from_jax``). Products between a narrow and a wide
dtype promote to the wide one first, as JAX does. The reference's sharding
hints (``constrain``/``axis_size``) have no counterpart here.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch
from torch.utils import checkpoint as ckpt

from repro_torch.core import masks as masks_lib
from repro_torch.core import plan as plan_lib
from repro_torch.distributed import compression, sharding
from repro_torch.launch import mesh as mesh_lib

Params = dict[str, Any]

__all__ = ["resolve_spec", "constrain", "local_pointwise", "gather_dim",
           "axis_size", "dense_init", "dense", "norm_init", "norm_apply",
           "rope_cos_sin", "mrope_cos_sin", "apply_rope", "attn_init", "attention_full", "attention_chunked",
           "attention_banded", "attention_decode", "kv_store_dtype",
           "quantize_kv", "kv_cache_shapes", "init_kv_cache",
           "kv_cache_update", "ffn_init", "ffn_apply", "mask_table",
           "embed_init", "embed_tokens", "lm_head"]


# ---------------------------------------------------------------------------
# activation sharding hints
# ---------------------------------------------------------------------------


def resolve_spec(spec: tuple, shape: tuple, mesh_shape: dict) -> tuple:
    """A hint's spec against a mesh's ``{name: size}``: "batch" -> ("pod",
    "data") as available (one name alone), a mesh dim name kept, None
    kept; an entry whose axes are absent or do not divide the dim becomes
    None (the reference's resolution, ``constrain``)."""
    resolved: list = []
    for i, a in enumerate(spec):
        if a == "batch":
            ba = tuple(ax for ax in ("pod", "data") if ax in mesh_shape)
            tot = 1
            for ax in ba:
                tot *= mesh_shape[ax]
            resolved.append((ba if len(ba) > 1 else ba[0])
                            if ba and shape[i] % tot == 0 else None)
        elif a in mesh_shape and shape[i] % mesh_shape[a] == 0:
            resolved.append(a)
        else:
            resolved.append(None)
    return tuple(resolved)


def constrain(x: torch.Tensor, spec: tuple) -> torch.Tensor:
    """``x`` laid out as ``spec`` says (:func:`resolve_spec` against the
    ambient mesh): a DTensor is redistributed (differentiably); a plain
    tensor, no ambient mesh, or a spec that resolves to no axis at all
    leave ``x`` as it is — the reference with no mesh."""
    from torch.distributed.tensor import DTensor
    mesh = mesh_lib.get_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    resolved = resolve_spec(spec, tuple(x.shape), mesh_lib.mesh_shape(mesh))
    if all(r is None for r in resolved):
        return x
    return x.redistribute(x.device_mesh,
                          sharding.to_placements(resolved, x.device_mesh))


def local_pointwise(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn(x)`` for an elementwise ``fn``; on a DTensor, ``fn`` runs on
    each rank's local shard (a partial sum reduced first), for the
    elementwise ops DTensor has no sharding rule for (``log_sigmoid``'s
    backward)."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        return fn(x)
    from torch.distributed.tensor.experimental import local_map
    pl = tuple(Replicate() if d.is_partial() else d for d in x.placements)
    x = x.redistribute(x.device_mesh, pl)
    return local_map(fn, out_placements=(pl,), in_placements=(pl,),
                     device_mesh=x.device_mesh)(x)


def gather_dim(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` with ``dim`` whole on every rank: a DTensor sharded over
    ``dim`` is gathered along it (DTensor cannot slice a sharded dim);
    anything else as it is."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor) or not any(
            d.is_shard(dim) for d in x.placements):
        return x
    return x.redistribute(x.device_mesh, tuple(
        Replicate() if d.is_shard(dim) else d for d in x.placements))


def axis_size(name: str) -> int:
    """Size of a dim of the ambient mesh (1 if absent, or no mesh)."""
    mesh = mesh_lib.get_mesh()
    return 1 if mesh is None else mesh_lib.mesh_shape(mesh).get(name, 1)


def _randn(gen: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    """Normal draws times ``scale`` in ``dtype``; scaled in place, so one
    fp32 draw is alive at a time (arctic's expert stack is 17.8 GB in
    fp32)."""
    return torch.randn(shape, generator=gen, device=gen.device).mul_(
        scale).to(dtype)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with JAX's type promotion (bf16 @ f32 -> f32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dt), b.to(dt))


# ---------------------------------------------------------------------------
# initializers / norms
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               bias: bool = False, scale: float | None = None) -> Params:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    p = {"w": _randn(gen, (d_in, d_out), scale, dtype)}
    if bias:
        p["b"] = torch.zeros(d_out, dtype=dtype, device=gen.device)
    return p


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = _mm(x, p["w"])
    if "b" in p:
        y = y + p["b"]
    return y


def norm_init(width: int, kind: str, dtype, device) -> Params:
    p = {"scale": torch.ones(width, dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros(width, dtype=dtype, device=device)
    return p


def norm_apply(p: Params, x: torch.Tensor, kind: str, eps: float = 1e-6
               ) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    else:
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, correction=0)
        y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].float()
    if "bias" in p:
        y = y + p["bias"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------


def rope_cos_sin(positions: torch.Tensor, rot_dim: int, theta: float
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """positions [...] -> cos/sin [..., rot_dim/2] (fp32)."""
    half = rot_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions[..., None].float() * freqs
    return torch.cos(ang), torch.sin(ang)


def mrope_cos_sin(positions: torch.Tensor, rot_dim: int, theta: float,
                  sections: tuple[int, ...]
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Qwen2-VL M-RoPE. positions [3, ...] (temporal/height/width streams);
    sections partition the rot_dim/2 frequency slots among the streams."""
    if sum(sections) != rot_dim // 2:
        raise ValueError(
            f"mrope sections {sections} must sum to rot_dim/2 = "
            f"{rot_dim // 2} — each frequency slot belongs to exactly "
            "one position stream")
    cos, sin = rope_cos_sin(positions, rot_dim, theta)  # [3, ..., half]
    parts_c, parts_s = [], []
    off = 0
    for i, sec in enumerate(sections):
        parts_c.append(cos[i, ..., off:off + sec])
        parts_s.append(sin[i, ..., off:off + sec])
        off += sec
    return torch.cat(parts_c, -1), torch.cat(parts_s, -1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               rope_pct: float = 1.0) -> torch.Tensor:
    """x [..., S, dh] with cos/sin [..., S, rot/2]; split-half convention.
    rope_pct < 1 rotates only the leading fraction (partial rotary)."""
    dh = x.shape[-1]
    rot = int(dh * rope_pct)
    rot -= rot % 2
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., :rot // 2], xr[..., rot // 2:]
    cos = cos[..., :rot // 2].to(x.dtype)
    sin = sin[..., :rot // 2].to(x.dtype)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return torch.cat([out, xp], -1) if rot < dh else out


# ---------------------------------------------------------------------------
# attention (GQA)
# ---------------------------------------------------------------------------


def attn_init(gen: torch.Generator, cfg, dtype) -> Params:
    d, dh = cfg.d_model, cfg.resolved_head_dim
    h, hkv = cfg.n_heads, cfg.n_kv_heads
    return {
        "wq": dense_init(gen, d, h * dh, dtype, bias=cfg.qkv_bias),
        "wk": dense_init(gen, d, hkv * dh, dtype, bias=cfg.qkv_bias),
        "wv": dense_init(gen, d, hkv * dh, dtype, bias=cfg.qkv_bias),
        "wo": dense_init(gen, h * dh, d, dtype,
                         scale=1.0 / math.sqrt(h * dh)),
    }


def split_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n, -1).transpose(1, 2)          # [B, n, S, dh]


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, dh = x.shape
    return x.transpose(1, 2).reshape(b, s, h * dh)


def _grouped_scores(q: torch.Tensor, k: torch.Tensor,
                    scores_f32: bool = True) -> torch.Tensor:
    """q [B,H,Sq,dh], k [B,Hkv,Sk,dh] -> scores [B,Hkv,G,Sq,Sk] in fp32
    (or q's dtype with ``scores_f32=False``), without repeating k."""
    b, h, sq, dh = q.shape
    hkv = k.shape[1]
    qg = q.reshape(b, hkv, h // hkv, sq, dh)
    out = torch.einsum("bkgqd,bksd->bkgqs", qg.float(), k.float())
    return out if scores_f32 else out.to(q.dtype)


def _grouped_combine(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """p [B,Hkv,G,Sq,Sk] x v [B,Hkv,Sk,dh] -> [B,H,Sq,dh] in v's dtype."""
    b, hkv, g, sq, _ = p.shape
    out = torch.einsum("bkgqs,bksd->bkgqd", p.to(v.dtype), v)
    return out.reshape(b, hkv * g, sq, -1)


def attention_full(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool, q_offset: int = 0, window: int = 0,
                   scores_f32: bool = True) -> torch.Tensor:
    """Materializes [Sq, Sk] scores: the prefill path at small shapes."""
    dh = q.shape[-1]
    s = _grouped_scores(q, k, scores_f32) / math.sqrt(dh)
    sq, sk = s.shape[-2], s.shape[-1]
    dev = q.device
    qpos = q_offset + torch.arange(sq, device=dev)[:, None]
    kpos = torch.arange(sk, device=dev)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=dev)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    s = torch.where(mask, s.float(), -1e30)
    return _grouped_combine(torch.softmax(s, -1), v)


def _chunk_body(fn, *tensors: torch.Tensor):
    """A chunk of a chunked attention: checkpointed when autograd records
    (the reference's ``jax.checkpoint`` of the chunk body — otherwise every
    chunk's fp32 scores stay alive for the backward, O(S^2) again);
    called directly otherwise."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return ckpt.checkpoint(fn, *tensors, use_reentrant=False)
    return fn(*tensors)


def attention_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, chunk: int = 1024,
                      scores_f32: bool = True) -> torch.Tensor:
    """Long prefill and training: a loop over query chunks, each with the
    exact softmax over the full key axis — peak memory O(chunk x S)
    instead of O(S^2); in training each chunk is recomputed in the
    backward."""
    sq = q.shape[2]
    if sq % chunk:
        return attention_full(q, k, v, causal=causal, scores_f32=scores_f32)
    q = gather_dim(q, 2)        # the query chunks are slices of S
    outs = [_chunk_body(lambda qi, kk, vv, i=i: attention_full(
                qi, kk, vv, causal=causal, q_offset=i,
                scores_f32=scores_f32), q[:, :, i:i + chunk], k, v)
            for i in range(0, sq, chunk)]
    return torch.cat(outs, 2)


def attention_banded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     window: int) -> torch.Tensor:
    """Sliding-window attention, linear in S: query chunks of ``window``
    rows, each against a 2-window key band. Exact vs
    ``attention_full(window=window)``."""
    b, h, sq, dh = q.shape
    w = window
    if sq <= w or sq % w:
        return attention_full(q, k, v, causal=True, window=w)
    q, k, v = (gather_dim(t, 2) for t in (q, k, v))   # bands slice S
    pad = (0, 0, w, 0)
    kp = torch.nn.functional.pad(k, pad)
    vp = torch.nn.functional.pad(v, pad)
    dev = q.device
    qpos = torch.arange(w, device=dev)[:, None] + w         # band-local
    kpos = torch.arange(2 * w, device=dev)[None, :]

    def band(qi, kb, vb, start):
        s = _grouped_scores(qi, kb) / math.sqrt(dh)
        valid = (kpos <= qpos) & (kpos > qpos - w) & (kpos + start >= w)
        s = torch.where(valid, s, -1e30)
        return _grouped_combine(torch.softmax(s, -1), vb)

    outs = []
    for i in range(sq // w):
        start = i * w                                       # padded coords
        outs.append(_chunk_body(
            lambda qi, kb, vb, start=start: band(qi, kb, vb, start),
            q[:, :, start:start + w], kp[:, :, start:start + 2 * w],
            vp[:, :, start:start + 2 * w]))
    return torch.cat(outs, 2)


def attention_decode(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kpos: torch.Tensor,
                     pos: torch.Tensor, k_scale: torch.Tensor | None = None,
                     v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """One-token decode: q [B,H,1,dh] vs cache [B,Hkv,Smax,dh]. ``kpos``
    [B,Smax] holds the global position stored in each slot (-1 = empty);
    slots with kpos > pos or kpos < 0 are masked (covers the linear and
    the rolling local-window cache). ``pos`` is a scalar or per-row [B].
    ``k_scale``/``v_scale`` [B,Hkv,Smax] dequantize an int8 cache at the
    gather (the per-vector scales of :func:`quantize_kv`)."""
    dh = q.shape[-1]
    if k_scale is not None:
        k_cache = k_cache.float() * k_scale[..., None]
        v_cache = v_cache.float() * v_scale[..., None]
    s = _grouped_scores(q, k_cache) / math.sqrt(dh)         # [B,Hkv,G,1,S]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=q.device)
    qpos = pos[:, None] if pos.ndim else pos
    valid = (kpos >= 0) & (kpos <= qpos)                     # [B,Smax]
    s = torch.where(valid[:, None, None, None, :], s, -1e30)
    return _grouped_combine(torch.softmax(s, -1), v_cache)


# ---------------------------------------------------------------------------
# KV caches
# ---------------------------------------------------------------------------


def kv_store_dtype(dtype, kv_dtype: str = ""):
    """Cache storage dtype for a ``ModelConfig.kv_dtype`` tag."""
    return {"": dtype, "bfloat16": torch.bfloat16,
            "int8": torch.int8}[kv_dtype]


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(row, head, position) symmetric int8 of K/V [..., S, dh] ->
    (q int8 same shape, scale fp32 [..., S]) — one scale per cached vector,
    the granularity the decode gather dequantizes at. The reference's
    arithmetic step for step (fp32 division, round half to even)."""
    xf = x.float()
    scale = compression.int8_scale(xf.abs().amax(dim=-1))
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def kv_cache_shapes(batch: int, n_kv: int, max_seq: int, dh: int, dtype,
                    kv_dtype: str = "") -> dict[str, tuple]:
    """``{leaf: (shape, dtype)}`` of one KV cache: k/v in the storage dtype,
    kpos int32, and for an int8 cache the fp32 ``kscale``/``vscale``."""
    store = kv_store_dtype(dtype, kv_dtype)
    out = {"k": ((batch, n_kv, max_seq, dh), store),
           "v": ((batch, n_kv, max_seq, dh), store),
           "kpos": ((batch, max_seq), torch.int32)}
    if kv_dtype == "int8":
        out["kscale"] = ((batch, n_kv, max_seq), torch.float32)
        out["vscale"] = ((batch, n_kv, max_seq), torch.float32)
    return out


def init_kv_cache(batch: int, n_kv: int, max_seq: int, dh: int, dtype,
                  kv_dtype: str = "", device=None) -> Params:
    """An empty KV cache: k/v (and scales) zero, kpos -1."""
    return {name: torch.full(shape, -1 if name == "kpos" else 0, dtype=dt,
                             device=device)
            for name, (shape, dt) in kv_cache_shapes(
                batch, n_kv, max_seq, dh, dtype, kv_dtype).items()}


def kv_cache_update(cache: Params, k_new: torch.Tensor, v_new: torch.Tensor,
                    pos: torch.Tensor, window: int = 0) -> Params:
    """Write one step's K/V [B, Hkv, 1, dh] at slot ``pos`` (or ``pos % W``
    rolling). ``pos`` is a scalar (uniform batch) or per-row [B]. The fresh
    k/v are cast to the cache's storage dtype at commit; an int8 cache
    (``kscale``/``vscale`` leaves present) quantizes them per cached vector
    with :func:`quantize_kv` and writes the scales beside them. Functional:
    the cache passed in is left as it was (the caller may still hold
    it)."""
    quant = "kscale" in cache
    if quant:
        k_new, k_sc = quantize_kv(k_new)
        v_new, v_sc = quantize_kv(v_new)
    b, _, smax, _ = cache["k"].shape
    dev = cache["k"].device
    pos = torch.as_tensor(pos, dtype=torch.int64, device=dev)
    if pos.ndim == 0:
        pos = pos.expand(b)
    slot = ((pos % window) if window else pos) % smax
    bidx = torch.arange(b, device=dev)
    k = cache["k"].clone()
    v = cache["v"].clone()
    kpos = cache["kpos"].clone()
    k[bidx, :, slot] = k_new[:, :, 0].to(k.dtype)
    v[bidx, :, slot] = v_new[:, :, 0].to(v.dtype)
    kpos[bidx, slot] = pos.to(torch.int32)
    out = {"k": k, "v": v, "kpos": kpos}
    if quant:
        out["kscale"] = cache["kscale"].clone()
        out["vscale"] = cache["vscale"].clone()
        out["kscale"][bidx, :, slot] = k_sc[:, :, 0]
        out["vscale"][bidx, :, slot] = v_sc[:, :, 0]
    return out


# ---------------------------------------------------------------------------
# FFNs — gated (SwiGLU/GeGLU), plain MLP, and the paper's Masksembles form
# ---------------------------------------------------------------------------


def ffn_init(gen: torch.Generator, cfg, d_ff: int | None = None,
             dtype=None) -> Params:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    dtype = dtype or cfg.dtype
    if cfg.bayesian and cfg.packed_ffn_serving:
        # serving form (mask-zero skipping, paper §V-C): per-sample packed
        # dense weights over the kept hidden units only — [N, d, K]
        n = cfg.mask_samples
        kk = masks_lib.keep_count(f, n, cfg.mask_scale)
        sc = 1.0 / math.sqrt(d)
        if cfg.activation in ("silu", "gelu"):
            return {"wgp": _randn(gen, (n, d, kk), sc, dtype),
                    "wup": _randn(gen, (n, d, kk), sc, dtype),
                    "wdp": _randn(gen, (n, kk, d), 1.0 / math.sqrt(kk),
                                  dtype)}
        return {"wup": _randn(gen, (n, d, kk), sc, dtype),
                "wdp": _randn(gen, (n, kk, d), 1.0 / math.sqrt(kk), dtype)}
    if cfg.activation in ("silu", "gelu"):       # gated
        p = {"wg": dense_init(gen, d, f, dtype),
             "wu": dense_init(gen, d, f, dtype),
             "wd": dense_init(gen, f, d, dtype)}
    else:                                        # plain MLP (gelu_mlp)
        p = {"wu": dense_init(gen, d, f, dtype, bias=True),
             "wd": dense_init(gen, f, d, dtype, bias=True)}
    if cfg.bayesian:
        p["masks"] = mask_table(cfg, f, dtype, gen.device)
    return p


def mask_table(cfg, width: int, dtype, device) -> torch.Tensor:
    """The config's fixed Masksembles masks over ``width`` hidden units,
    [N, width] in ``dtype`` (the reference's ``generate_masks``)."""
    spec = masks_lib.MaskSpec(width=width, n_masks=cfg.mask_samples,
                              scale=cfg.mask_scale, seed=cfg.mask_seed)
    return torch.from_numpy(masks_lib.generate_masks(spec).astype(
        np.float32)).to(device=device, dtype=dtype)


def ffn_apply(p: Params, x: torch.Tensor, cfg,
              mask_ids: torch.Tensor | None = None) -> torch.Tensor:
    """Gated or plain FFN; if the config is Bayesian and mask_ids [B] are
    given, the fixed Masksembles mask multiplies the hidden units. The
    packed serving form runs through ``plan.ffn_leaves_apply`` (rows
    grouped mask-major)."""
    if "wdp" in p:
        return plan_lib.ffn_leaves_apply(p, x, cfg.activation)
    act = plan_lib.activation_fn(cfg.activation)
    if "wg" in p:
        h = act(dense(p["wg"], x)) * dense(p["wu"], x)
    else:
        h = act(dense(p["wu"], x))
    if mask_ids is not None and "masks" in p:
        m = p["masks"][mask_ids]                 # [B, F]
        h = _mul(h, m[:, None, :] if h.ndim == 3 else m)
    return dense(p["wd"], h)


def _mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) * b.to(dt)


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------


def embed_init(gen: torch.Generator, cfg, dtype) -> Params:
    p = {"embed": _randn(gen, (cfg.vocab_size, cfg.d_model), 0.02, dtype)}
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dtype)
    return p


def embed_tokens(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    return p["embed"][tokens]


def lm_head(p: Params, x: torch.Tensor) -> torch.Tensor:
    if "unembed" in p:
        return dense(p["unembed"], x)
    return _mm(x, p["embed"].T)
