"""The transformer stack of the serving path (the port's twin of
``repro.models.transformer``): attention blocks and RecurrentGemma's
recurrent (``rec``) blocks.

Parameters keep the reference's layout: ``params["segments"][si]["b{bi}"]``
with every leaf stacked ``[reps, ...]`` over the segment's repeats, plus
``embed`` and ``final_norm``; caches are ``[reps, batch, ...]`` per block
(k/v/kpos for attention, the fp32 ``h`` and the conv window for ``rec``).
The stack runs as a Python loop over layers (serving needs no scan and no
rematerialisation). MoE and xLSTM blocks, M-RoPE and encoder-only models
are not ported yet and raise ``NotImplementedError`` at init.

The causal prefill attention runs the ``flash_attention`` kernel whenever
the window does not cut the prompt; each ``rec`` block's prefill runs the
``rglru_scan`` kernel (``models/rglru.py``).

Entry points:
  prefill(params, {tokens})               — prompt -> last logits + caches
  decode_step(params, caches, tokens, pos) — one-token serving step

Masksembles rides through every FFN via ``mask_ids``: fixed masks over the
hidden units, assigned per batch row.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.configs.base import ModelConfig
from repro_torch.core import masksembles
from repro_torch.core import plan as plan_lib
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import layers, rglru

Params = dict[str, Any]

#: Block kinds the port builds.
BLOCK_KINDS = frozenset({"attn", "local_attn", "rec"})

__all__ = ["check_supported", "init", "params_from_jax", "init_cache",
           "cache_specs", "cache_scatter_rows", "cache_gather_rows",
           "cache_reset_rows", "cache_trim_positions", "pack_ffn_params",
           "prefill", "decode_step"]


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not build yet."""
    kinds = {k for seg in cfg.segments() for k in seg.pattern}
    if not kinds <= BLOCK_KINDS or cfg.m_rope_sections or not cfg.causal:
        raise NotImplementedError(
            f"{cfg.arch_id}: block kinds {sorted(kinds)}, M-RoPE and "
            f"encoder-only models are not ported yet (MoE and xLSTM blocks "
            f"are the rest of slice 4 of the port); it builds causal "
            f"stacks of {sorted(BLOCK_KINDS)} blocks")


def _stack(trees: list) -> Any:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _block_init(kind: str, cfg: ModelConfig, gen: torch.Generator,
                dtype) -> Params:
    d = cfg.d_model
    mixer = ({"rec": rglru.rec_block_init(gen, cfg, dtype)} if kind == "rec"
             else {"attn": layers.attn_init(gen, cfg, dtype)})
    return {"norm1": layers.norm_init(d, cfg.norm, dtype, gen.device),
            **mixer,
            "norm2": layers.norm_init(d, cfg.norm, dtype, gen.device),
            "ffn": layers.ffn_init(gen, cfg, dtype=dtype)}


@torch.no_grad()
def init(cfg: ModelConfig, generator: torch.Generator,
         device: torch.device | str | None = None) -> Params:
    """Random parameters drawn from ``generator`` (on its device), moved to
    ``device`` (None -> the card). Segment leaves are stacked over repeats."""
    check_supported(cfg)
    dev = device_lib.resolve(device)
    dtype = cfg.dtype
    params: Params = {"segments": []}
    for seg in cfg.segments():
        reps = [{f"b{i}": _block_init(kind, cfg, generator, dtype)
                 for i, kind in enumerate(seg.pattern)}
                for _ in range(seg.reps)]
        params["segments"].append(_stack(reps))
    params["embed"] = layers.embed_init(generator, cfg, dtype)
    params["final_norm"] = layers.norm_init(cfg.d_model, cfg.norm, dtype,
                                            generator.device)
    return _tree(lambda t, _: t.to(dev), params)


def _tree(fn, tree, key: str = ""):
    """Map ``fn(leaf, key)`` over a tree; ``key`` is the leaf's dict key."""
    if isinstance(tree, dict):
        return {k: _tree(fn, v, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree(fn, v, key) for v in tree]
    return fn(tree, key)


def params_from_jax(cfg: ModelConfig, params,
                    device: torch.device | str | None = None) -> Params:
    """The port's parameter tree holding the reference's LM parameters
    (numpy arrays or anything ``np.asarray`` takes — masked or packed FFN
    leaves alike), in ``cfg.dtype`` on ``device`` (None -> the card); the
    RG-LRU's ``lambda`` stays fp32, as in the reference."""
    dev = device_lib.resolve(device)

    def conv(a, key: str) -> torch.Tensor:
        t = torch.tensor(np.asarray(a, np.float32), device=dev)
        return t if key in rglru.FP32_PARAMS else t.to(cfg.dtype)

    return _tree(conv, params)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def _block_cache_shapes(kind: str, cfg: ModelConfig, batch: int,
                        max_seq: int) -> dict[str, tuple]:
    if kind == "rec":
        return rglru.rec_state_specs(batch, cfg, cfg.dtype)
    s = (min(cfg.local_window or max_seq, max_seq)
         if kind == "local_attn" else max_seq)
    return layers.kv_cache_shapes(batch, cfg.n_kv_heads, s,
                                  cfg.resolved_head_dim, cfg.dtype,
                                  cfg.kv_dtype)


def _cache_shapes(cfg: ModelConfig, batch: int, max_seq: int):
    return [{f"b{i}": {name: ((seg.reps,) + shape, dt)
                       for name, (shape, dt) in _block_cache_shapes(
                           kind, cfg, batch, max_seq).items()}
             for i, kind in enumerate(seg.pattern)}
            for seg in cfg.segments()]


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device: torch.device | str | None = None):
    """Empty caches (k/v, int8 scales and recurrent state zero, kpos -1) on
    ``device`` (None -> card)."""
    dev = device_lib.resolve(device)
    return [{b: {name: torch.full(shape, -1 if name == "kpos" else 0,
                                  dtype=dt, device=dev)
                 for name, (shape, dt) in leaves.items()}
             for b, leaves in seg.items()}
            for seg in _cache_shapes(cfg, batch, max_seq)]


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int):
    """``(shape, dtype)`` of every cache leaf, without allocating."""
    return _cache_shapes(cfg, batch, max_seq)


# Every cache leaf — k/v/kpos, the int8 scales and the recurrent h/conv
# alike — is shaped [reps, batch, ...]: batch rides on axis 1. The three
# helpers below are the slot-pool contract of serving/server.py: a pooled
# cache is a cache whose batch axis is the slot-row axis. Functional, like
# the decode steps: the trees passed in are left as they were.

def _rows_on(rows, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(rows, dtype=torch.int64, device=like.device)


def cache_scatter_rows(pool, fresh, rows):
    """Write the rows of a small cache (batch b) into a pooled cache (batch
    B >= b) at batch indices ``rows`` [b] — how the server places a newly
    admitted request's prefill into its slot rows while in-flight rows keep
    decoding."""
    return [{b: {name: t.index_copy(1, _rows_on(rows, t),
                                    fseg[b][name].to(t.dtype))
                 for name, t in c.items()}
             for b, c in pseg.items()}
            for pseg, fseg in zip(pool, fresh)]


def cache_gather_rows(pool, rows):
    """The pooled cache restricted to batch indices ``rows`` [b] — the
    inverse of :func:`cache_scatter_rows` (slot inspection)."""
    return [{b: {name: t.index_select(1, _rows_on(rows, t))
                 for name, t in c.items()}
             for b, c in seg.items()}
            for seg in pool]


def cache_reset_rows(pool, row_mask):
    """Clear the rows where ``row_mask`` [B] is True: k/v, the int8 scales
    and the recurrent state to zero, kpos to -1 (empty) — the init state.
    The server runs this when a slot group is freed, so unoccupied rows
    stay observably empty."""
    out = []
    for seg in pool:
        new = {}
        for b, c in seg.items():
            new[b] = {}
            for name, t in c.items():
                m = torch.as_tensor(row_mask, dtype=torch.bool,
                                    device=t.device)
                m = m.reshape((1, m.shape[0]) + (1,) * (t.ndim - 2))
                new[b][name] = t.masked_fill(m, -1 if name == "kpos" else 0)
        out.append(new)
    return out


def cache_trim_positions(caches, length: int):
    """Invalidate every cache entry at position >= ``length``: kpos to -1,
    K/V and int8 scales to zero — the init state of those slots (the
    bucketed-prefill epilogue; slot == position in every global-attention
    cache). Recurrent state has no positions to trim: it raises."""
    out = []
    for seg in caches:
        new = {}
        for b, c in seg.items():
            if "kpos" not in c:
                raise ValueError(f"cache block {b} holds recurrent state, "
                                 f"which cannot be trimmed by position")
            smax = c["kpos"].shape[-1]
            keep = torch.arange(smax, device=c["kpos"].device) < length
            new[b] = {
                "k": torch.where(keep[:, None], c["k"], 0).to(c["k"].dtype),
                "v": torch.where(keep[:, None], c["v"], 0).to(c["v"].dtype),
                "kpos": torch.where(keep, c["kpos"], -1).to(torch.int32)}
            for name in ("kscale", "vscale"):
                if name in c:           # [reps, B, hkv, smax]: slot is last
                    new[b][name] = torch.where(keep, c[name], 0.0)
        out.append(new)
    return out


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------


def _rope(cfg: ModelConfig, positions: torch.Tensor):
    """positions [S] or [B,S] -> cos/sin broadcastable against [B,H,S,dh]."""
    dh = cfg.resolved_head_dim
    rot = int(dh * cfg.rope_pct)
    rot -= rot % 2
    cos, sin = layers.rope_cos_sin(positions, rot, cfg.rope_theta)
    if cos.ndim == 2:          # [S, half] -> [1, 1, S, half]
        return cos[None, None], sin[None, None]
    return cos[:, None], sin[:, None]     # [B, S, half] -> [B, 1, S, half]


def _attention_sublayer(cfg: ModelConfig, p: Params, x: torch.Tensor, rope,
                        mode: str, kind: str, cache, pos):
    h, hkv = cfg.n_heads, cfg.n_kv_heads
    xn = layers.norm_apply(p["norm1"], x, cfg.norm)
    q = layers.split_heads(layers.dense(p["attn"]["wq"], xn), h)
    k = layers.split_heads(layers.dense(p["attn"]["wk"], xn), hkv)
    v = layers.split_heads(layers.dense(p["attn"]["wv"], xn), hkv)
    cos, sin = rope
    q = layers.apply_rope(q, cos, sin, cfg.rope_pct)
    k = layers.apply_rope(k, cos, sin, cfg.rope_pct)
    window = cfg.local_window if kind == "local_attn" else 0
    if mode == "decode":
        new_cache = layers.kv_cache_update(cache, k, v, pos, window)
        attn = layers.attention_decode(q, new_cache["k"], new_cache["v"],
                                       new_cache["kpos"], pos,
                                       new_cache.get("kscale"),
                                       new_cache.get("vscale"))
    else:
        s = x.shape[1]
        if window and s > window:
            attn = layers.attention_banded(q, k, v, window=window)
        elif cfg.causal and cfg.attn_scores_f32:
            # the flash kernel (plain version on the CPU); for s <= window
            # the window mask is a no-op: qpos - window < 0 <= kpos
            attn = flash_ops.flash_attention(
                q.contiguous(), k.contiguous(), v.contiguous(), causal=True,
                chunk=cfg.attn_chunk)
        elif s > cfg.attn_chunk and cfg.causal:
            attn = layers.attention_chunked(q, k, v, causal=True,
                                            chunk=cfg.attn_chunk,
                                            scores_f32=cfg.attn_scores_f32)
        else:
            attn = layers.attention_full(q, k, v, causal=cfg.causal,
                                         window=window,
                                         scores_f32=cfg.attn_scores_f32)
        # the last min(s, smax) positions land at slot = pos % smax — the
        # decode step's slot formula (smax == window for local attention)
        smax = cache["k"].shape[2]
        if s > smax and (not window or smax < window):
            raise ValueError(f"prompt length {s} exceeds cache capacity "
                             f"{smax}; raise max_seq")
        keep = min(s, smax)
        kept_pos = torch.arange(s - keep, s, dtype=torch.int64,
                                device=x.device)
        slots = kept_pos % smax
        store = layers.kv_store_dtype(k.dtype, cfg.kv_dtype)
        kk, vk = k[:, :, -keep:], v[:, :, -keep:]
        new_cache = {}
        if cfg.kv_dtype == "int8":      # empty slots keep a zero scale
            kk, k_sc = layers.quantize_kv(kk)
            vk, v_sc = layers.quantize_kv(vk)
            for name, sc in (("kscale", k_sc), ("vscale", v_sc)):
                new_cache[name] = torch.zeros_like(cache[name])
                new_cache[name][:, :, slots] = sc
        ks = torch.zeros_like(cache["k"], dtype=store)
        vs = torch.zeros_like(cache["v"], dtype=store)
        ks[:, :, slots] = kk.to(store)
        vs[:, :, slots] = vk.to(store)
        kpos = torch.full((smax,), -1, dtype=torch.int32, device=x.device)
        kpos[slots] = kept_pos.to(torch.int32)
        new_cache.update(k=ks, v=vs,
                         kpos=kpos[None].expand(x.shape[0], smax).clone())
    out = layers.dense(p["attn"]["wo"], layers.merge_heads(attn))
    return x + out, new_cache


def _block_apply(kind: str, cfg: ModelConfig, p: Params, x: torch.Tensor, *,
                 mode: str, rope, mask_ids, cache, pos):
    """x [B,S,D] (prefill) or [B,1,D] (decode) -> (x, new cache)."""
    if kind == "rec":
        xn = layers.norm_apply(p["norm1"], x, cfg.norm)
        if mode == "decode":
            y, new_cache = rglru.rec_block_step(p["rec"], xn[:, 0], cache,
                                                cfg)
            y = y[:, None, :]
        else:
            y, new_cache = rglru.rec_block_apply(p["rec"], xn, cfg)
        x = x + y
    elif kind in ("attn", "local_attn"):
        x, new_cache = _attention_sublayer(cfg, p, x, rope, mode, kind,
                                           cache, pos)
    else:
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")
    xn = layers.norm_apply(p["norm2"], x, cfg.norm)
    return x + layers.ffn_apply(p["ffn"], xn, cfg, mask_ids=mask_ids), \
        new_cache


def _run_stack(cfg: ModelConfig, params: Params, x: torch.Tensor, *,
               mode: str, rope, mask_ids, caches, pos=None):
    """Every layer in order; returns (x, caches stacked [reps, ...])."""
    new_caches = []
    for si, seg in enumerate(cfg.segments()):
        sp, sc = params["segments"][si], caches[si]
        outs = []
        for r in range(seg.reps):
            rc = {}
            for i, kind in enumerate(seg.pattern):
                bp = plan_lib.tree_map(lambda a, r=r: a[r], sp[f"b{i}"])
                bc = {k: t[r] for k, t in sc[f"b{i}"].items()}
                x, rc[f"b{i}"] = _block_apply(kind, cfg, bp, x, mode=mode,
                                              rope=rope, mask_ids=mask_ids,
                                              cache=bc, pos=pos)
            outs.append(rc)
        new_caches.append(_stack(outs))
    return x, new_caches


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


@torch.no_grad()
def pack_ffn_params(cfg: ModelConfig, params: Params) -> Params:
    """Checkpoint conversion: masked-FFN weights -> per-sample packed
    serving weights (mask-zero skipping, paper §V-C), through
    ``core.plan.pack_ffn_leaves``. Use with ``dataclasses.replace(cfg,
    packed_ffn_serving=True)``; exact vs the masked form."""
    new = dict(params)
    new["segments"] = []
    for seg in params["segments"]:
        out = {}
        for name, block in seg.items():
            block = dict(block)
            if "masks" in block["ffn"]:
                # masks are identical across repeats (one seed per config)
                block["ffn"] = plan_lib.pack_ffn_leaves(
                    block["ffn"], block["ffn"]["masks"][0])
            out[name] = block
        new["segments"].append(out)
    return new


def _mask_ids(cfg: ModelConfig, b: int, mask_ids, device):
    if cfg.bayesian and mask_ids is None:
        return masksembles.mask_ids_for_batch(b, cfg.mask_samples,
                                              device=device)
    return mask_ids


@torch.no_grad()
def prefill(cfg: ModelConfig, params: Params, batch: Params,
            max_seq: int | None = None,
            mask_ids: torch.Tensor | None = None,
            last_index: int | None = None):
    """Consume the prompt: batch {tokens [B,S]} -> (logits [B,V] at the last
    position, or at ``last_index`` — the bucketed form — and caches sized
    ``max_seq`` (default: the prompt length))."""
    tokens = batch["tokens"]
    x = layers.embed_tokens(params["embed"], tokens)
    b, s = x.shape[:2]
    mask_ids = _mask_ids(cfg, b, mask_ids, x.device)
    caches = init_cache(cfg, b, max_seq or s, device=x.device)
    rope = _rope(cfg, torch.arange(s, dtype=torch.int32, device=x.device))
    x, new_caches = _run_stack(cfg, params, x, mode="prefill", rope=rope,
                               mask_ids=mask_ids, caches=caches)
    i = s - 1 if last_index is None else int(last_index)
    x = layers.norm_apply(params["final_norm"], x[:, i:i + 1], cfg.norm)
    return layers.lm_head(params["embed"], x)[:, 0], new_caches


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: Params, caches,
                tokens: torch.Tensor, pos, mask_ids=None):
    """One serving step: tokens [B,1] + caches @ pos -> (logits [B,V], new
    caches). ``pos`` is a scalar shared by the batch or a per-row [B]
    vector (every cache row at its own position)."""
    x = layers.embed_tokens(params["embed"], tokens)
    b = x.shape[0]
    mask_ids = _mask_ids(cfg, b, mask_ids, x.device)
    p = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    rope = _rope(cfg, p[None] if p.ndim == 0 else p[:, None])
    x, new_caches = _run_stack(cfg, params, x, mode="decode", rope=rope,
                               mask_ids=mask_ids, caches=caches, pos=p)
    x = layers.norm_apply(params["final_norm"], x, cfg.norm)
    return layers.lm_head(params["embed"], x)[:, 0], new_caches
