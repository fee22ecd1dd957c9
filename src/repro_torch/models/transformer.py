"""The model stack of every registry architecture (the port's twin of
``repro.models.transformer``).

Block kinds:
  attn       — global GQA attention + (masked) FFN      [dense/audio/vlm]
  local_attn — sliding-window attention + FFN           [hybrid]
  moe        — GQA attention + mixture-of-experts FFN   [moe]
  rec        — RG-LRU recurrent block + FFN             [hybrid]
  mlstm      — xLSTM matrix-memory block                [ssm]
  slstm      — xLSTM scalar-memory block                [ssm]

Parameters keep the reference's layout: ``params["segments"][si]["b{bi}"]``
with every leaf stacked ``[reps, ...]`` over the segment's repeats, plus
``embed`` and ``final_norm``; caches are ``[reps, batch, ...]`` per block
(k/v/kpos for attention, the fp32 ``h`` and the conv window for ``rec``,
the fp32 C/n/m and c/n/h/m of the xLSTM blocks). The stack runs as a
Python loop over layers; in training each repeat's body is rematerialised
as ``cfg.remat`` says (``torch.utils.checkpoint``: "full" recomputes the
whole body in the backward, "dots" keeps the matrix products' outputs and
recomputes the rest, "none" keeps everything). Remat moves memory, never
numbers.
Positions are one stream, or M-RoPE's three (temporal, height, width:
qwen2-vl); audio and vision prompts arrive as ``embeds`` from a stubbed
frontend.

Prefill attention runs the ``flash_attention`` kernel — causal whenever
the window does not cut the prompt, and the full (non-causal) attention of
the encoder-only stack; each ``rec`` block's prefill runs the
``rglru_scan`` kernel (``models/rglru.py``). MoE and xLSTM blocks reach no
kernel of their own (``models/moe.py``, ``models/xlstm.py``). Training
takes the reference's training graph: its attention branches (banded,
chunked, full; the flash kernel has no backward) and the ``rglru_scan``
kernel forward and backward through its autograd Function.

Entry points:
  forward(params, {tokens|embeds})        — logits at every position
                                            (inference; the encoder's only
                                            entry point)
  forward_train(params, {tokens|embeds})  — the same with gradients (the
                                            loss's forward)
  prefill(params, {tokens|embeds})        — prompt -> last logits + caches
  decode_step(params, caches, tokens, pos) — one-token serving step

Masksembles rides through every FFN via ``mask_ids``: fixed masks over the
hidden units, assigned per batch row.

Sharded serving: ``prefill`` and ``decode_step`` take parameters laid out
as DTensors (``distributed.sharding.param_shardings``) and caches laid
out by ``cache_shardings``; the prompt's tokens are laid out by
``batch_shardings`` on the parameters' mesh, the plain tensors the math
makes join as replicated values, and every new cache leaf takes the layout
of the cache leaf it replaces, so a pool keeps its layout across steps (the
reference's ``out_shardings=(None, cache_sh)``). The slot-pool helpers
below keep it too.
"""

from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch
from torch.utils import checkpoint as ckpt

from repro_torch import device as device_lib
from repro_torch.configs.base import ModelConfig
from repro_torch.core import masksembles
from repro_torch.core import plan as plan_lib
from repro_torch.distributed import sharding
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import layers, rglru, xlstm
from repro_torch.models import moe as moe_lib

Params = dict[str, Any]

__all__ = ["init", "params_from_jax", "train_state_from_jax", "params_mesh",
           "init_cache", "cache_specs", "cache_scatter_rows",
           "cache_gather_rows", "cache_reset_rows", "cache_trim_positions",
           "pack_ffn_params",
           "forward", "forward_train", "prefill", "decode_step"]


def _stack(trees: list) -> Any:
    """Stack leaves over repeats; one repeat is a view (no copy: a 1-layer
    arctic-480b holds 27 GB of experts)."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return trees[0][None] if len(trees) == 1 else torch.stack(trees)


def _init_stacked(reps: int, make) -> Any:
    """``reps`` draws of ``make()`` stacked over a leading dim: each repeat
    is drawn and written into buffers allocated once, then dropped, so the
    parts and their stack never coexist (deepseek-coder-33b's 62 bf16
    layers would hold 133 GB, twice the weights). Bit for bit
    ``_stack([make() for _ in range(reps)])``."""
    first = make()
    if reps == 1:
        return _stack([first])
    out = _tree(lambda t, _: t.new_empty((reps, *t.shape)), first)

    def put(dst, src, r: int) -> None:
        if isinstance(dst, dict):
            for k in dst:
                put(dst[k], src[k], r)
        else:
            dst[r].copy_(src)

    put(out, first, 0)
    del first
    for r in range(1, reps):
        put(out, make(), r)
    return out


def _block_init(kind: str, cfg: ModelConfig, gen: torch.Generator,
                dtype) -> Params:
    d = cfg.d_model
    if kind == "mlstm":
        return xlstm.mlstm_block_init(gen, cfg, dtype)
    if kind == "slstm":
        return xlstm.slstm_block_init(gen, cfg, dtype)
    if kind == "rec":
        mixer = {"rec": rglru.rec_block_init(gen, cfg, dtype)}
    elif kind in ("attn", "local_attn", "moe"):
        mixer = {"attn": layers.attn_init(gen, cfg, dtype)}
    else:
        raise ValueError(f"unknown block kind {kind}")
    ffn = ({"moe": moe_lib.moe_init(gen, cfg, dtype)} if kind == "moe"
           else {"ffn": layers.ffn_init(gen, cfg, dtype=dtype)})
    return {"norm1": layers.norm_init(d, cfg.norm, dtype, gen.device),
            **mixer,
            "norm2": layers.norm_init(d, cfg.norm, dtype, gen.device),
            **ffn}


@torch.no_grad()
def init(cfg: ModelConfig, generator: torch.Generator,
         device: torch.device | str | None = None) -> Params:
    """Random parameters drawn from ``generator`` (on its device), moved to
    ``device`` (None -> the card). Segment leaves are stacked over repeats,
    filled a layer at a time (each weight drawn in fp32 and cast, one
    weight's fp32 draw alive at a time); an unknown block kind raises
    ``ValueError``."""
    dev = device_lib.resolve(device)
    dtype = cfg.dtype
    params: Params = {"segments": []}
    for seg in cfg.segments():
        params["segments"].append(_init_stacked(seg.reps, lambda seg=seg: {
            f"b{i}": _block_init(kind, cfg, generator, dtype)
            for i, kind in enumerate(seg.pattern)}))
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


def train_state_from_jax(cfg: ModelConfig, state,
                         device: torch.device | str | None = None) -> Params:
    """The port's train state (``train.trainer.train_state_init``'s tree)
    holding a reference train state — numpy arrays or anything
    ``np.asarray`` takes: ``params`` as :func:`params_from_jax` carries
    them, the optimizer's moments (``mu``/``nu``, or Adafactor's ``v``
    tree) and the error-feedback residual ``ef`` in fp32, ``step`` int32
    and ``gnorm`` fp32, on ``device`` (None -> the card)."""
    dev = device_lib.resolve(device)

    def f32(tree):
        return _tree(lambda a, _: torch.tensor(np.asarray(a, np.float32),
                                               device=dev), tree)

    opt = {k: (torch.tensor(np.asarray(v), dtype=torch.int32, device=dev)
               if k == "step" else f32(v))
           for k, v in state["opt"].items()}
    out = {"params": params_from_jax(cfg, state["params"], device=dev),
           "opt": opt}
    if "ef" in state:
        out["ef"] = f32(state["ef"])
    return out


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def _block_cache_shapes(kind: str, cfg: ModelConfig, batch: int,
                        max_seq: int) -> dict[str, tuple]:
    if kind == "rec":
        return rglru.rec_state_specs(batch, cfg, cfg.dtype)
    if kind == "mlstm":
        return xlstm.mlstm_state_specs(batch, cfg, cfg.dtype)
    if kind == "slstm":
        return xlstm.slstm_state_specs(batch, cfg, cfg.dtype)
    if kind not in ("attn", "local_attn", "moe"):
        raise ValueError(kind)
    s = (min(cfg.local_window or max_seq, max_seq)
         if kind == "local_attn" else max_seq)
    return layers.kv_cache_shapes(batch, cfg.n_kv_heads, s,
                                  cfg.resolved_head_dim, cfg.dtype,
                                  cfg.kv_dtype)


#: Leaves that start at another value than 0: an empty KV slot's position,
#: and the xLSTM stabiliser, whose first step's max must take its gate.
_CACHE_FILL = {"kpos": -1, "m": xlstm.NEG}


def _cache_shapes(cfg: ModelConfig, batch: int, max_seq: int):
    return [{f"b{i}": {name: ((seg.reps,) + shape, dt)
                       for name, (shape, dt) in _block_cache_shapes(
                           kind, cfg, batch, max_seq).items()}
             for i, kind in enumerate(seg.pattern)}
            for seg in cfg.segments()]


def params_mesh(params: Params):
    """The ``DeviceMesh`` of DTensor parameters, or None for plain ones."""
    from torch.distributed.tensor import DTensor
    leaf = params["embed"]["embed"]
    return leaf.device_mesh if isinstance(leaf, DTensor) else None


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device: torch.device | str | None = None, mesh=None):
    """Empty caches on ``device`` (None -> card): k/v, int8 scales and
    recurrent state zero, kpos -1, the xLSTM ``m`` at ``xlstm.NEG``. With
    ``mesh``, DTensors laid out by ``sharding.cache_shardings`` (each rank
    fills its own shard)."""
    dev = device_lib.resolve(device)
    shapes = _cache_shapes(cfg, batch, max_seq)
    if mesh is None:
        return [{b: {name: torch.full(shape, _CACHE_FILL.get(name, 0),
                                      dtype=dt, device=dev)
                     for name, (shape, dt) in leaves.items()}
                 for b, leaves in seg.items()}
                for seg in shapes]
    from torch.distributed.tensor import DTensor
    meta = [{b: {name: torch.empty(shape, dtype=dt, device="meta")
                 for name, (shape, dt) in leaves.items()}
             for b, leaves in seg.items()} for seg in shapes]

    def fill(spec: torch.Tensor, sh, name: str):
        # the shard's shape from a meta stand-in; the shard filled here
        shard = sharding.distribute(spec, sh)
        local = torch.full(shard.to_local().shape, _CACHE_FILL.get(name, 0),
                           dtype=spec.dtype, device=dev)
        return DTensor.from_local(local, mesh, sh.placements,
                                  run_check=False, shape=shard.shape,
                                  stride=shard.stride())

    return [{b: {name: fill(t, sseg[b][name], name)
                 for name, t in leaves.items()}
             for b, leaves in seg.items()}
            for seg, sseg in zip(meta,
                                 sharding.cache_shardings(mesh, meta))]


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int):
    """``(shape, dtype)`` of every cache leaf, without allocating."""
    return _cache_shapes(cfg, batch, max_seq)


# Every cache leaf — k/v/kpos, the int8 scales and the recurrent state
# alike — is shaped [reps, batch, ...]: batch rides on axis 1. The three
# helpers below are the slot-pool contract of serving/server.py: a pooled
# cache is a cache whose batch axis is the slot-row axis. Functional, like
# the decode steps: the trees passed in are left as they were.

def _rows_on(rows, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(rows, dtype=torch.int64, device=like.device)


def _on_rows(fn, t: torch.Tensor, *others: torch.Tensor) -> torch.Tensor:
    """``fn(t, *others)`` for an op over the batch axis (1) of cache
    leaves. On a DTensor ``t`` the batch axis is made whole on every rank
    and ``fn`` runs on each rank's local shard (it touches no other axis,
    so those keep their shards with no collective); the result takes
    ``t``'s layout back, and ``others`` take ``t``'s (a plain one holds the
    same value on every rank). A plain ``t`` takes ``others`` whole."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import local_map
    if not isinstance(t, DTensor):
        return fn(t, *(sharding.whole(o) for o in others))
    mesh = t.device_mesh
    pl = tuple(Replicate() if d.is_partial() or d.is_shard(1) else d
               for d in t.placements)
    args = [a.redistribute(mesh, pl) if isinstance(a, DTensor)
            else sharding.distribute(a, sharding.NamedSharding(mesh, ()))
            .redistribute(mesh, pl) for a in (t,) + others]
    out = local_map(fn, out_placements=(pl,), in_placements=(pl,) * len(args),
                    device_mesh=mesh)(*args)
    return out.redistribute(mesh, t.placements) \
        if out.shape[1] == t.shape[1] else out


def cache_scatter_rows(pool, fresh, rows):
    """Write the rows of a small cache (batch b) into a pooled cache (batch
    B >= b) at batch indices ``rows`` [b] — how the server places a newly
    admitted request's prefill into its slot rows while in-flight rows keep
    decoding. A sharded pool keeps its layout."""
    return [{b: {name: _on_rows(
                     lambda tt, ff: tt.index_copy(1, _rows_on(rows, tt),
                                                  ff.to(tt.dtype)),
                     t, fseg[b][name])
                 for name, t in c.items()}
             for b, c in pseg.items()}
            for pseg, fseg in zip(pool, fresh)]


def cache_gather_rows(pool, rows):
    """The pooled cache restricted to batch indices ``rows`` [b] — the
    inverse of :func:`cache_scatter_rows` (slot inspection)."""
    return [{b: {name: _on_rows(
                     lambda tt: tt.index_select(1, _rows_on(rows, tt)), t)
                 for name, t in c.items()}
             for b, c in seg.items()}
            for seg in pool]


def cache_reset_rows(pool, row_mask):
    """Clear the rows where ``row_mask`` [B] is True: k/v, the int8 scales
    and the recurrent state to zero, kpos to -1 (empty). The server runs
    this when a slot group is freed, so unoccupied rows stay observably
    empty. The xLSTM ``m`` goes to 0 too, not to its init value, as in the
    reference: admission overwrites every leaf of the row."""
    def reset(t: torch.Tensor, value: int) -> torch.Tensor:
        m = torch.as_tensor(row_mask, dtype=torch.bool, device=t.device)
        m = m.reshape((1, m.shape[0]) + (1,) * (t.ndim - 2))
        return t.masked_fill(m, value)

    return [{b: {name: _on_rows(functools.partial(
                     reset, value=-1 if name == "kpos" else 0), t)
                 for name, t in c.items()}
             for b, c in seg.items()}
            for seg in pool]


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
            with layers.dtensor_scope(c["k"]):
                new[b] = {
                    "k": torch.where(keep[:, None], c["k"], 0).to(
                        c["k"].dtype),
                    "v": torch.where(keep[:, None], c["v"], 0).to(
                        c["v"].dtype),
                    "kpos": torch.where(keep, c["kpos"], -1).to(torch.int32)}
                for name in ("kscale", "vscale"):
                    if name in c:       # [reps, B, hkv, smax]: slot is last
                        new[b][name] = torch.where(keep, c[name], 0.0)
            new[b] = _keep_layout(new[b], c)
        out.append(new)
    return out


def _keep_layout(new: dict, like: dict) -> dict:
    """Each leaf of ``new`` in the layout of ``like``'s leaf of its name:
    a DTensor redistributed (a plain leaf, which holds the same value on
    every rank, distributed) where ``like``'s is a DTensor; taken whole
    where ``like``'s is plain."""
    from torch.distributed.tensor import DTensor
    if not any(isinstance(t, DTensor)
               for t in (*new.values(), *like.values())):
        return new
    out = {}
    for name, t in new.items():
        ref = like[name]
        if isinstance(ref, DTensor):
            sh = sharding.NamedSharding(ref.device_mesh, ())
            t = (t if isinstance(t, DTensor) else sharding.distribute(t, sh))
            t = t.redistribute(ref.device_mesh, ref.placements)
        else:
            t = sharding.whole(t)
        out[name] = t
    return out


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------


def _rope(cfg: ModelConfig, positions: torch.Tensor):
    """positions [S] or [B,S] (M-RoPE: [3,S] or [3,B,S]; one stream is
    broadcast to the three) -> cos/sin broadcastable against [B,H,S,dh]."""
    dh = cfg.resolved_head_dim
    rot = int(dh * cfg.rope_pct)
    rot -= rot % 2
    if cfg.m_rope_sections:
        if positions.ndim == 1 or positions.shape[0] != 3:
            positions = positions.expand((3,) + tuple(positions.shape))
        cos, sin = layers.mrope_cos_sin(positions, rot, cfg.rope_theta,
                                        cfg.m_rope_sections)
    else:
        cos, sin = layers.rope_cos_sin(positions, rot, cfg.rope_theta)
    if cos.ndim == 2:          # [S, half] -> [1, 1, S, half]
        return cos[None, None], sin[None, None]
    return cos[:, None], sin[:, None]     # [B, S, half] -> [B, 1, S, half]


def _attention_sublayer(cfg: ModelConfig, p: Params, x: torch.Tensor, rope,
                        mode: str, kind: str, cache, pos):
    """Attention sub-layer of attn/local_attn/moe blocks -> (x, new cache;
    None in ``forward`` and ``train`` mode). ``train`` takes the
    reference's training branches, never the flash kernel."""
    h, hkv = cfg.n_heads, cfg.n_kv_heads
    xn = layers.norm_apply(p["norm1"], x, cfg.norm)
    q = layers.split_heads(layers.dense(p["attn"]["wq"], xn), h)
    k = layers.split_heads(layers.dense(p["attn"]["wk"], xn), hkv)
    v = layers.split_heads(layers.dense(p["attn"]["wv"], xn), hkv)
    cos, sin = rope
    q = layers.apply_rope(q, cos, sin, cfg.rope_pct)
    k = layers.apply_rope(k, cos, sin, cfg.rope_pct)
    # The reference's activation-sharding policy (identity without a
    # mesh): sequence-sharded queries and gathered K/V under seq_shard;
    # else head-TP when both head counts divide the model axis; else the
    # KV sequence over "model".
    if mode != "decode":
        msize = layers.axis_size("model")
        if cfg.seq_shard:
            q = layers.constrain(q, ("batch", None, "model", None))
            k = layers.constrain(k, ("batch", None, None, None))
            v = layers.constrain(v, ("batch", None, None, None))
        elif h % msize == 0 and hkv % msize == 0:
            q = layers.constrain(q, ("batch", "model", None, None))
            k = layers.constrain(k, ("batch", "model", None, None))
            v = layers.constrain(v, ("batch", "model", None, None))
        else:
            q = layers.constrain(q, ("batch", None, None, None))
            k = layers.constrain(k, ("batch", None, "model", None))
            v = layers.constrain(v, ("batch", None, "model", None))
    window = cfg.local_window if kind == "local_attn" else 0
    new_cache = None
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
        elif (mode != "train" and cfg.attn_scores_f32
              and (cfg.causal or not window)):
            # the flash kernel (plain version on the CPU): a causal prompt
            # (for s <= window the window mask is a no-op: qpos - window <
            # 0 <= kpos), or the encoder's full attention (Sq == Skv)
            attn = flash_ops.flash_attention(
                q.contiguous(), k.contiguous(), v.contiguous(),
                causal=cfg.causal, chunk=cfg.attn_chunk)
        elif s > cfg.attn_chunk and cfg.causal:
            attn = layers.attention_chunked(q, k, v, causal=True,
                                            chunk=cfg.attn_chunk,
                                            scores_f32=cfg.attn_scores_f32)
        else:
            attn = layers.attention_full(q, k, v, causal=cfg.causal,
                                         window=window,
                                         scores_f32=cfg.attn_scores_f32)
        if mode == "prefill":
            new_cache = _prefill_kv_cache(cfg, cache, k, v, window)
    out = layers.dense(p["attn"]["wo"], layers.merge_heads(attn))
    return x + out, new_cache


def _prefill_kv_cache(cfg: ModelConfig, cache, k: torch.Tensor,
                      v: torch.Tensor, window: int):
    """The prompt's k/v [B, Hkv, S, dh] as a cache shaped like ``cache``:
    the last min(s, smax) positions land at slot = pos % smax — the decode
    step's slot formula (smax == window for local attention)."""
    b, _, s, _ = k.shape
    smax = cache["k"].shape[2]
    if s > smax and (not window or smax < window):
        raise ValueError(f"prompt length {s} exceeds cache capacity "
                         f"{smax}; raise max_seq")
    keep = min(s, smax)
    kept_pos = torch.arange(s - keep, s, dtype=torch.int64, device=k.device)
    slots = kept_pos % smax
    store = layers.kv_store_dtype(k.dtype, cfg.kv_dtype)
    kk, vk = (layers.gather_dim(t, 2)[:, :, s - keep:] for t in (k, v))

    def place(t: torch.Tensor) -> torch.Tensor:
        # [B, Hkv, keep(, dh)] -> [B, Hkv, smax(, dh)]: position p at slot
        # p % smax — the kept run rotated by its first slot, or followed
        # by empty (zero) slots
        if keep == smax:
            return torch.roll(t, (s - keep) % smax, 2)
        pad = (0, 0) * (t.ndim - 3) + (0, smax - keep)
        return torch.nn.functional.pad(t, pad)

    new_cache = {}
    if cfg.kv_dtype == "int8":      # empty slots keep a zero scale
        kk, k_sc = layers.quantize_kv(kk)
        vk, v_sc = layers.quantize_kv(vk)
        new_cache.update(kscale=place(k_sc), vscale=place(v_sc))
    kpos = torch.full((smax,), -1, dtype=torch.int32, device=k.device)
    kpos[slots] = kept_pos.to(torch.int32)
    new_cache.update(k=place(kk.to(store)), v=place(vk.to(store)),
                     kpos=kpos[None].expand(b, smax).clone())
    return new_cache


#: Modes that run the whole sequence and build no cache.
_NO_CACHE = ("forward", "train")


def _block_apply(kind: str, cfg: ModelConfig, p: Params, x: torch.Tensor, *,
                 mode: str, rope, mask_ids, cache, pos):
    """x [B,S,D] (forward/train/prefill) or [B,1,D] (decode) -> (x, new
    cache, MoE aux loss or None). ``forward`` and ``train`` modes build no
    cache."""
    # the residual stream's layout (a hint, as _embed_in states it):
    # batch-sharded, and sequence-sharded under seq_shard (attention
    # blocks). Each mixer's output and each block's output keep it: a
    # head-parallel output product leaves a partial sum that DTensor would
    # otherwise scatter over the sequence, which the recurrences cannot
    # take and the next block's MoE groups cannot split
    seqp = (("batch", "model", None)
            if cfg.seq_shard and mode != "decode" else None)
    resid = seqp or ("batch", None, None)
    if kind in ("mlstm", "slstm"):
        if mode == "decode":
            step = (xlstm.mlstm_block_step if kind == "mlstm"
                    else xlstm.slstm_block_step)
            y, new_cache = step(p, x[:, 0], cache, cfg, mask_ids=mask_ids)
            y = y[:, None, :]
        else:
            apply = (xlstm.mlstm_block_apply if kind == "mlstm"
                     else xlstm.slstm_block_apply)
            y, new_cache = apply(p, x, cfg, mask_ids=mask_ids)
        return layers.constrain(x + y, resid), \
            (None if mode in _NO_CACHE else new_cache), None
    if kind == "rec":
        xn = layers.norm_apply(p["norm1"], x, cfg.norm)
        if mode == "decode":
            y, new_cache = rglru.rec_block_step(p["rec"], xn[:, 0], cache,
                                                cfg)
            y = y[:, None, :]
        else:
            y, new_cache = rglru.rec_block_apply(p["rec"], xn, cfg)
        x = layers.constrain(x + y, resid)
        if mode in _NO_CACHE:
            new_cache = None
    elif kind in ("attn", "local_attn", "moe"):
        x, new_cache = _attention_sublayer(cfg, p, x, rope, mode, kind,
                                           cache, pos)
        x = layers.constrain(x, resid)
        xn = layers.norm_apply(p["norm2"], x, cfg.norm)
        if kind == "moe":
            if seqp and not cfg.moe_local_groups:
                # MoE groups cross the sequence shards: route over full S
                xn = layers.constrain(xn, ("batch", None, None))
            y, aux = moe_lib.moe_apply(p["moe"], xn, cfg, mask_ids=mask_ids)
        else:
            y = layers.ffn_apply(p["ffn"], xn, cfg, mask_ids=mask_ids)
            aux = None
        return layers.constrain(x + y, resid), new_cache, aux
    else:
        raise ValueError(kind)
    xn = layers.norm_apply(p["norm2"], x, cfg.norm)
    return layers.constrain(
        x + layers.ffn_apply(p["ffn"], xn, cfg, mask_ids=mask_ids), resid), \
        new_cache, None


@functools.cache
def _matmul_ops() -> frozenset:
    aten = torch.ops.aten
    return frozenset((aten.mm.default, aten.bmm.default, aten.addmm.default,
                      aten.baddbmm.default))


def _save_dots(ctx, op, *args, **kwargs):
    """The "dots" policy: keep the matrix products' outputs, recompute the
    rest (``jax.checkpoint_policies.checkpoint_dots``)."""
    if op in _matmul_ops():
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg: ModelConfig, fn):
    """``fn`` under ``cfg.remat`` (the reference's ``_remat``)."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "dots":
        ctx = functools.partial(ckpt.create_selective_checkpoint_contexts,
                                _save_dots)
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False,
                                 context_fn=ctx)
    if cfg.remat == "full":
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False)
    raise ValueError(f"unknown remat {cfg.remat!r}")


def _run_stack(cfg: ModelConfig, params: Params, x: torch.Tensor, *,
               mode: str, rope, mask_ids, caches=None, pos=None):
    """Every layer in order; returns (x, caches stacked [reps, ...] — None
    in ``forward`` and ``train`` mode —, the summed MoE aux loss, fp32).
    ``train`` runs each repeat's body under ``cfg.remat``."""
    new_caches = [] if mode not in _NO_CACHE else None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for si, seg in enumerate(cfg.segments()):
        sp = params["segments"][si]
        sc = caches[si] if caches is not None else None
        if mode == "train":
            def rep_body(h, total, rp, seg=seg):
                for i, kind in enumerate(seg.pattern):
                    h, _, a = _block_apply(kind, cfg, rp[f"b{i}"], h,
                                           mode=mode, rope=rope,
                                           mask_ids=mask_ids, cache=None,
                                           pos=None)
                    if a is not None:
                        total = total + a
                return h, total

            body = _remat(cfg, rep_body)
            for r in range(seg.reps):
                x, aux = body(x, aux, plan_lib.tree_map(
                    lambda a, r=r: a[r], sp))
            continue
        outs = []
        for r in range(seg.reps):
            rc = {}
            for i, kind in enumerate(seg.pattern):
                bp = plan_lib.tree_map(lambda a, r=r: a[r], sp[f"b{i}"])
                bc = ({k: t[r] for k, t in sc[f"b{i}"].items()}
                      if sc is not None else None)
                x, rc[f"b{i}"], a = _block_apply(
                    kind, cfg, bp, x, mode=mode, rope=rope,
                    mask_ids=mask_ids, cache=bc, pos=pos)
                if bc is not None and rc[f"b{i}"] is not None:
                    rc[f"b{i}"] = _keep_layout(rc[f"b{i}"], bc)
                if a is not None:
                    aux = aux + a
            outs.append(rc)
        if new_caches is not None:
            new_caches.append(_stack(outs))
    return x, new_caches, aux


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


@torch.no_grad()
def pack_ffn_params(cfg: ModelConfig, params: Params) -> Params:
    """Checkpoint conversion: masked-FFN weights -> per-sample packed
    serving weights (mask-zero skipping, paper §V-C), through
    ``core.plan.pack_ffn_leaves``. Use with ``dataclasses.replace(cfg,
    packed_ffn_serving=True)``; exact vs the masked form. Only dense FFN
    blocks pack: MoE experts (arctic's dense residual among them) and the
    xLSTM blocks' internal masks keep the multiply form, as in the
    reference."""
    new = dict(params)
    new["segments"] = []
    for seg in params["segments"]:
        out = {}
        for name, block in seg.items():
            block = dict(block)
            if "ffn" in block and "masks" in block["ffn"]:
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


def _embed_in(cfg: ModelConfig, params: Params, batch: Params
              ) -> torch.Tensor:
    if "embeds" in batch:
        x = batch["embeds"].to(cfg.dtype)
    else:
        x = layers.embed_tokens(params["embed"], batch["tokens"])
    # residual stream: batch-sharded; sequence-sharded over "model" too
    # under sequence parallelism
    if cfg.seq_shard:
        return layers.constrain(x, ("batch", "model", None))
    return layers.constrain(x, ("batch", None, None))


def _positions(cfg: ModelConfig, batch: Params, seq: int, device
               ) -> torch.Tensor:
    """The batch's ``positions``, or 0..seq-1 (on each M-RoPE stream)."""
    if "positions" in batch:
        return torch.as_tensor(batch["positions"], device=device)
    pos = torch.arange(seq, dtype=torch.int32, device=device)
    return pos.expand(3, seq) if cfg.m_rope_sections else pos


@torch.no_grad()
def forward(cfg: ModelConfig, params: Params, batch: Params,
            mask_ids: torch.Tensor | None = None,
            device: torch.device | str | None = None):
    """The whole sequence at once, no caches, on ``device`` (None -> the
    card), where ``params`` must live: batch {tokens [B,S] | embeds
    [B,S,D], positions (optional; [S], [B,S], or M-RoPE's [3,S] /
    [3,B,S])} -> (logits [B,S,V], MoE aux loss fp32). A Bayesian config
    without ``mask_ids`` takes the Masksembles batch-group assignment.
    Inference only (no gradients; attention through the flash kernel):
    training's forward is :func:`forward_train`."""
    dev = device_lib.resolve(device)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    x = _embed_in(cfg, params, batch)
    b, s = x.shape[:2]
    mask_ids = _mask_ids(cfg, b, None if mask_ids is None
                         else torch.as_tensor(mask_ids, device=dev), dev)
    rope = _rope(cfg, _positions(cfg, batch, s, x.device))
    x, _, aux = _run_stack(cfg, params, x, mode="forward", rope=rope,
                           mask_ids=mask_ids)
    x = layers.norm_apply(params["final_norm"], x, cfg.norm)
    return layers.lm_head(params["embed"], x), aux


def forward_train(cfg: ModelConfig, params: Params, batch: Params,
                  mask_ids: torch.Tensor | None = None):
    """The training graph (the reference's ``forward``), with gradients, on
    the device ``params`` live on: batch as for :func:`forward` ->
    (logits [B,S,V], MoE aux loss fp32). Attention takes the reference's
    training branches (banded, chunked, full: no flash kernel), every
    ``rec`` block's recurrence the ``rglru_scan`` kernel and its backward
    (``RGLRUScan``), and each repeat runs under ``cfg.remat``."""
    dev = params["embed"]["embed"].device
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    x = _embed_in(cfg, params, batch)
    b, s = x.shape[:2]
    mask_ids = _mask_ids(cfg, b, None if mask_ids is None
                         else torch.as_tensor(mask_ids, device=dev), dev)
    rope = _rope(cfg, _positions(cfg, batch, s, dev))
    x, _, aux = _run_stack(cfg, params, x, mode="train", rope=rope,
                           mask_ids=mask_ids)
    if cfg.seq_shard:       # one gather of the final hidden state (a hint)
        x = layers.constrain(x, ("batch", None, None))
    x = layers.norm_apply(params["final_norm"], x, cfg.norm)
    return layers.lm_head(params["embed"], x), aux


@torch.no_grad()
def prefill(cfg: ModelConfig, params: Params, batch: Params,
            max_seq: int | None = None,
            mask_ids: torch.Tensor | None = None,
            last_index: int | None = None):
    """Consume the prompt: batch {tokens [B,S] | embeds [B,S,D] (cast to
    ``cfg.dtype``), positions (optional, as for :func:`forward`)} ->
    (logits [B,V] at the last position, or at ``last_index`` — the
    bucketed form — and caches sized ``max_seq`` (default: the prompt
    length)). DTensor parameters give DTensor logits and caches laid out
    by ``cache_shardings``."""
    mesh = params_mesh(params)
    with layers.dtensor_scope(params["embed"]["embed"]):
        batch = _batch_on(mesh, batch)
        x = _embed_in(cfg, params, batch)
        b, s = x.shape[:2]
        mask_ids = _mask_ids(cfg, b, mask_ids, x.device)
        caches = init_cache(cfg, b, max_seq or s, device=x.device, mesh=mesh)
        rope = _rope(cfg, _positions(cfg, batch, s, x.device))
        x, new_caches, _ = _run_stack(cfg, params, x, mode="prefill",
                                      rope=rope, mask_ids=mask_ids,
                                      caches=caches)
        i = s - 1 if last_index is None else int(last_index)
        x = layers.gather_dim(x, 1)[:, i:i + 1]
        x = layers.norm_apply(params["final_norm"], x, cfg.norm)
        return layers.lm_head(params["embed"], x)[:, 0], new_caches


def _batch_on(mesh, batch: Params) -> Params:
    """The batch's plain tensors laid out by ``batch_shardings`` on
    ``mesh`` (every rank passes the same values and keeps its own shard);
    the batch as it is without a mesh."""
    from torch.distributed.tensor import DTensor
    if mesh is None:
        return batch
    plain = {k: torch.as_tensor(v) for k, v in batch.items()
             if not isinstance(v, DTensor)}
    if not plain:
        return batch
    return {**batch, **sharding.distribute_tree(
        plain, sharding.batch_shardings(mesh, plain))}


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: Params, caches,
                tokens: torch.Tensor, pos, mask_ids=None):
    """One serving step: tokens [B,1] + caches @ pos -> (logits [B,V], new
    caches). ``pos`` is a scalar shared by the batch or a per-row [B]
    vector (every cache row at its own position); it is both the rotary
    position (every M-RoPE stream) and the cache slot, as in the
    reference. DTensor parameters take ``tokens`` laid out by
    ``batch_shardings`` and give DTensor logits; every new cache leaf keeps
    the layout of the one it replaces."""
    mesh = params_mesh(params)
    with layers.dtensor_scope(params["embed"]["embed"]):
        tokens = _batch_on(mesh, {"tokens": tokens})["tokens"]
        x = layers.embed_tokens(params["embed"], tokens)
        b = x.shape[0]
        mask_ids = _mask_ids(cfg, b, mask_ids, x.device)
        p = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
        if p.ndim == 0:
            pos_arr = p.expand(3, 1) if cfg.m_rope_sections else p[None]
        else:
            pos_arr = (p[None, :, None].expand(3, b, 1)
                       if cfg.m_rope_sections else p[:, None])
        x, new_caches, _ = _run_stack(cfg, params, x, mode="decode",
                                      rope=_rope(cfg, pos_arr),
                                      mask_ids=mask_ids, caches=caches, pos=p)
        x = layers.norm_apply(params["final_norm"], x, cfg.norm)
        return layers.lm_head(params["embed"], x)[:, 0], new_caches
