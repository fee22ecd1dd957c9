"""Public wrapper of the fused serving-decode kernel
(``csrc/fused_decode.cu``).

:func:`fused_decode` keeps the reference wrapper's signature and outputs
(``repro.kernels.fused_plan.ops.fused_decode``) and dispatches by device: a
CPU tensor takes the plain ``fused_decode_ref``, a CUDA tensor launches the
kernel — one cooperative launch per step — or raises.

The kernel takes the chain ``core/plan.lower_fused_decode`` emits: layers
of (norm, attn, norm, ffn) that agree in everything but the attention
window, then (norm, dense LM head). It is bound by bytes: each weight is
read once a step for all rows (``qwen2-1.5b`` at 32 rows: 3.23 GB, 0.964
ms at 3.35 TB/s), and its products run on the tensor cores as three bf16
products of exact parts (3xTF32 for fp32 weights). A layer takes seven
grid barriers (two norms, q/k/v, attention, wo, gate/up, down; the down
GEMV computes the hidden units as it stages them). Its own limit is a head
width of at most 256; beyond it, or for another chain shape, it raises
:class:`FusedPlanUnsupported` and the serving steps fall back per-op. It
keeps no residency limit: weights and caches are read from device memory
in place.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_plan import ref as _ref
from repro_torch.kernels.fused_plan.ref import (FusedDecodeSpec,
                                                FusedPlanUnsupported)

__all__ = ["MAX_HEAD_DIM", "fused_decode", "fused_decode_ref",
           "last_grid", "stage_names", "stage_ms", "FusedPlanUnsupported"]

#: Head width the attention stage takes (csrc MAX_DH).
MAX_HEAD_DIM = 256
#: Attention parts a (row, head chunk) at most (csrc PMAX).
_ATTN_PARTS = 8

_ACT_CODES = {"identity": 0, "relu": 1, "gelu": 2, "gelu_mlp": 2, "silu": 3,
              "sigmoid": 4, "tanh": 5}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p]
#: Per-layer pointer table order (csrc enum LP_*).
_LAYER_SLOTS = ("n1s", "n1b", "wq", "bq", "wk", "bk", "wv", "bv", "wo",
                "n2s", "n2b", "wg", "wu", "bu", "wd", "bd", "mask",
                "kc", "vc", "kpos", "window", "smax")

fused_decode_ref = _ref.fused_decode_ref


@dataclasses.dataclass(frozen=True)
class _Layout:
    n_layers: int
    attn: _ref.FusedStep            # the first layer's (windows may differ)
    windows: tuple[int, ...]
    ffn: _ref.FusedStep
    norm: _ref.FusedStep


@functools.lru_cache(maxsize=64)
def _layout(spec: FusedDecodeSpec) -> _Layout:
    """Check the chain is the layer-uniform shape the kernel runs."""
    steps = spec.steps
    n_layers, rest = divmod(len(steps) - 2, 4)
    if rest or n_layers < 1:
        raise FusedPlanUnsupported(f"decode chain of {len(steps)} steps is "
                                   f"not (norm, attn, norm, ffn) x L + 2")
    norm, attn, ffn = steps[0], steps[1], steps[3]
    windows = []
    for li in range(n_layers):
        n1, at, n2, ff = steps[4 * li: 4 * li + 4]
        if (n1, n2, at.kind, ff) != (norm, norm, "attn", ffn) or \
                dataclasses.replace(at, window=0) != \
                dataclasses.replace(attn, window=0):
            raise FusedPlanUnsupported(f"layer {li} differs from layer 0 "
                                       f"beyond its attention window")
        windows.append(at.window)
    head = steps[-1]
    if steps[-2] != norm or head.kind != "dense" or head.shared_bias \
            or head.activation or head.d_out != spec.vocab:
        raise FusedPlanUnsupported("decode chain does not end in (norm, "
                                   "bias-free LM head)")
    if norm.kind != "norm" or ffn.kind != "ffn":
        raise FusedPlanUnsupported("decode chain step kinds out of order")
    if attn.head_dim > MAX_HEAD_DIM:
        raise FusedPlanUnsupported(f"head_dim {attn.head_dim} > "
                                   f"{MAX_HEAD_DIM} the kernel holds")
    if attn.n_heads % attn.n_kv_heads:
        raise FusedPlanUnsupported("n_heads not a multiple of n_kv_heads")
    return _Layout(n_layers, attn, tuple(windows), ffn, norm)


@functools.lru_cache(maxsize=16)
def _workspace(spec: FusedDecodeSpec, rows: int, device: torch.device
               ) -> tuple[torch.Tensor, tuple[int, ...], torch.Tensor]:
    """One fp32 scratch buffer per (spec, rows, device), allocated once and
    zeroed (the attention's per-(row, head chunk) counts start at 0 and
    the kernel resets each after use), the addresses of its parts (csrc
    Args resid .. cnt), and the buffer of the kernel's barrier timestamps."""
    lay = _layout(spec)
    at, f = lay.attn, lay.ffn.d_hidden
    b = rows // spec.n_samples
    d, v = spec.d_model, spec.vocab
    heads = rows * at.n_heads * _ATTN_PARTS
    sizes = (rows * d, rows * d,
             rows * (at.n_heads + 2 * at.n_kv_heads) * at.head_dim,
             rows * at.n_heads * at.head_dim, rows * 2 * f,
             rows * v, rows, rows, b * v, heads * 2,
             heads * at.head_dim, rows * at.n_heads)
    pad = [-(-n // 64) * 64 for n in sizes]       # 256-byte aligned parts
    buf = torch.zeros(sum(pad), dtype=torch.float32, device=device)
    base, ptrs = buf.data_ptr(), []
    for n in pad:
        ptrs.append(base)
        base += 4 * n
    stamps = torch.zeros(len(stage_names(spec)) + 1, dtype=torch.int64,
                         device=device)
    return buf, tuple(ptrs), stamps


_LAYER_STAGES = ("norm1", "qkv", "attention", "wo", "norm2", "gate_up",
                 "down")
_HEAD_STAGES = ("final_norm", "lm_head", "log_sum_exp", "welford",
                "argmax")


def stage_names(spec: FusedDecodeSpec) -> tuple[str, ...]:
    """The kernel's stages in launch order, one per grid barrier (and the
    last one), named as in ``stage_ms``."""
    return _LAYER_STAGES * _layout(spec).n_layers + _HEAD_STAGES


def stage_ms(spec: FusedDecodeSpec, rows: int,
             device: torch.device | str) -> dict[str, float]:
    """Where the last launch at this (spec, rows, device) spent its time:
    milliseconds per stage name, summed over layers, from the timestamps
    block 0 takes after every grid barrier (the last stage is block 0's
    share only). Synchronises the device."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    _, _, stamps = _workspace(spec, rows, dev)
    t = stamps.cpu().tolist()
    out: dict[str, float] = {}
    for name, t0, t1 in zip(stage_names(spec), t, t[1:]):
        out[name] = out.get(name, 0.0) + (t1 - t0) / 1e6
    return out


def _ptr(t: torch.Tensor | None) -> int:
    return 0 if t is None else t.data_ptr()


def fused_decode(spec: FusedDecodeSpec, x: torch.Tensor,
                 params: tuple[torch.Tensor, ...],
                 caches: tuple[torch.Tensor, ...], pos: torch.Tensor,
                 cos: torch.Tensor, sin: torch.Tensor):
    """One lowered serving decode step in one kernel launch.

    x [R, d_model] (embedded pool tokens), params per
    ``decode_param_slots``, caches flattened ``(k, v, kpos)`` per 'attn'
    step, pos [R] int32 (-1 = inactive row), cos/sin [R, rot/2] fp32 ->
    ``(mean_logp [b, V] f32, rel_unc [b] f32, k_new, v_new)`` with
    k_new/v_new ``[n_attn, R, hkv, dh]`` in x's dtype.
    """
    if torch.is_grad_enabled():     # the operand walk only when recording
        _build.check_no_grad(
            "fused_decode", x=x, cos=cos, sin=sin,
            **{f"params[{i}]": t for i, t in enumerate(params)},
            **{f"caches[{i}]": t for i, t in enumerate(caches)})
    if x.device.type == "cpu":
        return _ref.fused_decode_ref(spec, x, params, caches, pos, cos, sin)
    return _launch(spec, x, params, caches, pos, cos, sin)


def _launch(spec: FusedDecodeSpec, x: torch.Tensor,
            params: tuple[torch.Tensor, ...],
            caches: tuple[torch.Tensor, ...], pos: torch.Tensor,
            cos: torch.Tensor, sin: torch.Tensor):
    """Check the operands, build the pointer tables and launch."""
    lay = _layout(spec)
    at, ff = lay.attn, lay.ffn
    dev = x.device
    rows, n = x.shape[0], spec.n_samples
    if x.ndim != 2 or x.shape[1] != spec.d_model or rows % n:
        raise ValueError(f"fused_decode: x {tuple(x.shape)}, spec wants "
                         f"[R, {spec.d_model}] with R a multiple of {n}")
    tw = _DTYPE_CODES.get(x.dtype)
    if tw is None:
        raise TypeError(f"fused_decode: x is {x.dtype}; the kernel takes "
                        f"float32 or bfloat16")
    if len(caches) != 3 * lay.n_layers:
        raise ValueError(f"expected {3 * lay.n_layers} cache arrays, got "
                         f"{len(caches)}")
    per = _ref.decode_step_params(spec, params)
    for name, t in (("x", x), ("pos", pos), ("cos", cos), ("sin", sin)):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"fused_decode: {name} must be contiguous on "
                             f"{dev}")
    half = at.rot_dim // 2
    if pos.dtype != torch.int32 or tuple(pos.shape) != (rows,) or \
            cos.dtype != torch.float32 or sin.dtype != torch.float32 or \
            tuple(cos.shape) != (rows, half) or \
            tuple(sin.shape) != (rows, half):
        raise ValueError("fused_decode: pos must be int32 [R] and cos/sin "
                         f"float32 [R, {half}]")
    for i, p in enumerate(per):
        for name, t in p.items():
            if t.device != dev or t.dtype != x.dtype or \
                    not t.is_contiguous():
                raise ValueError(
                    f"fused_decode: step {i} {name} must be a contiguous "
                    f"{x.dtype} tensor on {dev}, got {t.dtype} on {t.device}")
    npk = per[3]["wup"].shape[0] if ff.per_sample else 1
    if rows % npk:
        raise ValueError(f"fused_decode: {rows} rows not a multiple of the "
                         f"{npk} packed samples")
    tc = None
    table = []
    for li in range(lay.n_layers):
        kc, vc, kpos = caches[3 * li: 3 * li + 3]
        smax = kc.shape[2]
        want = (rows, at.n_kv_heads, smax, at.head_dim)
        if tuple(kc.shape) != want or tuple(vc.shape) != want or \
                tuple(kpos.shape) != (rows, smax) or \
                kpos.dtype != torch.int32 or kc.dtype != vc.dtype or \
                not (kc.is_contiguous() and vc.is_contiguous()
                     and kpos.is_contiguous()) or \
                {kc.device, vc.device, kpos.device} != {dev}:
            raise ValueError(f"fused_decode: layer {li} cache must be "
                             f"contiguous k/v {want} and int32 kpos "
                             f"{(rows, smax)} on {dev}")
        code = _DTYPE_CODES.get(kc.dtype)
        if code is None or (tc is not None and code != tc):
            raise TypeError(f"fused_decode: cache dtype {kc.dtype}")
        tc = code
        n1, atp, n2, ffp = per[4 * li: 4 * li + 4]
        ptr = {"n1s": n1["scale"], "n1b": n1.get("bias"),
               "n2s": n2["scale"], "n2b": n2.get("bias"),
               "kc": kc, "vc": vc, "kpos": kpos}
        for w in ("wq", "bq", "wk", "bk", "wv", "bv", "wo"):
            ptr[w] = atp.get(w)
        names = (("wg", "wgp"), ("wu", "wup"), ("wd", "wdp"), ("bu", "bu"),
                 ("bd", "bd"), ("mask", "mask"))
        for slot, name in names:
            ptr[slot] = ffp.get(name if ff.per_sample else slot)
        row = [_ptr(ptr[s]) for s in _LAYER_SLOTS[:-2]]
        table.append(row + [lay.windows[li], smax])
    table_host = np.asarray(table, dtype=np.int64)   # the weights' tensor maps
    table_dev = torch.from_numpy(table_host).to(dev)
    fin = per[-2]
    b = rows // n
    mean = torch.empty((b, spec.vocab), dtype=torch.float32, device=dev)
    rel = torch.empty((b,), dtype=torch.float32, device=dev)
    shape = (lay.n_layers, rows, at.n_kv_heads, at.head_dim)
    knew = torch.empty(shape, dtype=x.dtype, device=dev)
    vnew = torch.empty(shape, dtype=x.dtype, device=dev)
    _, ws, stamps = _workspace(spec, rows, dev)
    meta = np.asarray([
        rows, spec.d_model, at.n_heads, at.n_kv_heads, at.head_dim,
        at.rot_dim, ff.d_hidden, spec.vocab, lay.n_layers, n, npk,
        int(lay.norm.norm == "layernorm"), int(ff.gated), int(ff.masked),
        int(ff.per_sample), int(ff.ffn_bias), int(at.qkv_bias),
        _ACT_CODES[ff.activation],
        x.data_ptr(), pos.data_ptr(), cos.data_ptr(), sin.data_ptr(),
        table_dev.data_ptr(), _ptr(fin["scale"]), _ptr(fin.get("bias")),
        per[-1]["w"].data_ptr(), mean.data_ptr(), rel.data_ptr(),
        knew.data_ptr(), vnew.data_ptr(), *ws, stamps.data_ptr(),
        stamps.numel(), table_host.ctypes.data],
        dtype=np.int64)
    grid = ctypes.c_int(0)
    fn = _build.bind("fused_decode", "fused_decode_launch", _ARGTYPES)
    with _build.on_device(dev):
        err = fn(meta.ctypes.data, tw, tc, _build.stream_of(dev),
                 ctypes.byref(grid))
    _build.check_launch("fused_decode", err)
    fused_decode.launches += 1
    last_grid["blocks"] = grid.value
    return mean, rel, knew, vnew


#: Blocks of the last launch (occupancy x SMs), for the chip report.
last_grid: dict[str, int] = {"blocks": 0}

#: Kernel launches since the count was last set to 0.
fused_decode.launches = 0
