"""PackedPlan — the mask-compilation pipeline (paper Fig. 1, Phase 3), the
feed-forward half of ``repro.core.plan``.

One place lowers a dropout-equipped network to a mask-based BayesNN served
with mask-zero skipping (packed per-sample dense weights, §V-C) and the
batch-level sample schedule (§V-D). It owns BN folding, the ``kept_indices``
gathers, and kernel dispatch: every relu :class:`PackedPair` on a shared
input runs through ``kernels/masked_ffn`` (per-op executor), and the whole
chain runs through ``kernels/fused_plan`` (fused executor). Dispatch is by
tensor device: CPU tensors take the plain PyTorch versions, CUDA tensors the
hand-written kernels.

IR: a :class:`PackedPlan` is an ordered list of ops over a running hidden
state ``h`` (``[B, D]`` until the first packed op introduces the sample axis,
``[G·N, B, D]`` after it):

  =====================  ====================================================
  :class:`SharedDense`   ``h @ w + b`` with weights shared across samples
  :class:`PackedPair`    ``act(h @ w1p[n] + b1p[n]) @ w2p[n] + b2`` — the
                         masked_ffn kernel shape
  :class:`Activation`    elementwise nonlinearity
  :class:`OutputHead`    final (optionally per-mask in-gathered) dense +
                         output activation
  =====================  ====================================================

Stacked sub-networks (IVIM's 4 identical chains) ride the sample axis:
``groups=G`` flattens subnet × mask into ``G·N`` weight sets applied to one
shared batch. The executors un-flatten at the end and apply the clinical
range conversion C(.) when ``out_ranges`` is set.
"""

from __future__ import annotations

import dataclasses
import functools
import weakref
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core import latency_model
from repro_torch.core import masks as masks_lib
from repro_torch.core import masksembles
from repro_torch.core import packing
from repro_torch.core import scheduler as sched_lib
from repro_torch.core import uncertainty as unc_lib
from repro_torch.distributed import compression
from repro_torch.kernels.fused_decode import ops as fd_ops
from repro_torch.kernels.fused_plan import ops as fp_ops
from repro_torch.kernels.fused_plan import ref as fused_ref
from repro_torch.kernels.fused_plan.ref import FusedPlanUnsupported
from repro_torch.kernels.masked_ffn import ops as mffn_ops
from repro_torch.obs import registry as obs_registry

Params = dict[str, Any]

__all__ = ["SharedDense", "PackedPair", "Activation", "OutputHead",
           "PackedPlan", "Precision", "ACTIVATIONS", "activation_fn",
           "tree_map", "params_from_jax",
           "fold_bn_dense", "fold_bn_ivim", "compile_ivim", "compile_mlp",
           "compile_masked_ffn", "execute", "lower_fused", "execute_fused",
           "fused_executor", "FusedPlanUnsupported", "build_counts",
           "pack_ffn_leaves", "ffn_leaves_apply", "lower_fused_decode",
           "compile_decode_step", "decode_fused_spec", "prefill_buckets",
           "prefill_bucket", "prefill_fused_spec", "compile_prefill_step",
           "decode_stage_traffic", "decode_traffic"]

#: The one activation table: any name that trains in ``core/transform``
#: compiles here and lowers to the fused kernels.
ACTIVATIONS = fused_ref.ACTIVATIONS
activation_fn = fused_ref.act_fn


@dataclasses.dataclass(frozen=True)
class Precision:
    """Serving precision of a :class:`PackedPlan`: the storage dtype of the
    packed dense weights. "fp32" serves the master weights as they are;
    "int8" quantizes each weight per output channel (symmetric, bf16
    scales) and stores biases as bf16 — once per lowering for the fused
    executor, once per plan for the per-op one — and the kernels
    dequantize next to the product. The KV-cache dtype is a model knob
    (``ModelConfig.kv_dtype``), not a plan property."""
    weights: str = "fp32"

    def __post_init__(self) -> None:
        if self.weights not in ("fp32", "int8"):
            raise ValueError(f"unknown weight precision {self.weights!r}")


# ---------------------------------------------------------------------------
# ops (static metadata; weights live in plan.params[op.name])
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SharedDense:
    """Sample-independent dense: params {w [D, D2], b [D2]?}."""
    name: str
    d_in: int
    d_out: int
    activation: str | None = None


@dataclasses.dataclass(frozen=True)
class PackedPair:
    """Fused 2-matrix packed FFN over per-mask gathered weights.

    params: w1p [Ne, d_in, keep], b1p [Ne, keep], w2p [Ne, keep, d_out] and
    either b2 [d_out] (shared) or b2p [Ne, d_out] (the pair's output units
    are themselves mask-gathered). ``d_in``/``d_out`` are the packed operand
    widths; ``d_in_full``/``d_out_full``/``hidden`` the unpacked ones.
    """
    name: str
    d_in: int
    hidden: int
    keep: int
    d_out: int
    d_in_full: int = 0
    d_out_full: int = 0
    activation: str = "relu"

    def __post_init__(self) -> None:
        if self.d_in_full == 0:
            object.__setattr__(self, "d_in_full", self.d_in)
        if self.d_out_full == 0:
            object.__setattr__(self, "d_out_full", self.d_out)


@dataclasses.dataclass(frozen=True)
class Activation:
    """Elementwise nonlinearity between packed ops (no params)."""
    fn: str
    name: str = ""


@dataclasses.dataclass(frozen=True)
class OutputHead:
    """Terminal dense + output activation. per_mask=True -> params
    {wp [Ne, d_in, d_out], bp [Ne, d_out] | b [d_out]} (input units are
    mask-gathered); else {w [d_in, d_out], b [d_out]?}."""
    name: str
    d_in: int
    d_out: int
    d_in_full: int = 0
    activation: str | None = None
    per_mask: bool = True

    def __post_init__(self) -> None:
        if self.d_in_full == 0:
            object.__setattr__(self, "d_in_full", self.d_in)


Op = SharedDense | PackedPair | Activation | OutputHead


def tree_map(fn: Callable[[torch.Tensor], torch.Tensor], tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _first_leaf(tree: Any) -> torch.Tensor:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class PackedPlan:
    """Compiled serving program: ops + packed weights + sample schedule.

    ``groups`` stacked sub-networks share the kernel sample axis (row order
    group-major: row ``g * n_masks + n``); ``out_ranges`` is the optional
    clinical conversion C(.) applied per output column.
    """
    ops: tuple[Op, ...]
    params: Params
    n_masks: int
    groups: int = 1
    schedule: sched_lib.Schedule = sched_lib.Schedule("batch")
    out_ranges: tuple[tuple[float, float], ...] | None = None
    precision: Precision = Precision()
    # fused executors built for this plan, by (spec, device, moments): a
    # new plan (``to``, ``with_precision``, ``dataclasses.replace``) starts
    # empty, so an executor never outlives the weights it packed
    _executors: dict = dataclasses.field(default_factory=dict, init=False,
                                         repr=False, compare=False)

    @property
    def sample_axis(self) -> int:
        """Rows of the kernel's sample axis (groups × masks)."""
        return self.groups * self.n_masks

    @property
    def pairs(self) -> tuple[PackedPair, ...]:
        return tuple(op for op in self.ops if isinstance(op, PackedPair))

    @property
    def device(self) -> torch.device:
        return _first_leaf(self.params).device

    def to(self, device: torch.device | str) -> "PackedPlan":
        """The same plan with its weights on ``device`` (itself if they are
        already there)."""
        if self.device == torch.device(device):
            return self
        return dataclasses.replace(
            self, params=tree_map(lambda t: t.to(device), self.params))

    def with_precision(self, precision: Precision) -> "PackedPlan":
        """The same plan (the same fp32 master weights) served at another
        precision; distinct precisions lower to distinct fused specs."""
        return dataclasses.replace(self, precision=precision)

    def slot_schedule(self, max_slots: int) -> sched_lib.SlotSchedule:
        """The serving-pool row layout this plan's sample axis maps onto."""
        return sched_lib.SlotSchedule(n_masks=self.n_masks,
                                      max_slots=max_slots)

    def traffic(self, batch: int, bytes_per_el: int = 4,
                schedule: sched_lib.Schedule | None = None, *,
                fused: bool = False, moments: bool = False
                ) -> sched_lib.TrafficModel:
        """Modeled device-memory traffic and FLOPs of one batch, from op
        metadata.

        ``fused=False``: summed pair traffic under a schedule (default: the
        plan's own) — each per-op launch reads its input and writes its
        output. ``fused=True`` prices the whole-plan kernel: every packed
        weight set crosses once per sample row (``weight_loads =
        sample_axis``) and inter-layer activations stay on chip. With
        ``moments=True`` the input batch crosses once and only (mean, std)
        come back; in samples mode the input is priced once per row and the
        full ``[N, B, d_out]`` tensor is written. Shared prefix FLOPs are
        priced once.
        """
        n = self.sample_axis
        quant = self.precision.weights == "int8"
        # int8: the matrices at 1 byte, one bf16 scale per output unit, and
        # bf16 biases; each tensor family priced at its own width
        wb = 1 if quant else bytes_per_el
        sb = 2 if quant else 0                    # scale bytes per d_out unit
        bb = 2 if quant else bytes_per_el         # bias bytes per element

        def wcost(rows: int, d_in: int, d_out: int) -> int:
            return rows * d_in * d_out * wb + rows * d_out * sb

        if not fused:
            schedule = schedule or self.schedule
            w = a = f = loads = 0
            for op in self.pairs:
                tm = sched_lib.traffic_model(schedule, batch, n, op.d_in,
                                             op.keep, op.d_out, bytes_per_el,
                                             weight_bytes_per_el=wb)
                # per load: the two matrices' scales, and the biases
                # repriced from bytes_per_el to their storage width
                w += tm.weight_bytes + tm.weight_loads * (
                    op.keep + op.d_out) * (sb + bb - bytes_per_el)
                a += tm.act_bytes
                f += tm.flops
                loads += tm.weight_loads
            return sched_lib.TrafficModel(weight_bytes=w, act_bytes=a,
                                          flops=f, weight_loads=loads)
        w_bytes = flops = 0
        d_first = d_last = None
        for op in self.ops:
            if isinstance(op, SharedDense):
                w_bytes += wcost(1, op.d_in, op.d_out) + op.d_out * bb
                flops += 2 * batch * op.d_in * op.d_out
            elif isinstance(op, PackedPair):
                w_bytes += wcost(n, op.d_in, op.keep) \
                    + wcost(n, op.keep, op.d_out) \
                    + n * (op.keep + op.d_out) * bb
                flops += 2 * n * batch * (op.d_in * op.keep
                                          + op.keep * op.d_out)
            elif isinstance(op, OutputHead):
                rows = n if op.per_mask else 1
                w_bytes += wcost(rows, op.d_in, op.d_out) \
                    + rows * op.d_out * bb
                flops += 2 * rows * batch * op.d_in * op.d_out
            else:
                continue
            if d_first is None:
                d_first = op.d_in
            d_last = op.d_out
        in_el = batch * d_first * (1 if moments else n)
        out_el = (2 * batch * self.groups * d_last if moments
                  else n * batch * d_last)
        return sched_lib.TrafficModel(
            weight_bytes=w_bytes, act_bytes=(in_el + out_el) * bytes_per_el,
            flops=flops, weight_loads=n)

    def modeled_latency(self, batch: int, *,
                        spec: latency_model.DeviceSpec = latency_model.H100,
                        packed: bool = True, batch_level: bool = True,
                        bytes_per_el: int = 2, fused: bool = False,
                        moments: bool = True) -> float:
        """Eq.-2-analogue latency (s) of one batch, summed over ops. With
        ``packed=False, batch_level=False`` this prices the conventional
        BayesNN baseline (full hidden widths, weights re-streamed per voxel
        chunk) on the same op list. ``fused=True`` prices the whole-plan
        kernel instead: one launch (one fill term) at the roofline of the
        fused traffic model; ``moments`` (fused only) selects the
        in-kernel-moments variant vs the samples mode."""
        n = self.sample_axis
        if fused:
            tm = self.traffic(batch, bytes_per_el, fused=True,
                              moments=moments)
            return max(tm.flops / spec.peak_flops,
                       tm.total_bytes / spec.hbm_bw) \
                + spec.kernel_fill_us * 1e-6
        t = 0.0
        for op in self.ops:
            if isinstance(op, PackedPair):
                t += latency_model.masked_ffn_latency(
                    batch, n, op.d_in if packed else op.d_in_full, op.hidden,
                    op.keep, op.d_out if packed else op.d_out_full,
                    packed=packed, batch_level=batch_level, spec=spec,
                    bytes_per_el=bytes_per_el)
            elif isinstance(op, SharedDense):
                t += latency_model.matmul_time(batch, op.d_in, op.d_out,
                                               spec, bytes_per_el)
            elif isinstance(op, OutputHead):
                d_in = op.d_in if packed else op.d_in_full
                per = latency_model.matmul_time(batch, d_in, op.d_out, spec,
                                                bytes_per_el)
                t += per * (n if op.per_mask else 1)
        return t


def params_from_jax(plan: PackedPlan, params: Params,
                    device: torch.device | str | None = None) -> PackedPlan:
    """``plan`` holding another copy of its parameters: ``params`` is a tree
    shaped like ``plan.params`` (numpy arrays or anything ``np.asarray``
    takes — e.g. the JAX package's compiled plan's own folded weights),
    stored as fp32 on ``device`` (None -> the card)."""
    dev = device_lib.resolve(device)

    def conv(want: torch.Tensor, a) -> torch.Tensor:
        t = torch.tensor(np.asarray(a, np.float32), device=dev)
        if t.shape != want.shape:
            raise ValueError(f"params_from_jax: shape {tuple(t.shape)}, "
                             f"the plan holds {tuple(want.shape)}")
        return t

    def walk(want, got):
        if isinstance(want, dict):
            if set(want) != set(got):
                raise ValueError(f"params_from_jax: keys {sorted(got)}, the "
                                 f"plan holds {sorted(want)}")
            return {k: walk(want[k], got[k]) for k in want}
        return conv(want, got)

    return dataclasses.replace(plan, params=walk(plan.params, params))


# ---------------------------------------------------------------------------
# BN folding
# ---------------------------------------------------------------------------


def fold_bn_dense(fc: Params, bn: Params, st: Params,
                  eps: float = 1e-5) -> Params:
    """Fold inference-mode batchnorm into the preceding dense — exact at
    eval time: returns {w', b'} with w' = w·γ/√(σ²+ε). Leaves may carry
    leading stacked axes ([G, D, D2] weights with [G, D2] statistics)."""
    inv = bn["gamma"] * torch.rsqrt(st["var"] + eps)
    return {"w": fc["w"] * inv[..., None, :],
            "b": (fc["b"] - st["mean"]) * inv + bn["beta"]}


def fold_bn_ivim(params: Params, state: Params) -> Params:
    """IVIM-shaped folding: fc1/fc2 carry bn1/bn2, all leaves stacked [G, ...]
    over sub-networks. Returns params with plain fc1/fc2 and no bn."""
    out = {k: v for k, v in params.items() if k not in ("bn1", "bn2")}
    out["fc1"] = fold_bn_dense(params["fc1"], params["bn1"], state["bn1"])
    out["fc2"] = fold_bn_dense(params["fc2"], params["bn2"], state["bn2"])
    return out


# ---------------------------------------------------------------------------
# compilers
# ---------------------------------------------------------------------------


def _per_group(fn: Callable[[torch.Tensor], torch.Tensor],
               leaf: torch.Tensor) -> torch.Tensor:
    """Apply a packer to each sub-network's slice of a stacked [G, ...] leaf
    -> [G, N, ...]."""
    return torch.stack([fn(sub) for sub in leaf])


def compile_masked_ffn(w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                       b2: torch.Tensor, masks) -> PackedPlan:
    """A bare masked relu-FFN (the masked_ffn kernel's own shape):
    relu(x @ w1 + b1) · mask[n] @ w2 + b2 -> one PackedPair."""
    idx = packing.kept_indices(masks)
    params = {"pair": {"w1p": packing.pack_out_dim(w1, idx),
                       "b1p": packing.pack_out_dim(b1, idx),
                       "w2p": packing.pack_in_dim(w2, idx),
                       "b2": b2}}
    op = PackedPair("pair", d_in=w1.shape[0], hidden=w1.shape[1],
                    keep=idx.shape[1], d_out=w2.shape[1])
    return PackedPlan(ops=(op,), params=params, n_masks=idx.shape[0])


@torch.no_grad()
def compile_ivim(cfg, params: Params, state: Params) -> PackedPlan:
    """uIVIM-NET -> PackedPlan (cfg: ``repro_torch.ivim.model.IvimConfig``).

    Folds BN, gathers the fc1 -> fc2 -> enc chain (mask1 on fc1's outputs,
    mask2 on fc2's), and flattens the 4 sub-networks onto the kernel sample
    axis: w1p [4N, Nb, K1], w2p [4N, K1, K2], wp [4N, K2, 1].
    """
    if not cfg.bayesian:
        raise ValueError("packing requires a Masksembles model")
    p = fold_bn_ivim(params, state) if cfg.use_batchnorm else params
    idx1 = packing.kept_indices(p["mask1"])
    idx2 = packing.kept_indices(p["mask2"])
    k1, k2 = idx1.shape[1], idx2.shape[1]
    groups = p["fc1"]["w"].shape[0]

    def flat(x: torch.Tensor) -> torch.Tensor:      # [G, N, ...] -> [G·N, ...]
        return x.reshape((-1,) + tuple(x.shape[2:])).detach()

    def out1(leaf):
        return packing.pack_out_dim(leaf, idx1)

    def out2(leaf):
        return packing.pack_out_dim(leaf, idx2)

    body = {"w1p": flat(_per_group(out1, p["fc1"]["w"])),   # [G·N, Nb, K1]
            "b1p": flat(_per_group(out1, p["fc1"]["b"])),   # [G·N, K1]
            "w2p": flat(_per_group(
                lambda w: packing.pack_pair_dims(w, idx1, idx2),
                p["fc2"]["w"])),                            # [G·N, K1, K2]
            "b2p": flat(_per_group(out2, p["fc2"]["b"]))}   # [G·N, K2]
    head = {"wp": flat(_per_group(
                lambda w: packing.pack_in_dim(w, idx2),
                p["enc"]["w"])),                            # [G·N, K2, 1]
            "bp": p["enc"]["b"].repeat_interleave(
                idx1.shape[0], dim=0).detach()}             # group-major
    ops = (
        PackedPair("body", d_in=cfg.width, hidden=cfg.width, keep=k1,
                   d_out=k2, d_out_full=cfg.width, activation="relu"),
        Activation("relu"),
        OutputHead("head", d_in=k2, d_in_full=cfg.width, d_out=1,
                   activation="sigmoid", per_mask=True),
    )
    return PackedPlan(ops=ops, params={"body": body, "head": head},
                      n_masks=cfg.n_masks, groups=groups,
                      out_ranges=tuple(cfg.out_ranges))


@torch.no_grad()
def compile_mlp(model) -> PackedPlan:
    """Any ``core.transform.MaskedMlp`` chain -> PackedPlan.

    Grammar: leading unmasked hidden layers become :class:`SharedDense`; a
    run of consecutive masked hidden layers packs pairwise with its
    successor (out-gather + paired in/out-gather); the final layer becomes
    an :class:`OutputHead` (in-gathered when the last hidden was masked) or
    is absorbed into the trailing pair. Chains that interleave unmasked
    hidden layers *inside* a masked run are not expressible with packed
    gathers alone and raise NotImplementedError.
    """
    spec, params = model.spec, model.params
    widths = spec.widths
    n_layers = len(widths) - 1
    ops: list[Op] = []
    plan_params: Params = {}
    cur_idx: np.ndarray | None = None
    i = 0
    head_done = False
    while i < n_layers - 1:
        layer = params[f"fc{i}"]
        if "masks" not in layer:
            if cur_idx is not None:
                raise NotImplementedError(
                    "unmasked hidden layer with mask-gathered input "
                    f"(layer {i}); reorder dropout slots to a trailing run")
            name = f"fc{i}"
            ops.append(SharedDense(name, d_in=widths[i], d_out=widths[i + 1],
                                   activation=spec.activation))
            plan_params[name] = {"w": layer["w"], "b": layer["b"]}
            i += 1
            continue
        # masked layer i pairs with its successor (hidden or output layer)
        idx = packing.kept_indices(layer["masks"])
        if cur_idx is None:
            w1p = packing.pack_out_dim(layer["w"], idx)
            d_in = widths[i]
        else:
            w1p = packing.pack_pair_dims(layer["w"], cur_idx, idx)
            d_in = cur_idx.shape[1]
        entry: Params = {"w1p": w1p,
                         "b1p": packing.pack_out_dim(layer["b"], idx)}
        nxt = params[f"fc{i + 1}"]
        if "masks" in nxt:
            nidx = packing.kept_indices(nxt["masks"])
            entry["w2p"] = packing.pack_pair_dims(nxt["w"], idx, nidx)
            entry["b2p"] = packing.pack_out_dim(nxt["b"], nidx)
            d_out, cur_idx = nidx.shape[1], nidx
        else:
            entry["w2p"] = packing.pack_in_dim(nxt["w"], idx)
            entry["b2"] = nxt["b"]
            d_out, cur_idx = widths[i + 2], None
        name = f"pair{i}"
        ops.append(PackedPair(name, d_in=d_in, d_in_full=widths[i],
                              hidden=widths[i + 1], keep=idx.shape[1],
                              d_out=d_out, d_out_full=widths[i + 2],
                              activation=spec.activation))
        plan_params[name] = entry
        if i + 1 == n_layers - 1:       # the pair consumed the output layer
            if spec.final_activation:
                ops.append(Activation(spec.final_activation))
            head_done = True
        else:
            ops.append(Activation(spec.activation))
        i += 2
    if not head_done:
        layer = params[f"fc{n_layers - 1}"]
        if cur_idx is not None:
            plan_params["head"] = {"wp": packing.pack_in_dim(layer["w"],
                                                             cur_idx),
                                   "b": layer["b"]}
            ops.append(OutputHead("head", d_in=cur_idx.shape[1],
                                  d_in_full=widths[n_layers - 1],
                                  d_out=widths[n_layers],
                                  activation=spec.final_activation,
                                  per_mask=True))
        else:
            plan_params["head"] = {"w": layer["w"], "b": layer["b"]}
            ops.append(OutputHead("head", d_in=widths[n_layers - 1],
                                  d_out=widths[n_layers],
                                  activation=spec.final_activation,
                                  per_mask=False))
    return PackedPlan(ops=tuple(ops), params=plan_params,
                      n_masks=model.n_masks)

# ---------------------------------------------------------------------------
# per-op executor
# ---------------------------------------------------------------------------


def _quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 of one weight set [.., D, K] ->
    (q int8 [.., D, K], scales bf16 [.., 1, K]): ``compression.
    quantize_int8`` along each output unit's fan-in (the columns of w).
    The values are quantized with the fp32 scale; only then is the scale
    stored as bf16. Both executors share this one quantizer."""
    q, s = compression.quantize_int8(w.transpose(-1, -2))
    return (q.transpose(-1, -2).contiguous(),
            s.transpose(-1, -2).to(torch.bfloat16).contiguous())


def _dequantized(w: torch.Tensor) -> torch.Tensor:
    """A weight round-tripped through the serving quantizer: the fp32 values
    the int8 kernels compute with, ``float(q) * float(bf16 scale)`` (exact
    in fp32)."""
    q, s = _quantize_weight(w)
    return q.float() * s.float()


def _low_bias(b: torch.Tensor) -> torch.Tensor:
    """Bias storage of the int8 serving bundle: bf16 (widened back to fp32
    at every use, which is exact)."""
    return b.to(torch.bfloat16)


#: The int8 serving form of a plan's leaves for the per-op executor, made
#: once per plan object (one per device: ``PackedPlan.to``) and reused by
#: every chunk, keyed by ``(op name, leaf, form)``.
_INT8_LEAVES: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()
_INT8_FORMS: dict[str, Callable] = {
    "q": _quantize_weight,                     # (int8 q, bf16 scales)
    "dq": _dequantized,                        # fp32, as the kernels see it
    "b": _low_bias,                            # bf16, widened by each add
}


@torch.no_grad()
def _int8_leaf(plan: PackedPlan, name: str, key: str, form: str):
    cache = _INT8_LEAVES.setdefault(plan, {})
    if (name, key, form) not in cache:
        cache[(name, key, form)] = _INT8_FORMS[form](plan.params[name][key])
    return cache[(name, key, form)]


def _weight(plan: PackedPlan, name: str, key: str) -> torch.Tensor:
    """A weight as the per-op executor multiplies by it at the plan's
    precision."""
    if plan.precision.weights == "int8":
        return _int8_leaf(plan, name, key, "dq")
    return plan.params[name][key]


def _bias(plan: PackedPlan, name: str, key: str) -> torch.Tensor:
    if plan.precision.weights == "int8":
        return _int8_leaf(plan, name, key, "b")
    return plan.params[name][key]


def _run_pair(plan: PackedPlan, op: PackedPair,
              h: torch.Tensor) -> torch.Tensor:
    """One PackedPair. A shared input [B, D] with relu goes through the
    masked_ffn kernel (b2p is added after it, as a per-sample bias) — at
    int8 with the int8 weights, their scales and bf16 biases; a per-sample
    input or another activation takes the batched-product form (same
    sample-major contraction order) over dequantized weights."""
    p, name = plan.params[op.name], op.name
    if h.ndim == 2 and op.activation == "relu":
        if plan.precision.weights == "int8":
            w1p, s1 = _int8_leaf(plan, name, "w1p", "q")
            w2p, s2 = _int8_leaf(plan, name, "w2p", "q")
            b2 = (_int8_leaf(plan, name, "b2", "b") if "b2" in p else
                  torch.zeros(w2p.shape[-1], dtype=torch.bfloat16,
                              device=h.device))
            y = mffn_ops.masked_ffn(h, w1p,
                                    _int8_leaf(plan, name, "b1p", "b"),
                                    w2p, b2, s1, s2)
        else:
            b2 = p.get("b2")
            if b2 is None:
                b2 = torch.zeros(p["w2p"].shape[-1], dtype=h.dtype,
                                 device=h.device)
            y = mffn_ops.masked_ffn(h, p["w1p"], p["b1p"], p["w2p"], b2)
        if "b2p" in p:
            y = y + _bias(plan, name, "b2p")[:, None, :]
        return y
    act = activation_fn(op.activation)
    hm = act(torch.matmul(h, _weight(plan, name, "w1p"))
             + _bias(plan, name, "b1p")[:, None, :])
    y = torch.matmul(hm, _weight(plan, name, "w2p"))
    if "b2p" in p:
        return y + _bias(plan, name, "b2p")[:, None, :]
    if "b2" in p:
        return y + _bias(plan, name, "b2")
    return y


def execute(plan: PackedPlan, x: torch.Tensor, *,
            device: torch.device | str | None = None) -> torch.Tensor:
    """Run a PackedPlan on a batch x [B, D] -> samples [N, B, d_out], one op
    at a time (one masked_ffn launch per relu PackedPair). At int8 every
    weight goes through the serving quantizer (the int8 masked_ffn body on
    the pair, dequantized weights elsewhere): the values the fused int8
    kernels compute with. ``device=None`` runs on the card."""
    dev = device_lib.resolve(device)
    plan = plan.to(dev)
    h = x.to(dev).contiguous()
    for op in plan.ops:
        if isinstance(op, Activation):
            h = activation_fn(op.fn)(h)
        elif isinstance(op, SharedDense):
            p = plan.params[op.name]
            h = h @ _weight(plan, op.name, "w")
            if "b" in p:
                h = h + _bias(plan, op.name, "b")
            if op.activation:
                h = activation_fn(op.activation)(h)
        elif isinstance(op, PackedPair):
            h = _run_pair(plan, op, h)
        elif isinstance(op, OutputHead):
            p = plan.params[op.name]
            if op.per_mask:
                h = torch.matmul(h, _weight(plan, op.name, "wp"))
                if "bp" in p:
                    h = h + _bias(plan, op.name, "bp")[:, None, :]
            else:
                h = h @ _weight(plan, op.name, "w")
            if "b" in p:
                h = h + _bias(plan, op.name, "b")
            if op.activation:
                h = activation_fn(op.activation)(h)
        else:
            raise TypeError(f"unknown plan op {op!r}")
    if h.ndim == 2:                     # no packed ops: one degenerate sample
        h = h[None]
    return _finalize(plan, h)


def _c_range(plan: PackedPlan, like: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """C(.)'s (lo, hi) rows on ``like``'s device."""
    return _range_rows(plan.out_ranges, like.device, like.dtype)


@functools.lru_cache(maxsize=16)
def _range_rows(out_ranges: tuple[tuple[float, float], ...],
                device: torch.device, dtype: torch.dtype
                ) -> tuple[torch.Tensor, torch.Tensor]:
    # Made once per (ranges, device): building them per chunk would put two
    # blocking host-to-card copies on every chunk of a streamed volume.
    lo = torch.tensor([r[0] for r in out_ranges], dtype=dtype, device=device)
    hi = torch.tensor([r[1] for r in out_ranges], dtype=dtype, device=device)
    return lo, hi


def _finalize(plan: PackedPlan, h: torch.Tensor) -> torch.Tensor:
    """Executor epilogue: un-flatten the kernel sample axis and apply C(.)."""
    if plan.groups > 1:                 # [G·N, B, Do] -> [N, B, G·Do]
        g, n = plan.groups, plan.n_masks
        b, do = h.shape[1], h.shape[2]
        h = h.reshape(g, n, b, do).movedim(0, 2).reshape(n, b, g * do)
    if plan.out_ranges is not None:     # C(.): clinical range conversion
        lo, hi = _c_range(plan, h)
        h = lo + h * (hi - lo)
    return h


# ---------------------------------------------------------------------------
# fused whole-plan executor (kernels/fused_plan)
# ---------------------------------------------------------------------------


def lower_fused(plan: PackedPlan
                ) -> tuple[fused_ref.FusedSpec, tuple[torch.Tensor, ...]]:
    """Lower the op chain to the fused kernel IR: ``(spec, params)`` with
    params in ``param_slots`` order. A trailing :class:`Activation` fuses
    into the preceding dense step; a PackedPair lowers to two dense steps
    (its hidden activation stays on chip). Raises
    :class:`FusedPlanUnsupported` for op kinds with no fused form.

    At ``Precision("int8")`` every dense weight is quantized here, once per
    lowering: the int8 ``w`` and its bf16 per-output-channel scale ``ws``
    are what the kernels read, and biases are stored as bf16. The fp32
    default hands over the master tensors themselves and a scale-free
    spec."""
    steps: list[fused_ref.FusedStep] = []
    params: list[torch.Tensor] = []
    for op in plan.ops:
        if isinstance(op, Activation):
            if steps and steps[-1].kind == "dense" \
                    and steps[-1].activation is None:
                steps[-1] = dataclasses.replace(steps[-1], activation=op.fn)
            else:
                steps.append(fused_ref.FusedStep("act", activation=op.fn))
            continue
        p = plan.params.get(getattr(op, "name", ""))
        if isinstance(op, SharedDense):
            steps.append(fused_ref.FusedStep(
                "dense", op.activation, shared_bias="b" in p,
                d_in=op.d_in, d_out=op.d_out))
            params += [p["w"]] + ([p["b"]] if "b" in p else [])
        elif isinstance(op, PackedPair):
            steps.append(fused_ref.FusedStep(
                "dense", op.activation, per_sample=True, sample_bias=True,
                d_in=op.d_in, d_out=op.keep))
            params += [p["w1p"], p["b1p"]]
            steps.append(fused_ref.FusedStep(
                "dense", None, per_sample=True, shared_bias="b2" in p,
                sample_bias="b2p" in p, d_in=op.keep, d_out=op.d_out))
            params += [p[k] for k in ("w2p", "b2", "b2p") if k in p]
        elif isinstance(op, OutputHead):
            steps.append(fused_ref.FusedStep(
                "dense", op.activation, per_sample=op.per_mask,
                shared_bias="b" in p, sample_bias="bp" in p,
                d_in=op.d_in, d_out=op.d_out))
            params.append(p["wp"] if op.per_mask else p["w"])
            params += [p[k] for k in ("b", "bp") if k in p]
        else:
            raise FusedPlanUnsupported(f"op {op!r} has no fused lowering")
    if plan.precision.weights == "int8":
        steps, params = _quantize_lowering(steps, params)
    dense = [s for s in steps if s.kind == "dense"]
    if not dense:
        raise FusedPlanUnsupported("fused chain has no dense step")
    spec = fused_ref.FusedSpec(steps=tuple(steps), n_rows=plan.sample_axis,
                               n_masks=plan.n_masks, groups=plan.groups,
                               d_in=dense[0].d_in, d_out=dense[-1].d_out)
    return spec, tuple(params)


@torch.no_grad()
def _quantize_lowering(steps: list, params: list) -> tuple[list, list]:
    """A lowered chain rewritten to the int8 serving bundle: each dense
    step's ``w`` becomes (int8 q, bf16 scale), the step is tagged
    ``w_dtype="int8"`` (``param_slots`` then emits its 'ws' slot after 'w'),
    and its biases are stored as bf16."""
    new_steps: list = []
    new_params: list = []
    it = iter(params)
    for st in steps:
        if st.kind != "dense":
            new_steps.append(st)
            continue
        new_steps.append(dataclasses.replace(st, w_dtype="int8"))
        new_params += _quantize_weight(next(it))
        for _ in range(int(st.shared_bias) + int(st.sample_bias)):
            new_params.append(_low_bias(next(it)))
    return new_steps, new_params


#: What the serving layer builds once and reuses, one count per cache miss,
#: keyed by kind and config: ``("step_fns", cfg, ...)`` (serving.server),
#: ``("decode", cfg, ...)`` (:func:`compile_decode_step`), ``("prefill",
#: cfg, ..., bucket, max_seq)`` (:func:`compile_prefill_step`) and
#: ``("plan", spec, ...)`` (:func:`fused_executor`). The port's twin of the
#: reference's ``retrace_total``: a warm serving loop leaves it flat.
build_counts = obs_registry.REGISTRY.keyed_counter(
    "step_builds_total",
    "serving steps and executors built (cache misses), by kind and config")


def fused_executor(plan: PackedPlan, *, moments: bool = False,
                   device: torch.device | str | None = None
                   ) -> Callable[[torch.Tensor], Any]:
    """Lower once, serve many: returns ``x -> fused result``.

    The plan is lowered on every call (which raises
    :class:`FusedPlanUnsupported` immediately when the op chain has no
    fused lowering); the packed parameter buffer and the executor are built
    once per (plan, spec, device, mode) and reused. The kernel's
    shared-memory residency guard fires later, from the first ``apply`` on
    a CUDA tensor — callers that want the per-op fallback catch around that
    first call too.
    """
    dev = device_lib.resolve(device)
    plan = plan.to(dev)
    spec, params = lower_fused(plan)
    key = (spec, dev, moments)
    apply = plan._executors.get(key)
    if apply is not None:
        return apply
    fp = fp_ops.pack(spec, params)
    build_counts[("plan",) + key] += 1

    def apply(x: torch.Tensor):
        x = x.to(dev).contiguous()
        if not moments:
            return _finalize(plan, fp_ops.fused_samples(fp, x))
        mean, std = fp_ops.fused_moments(fp, x)   # [B, G·do], group-major
        if plan.out_ranges is not None:  # C(.) is affine: commutes with E[.]
            lo, hi = _c_range(plan, mean)
            mean = lo + mean * (hi - lo)
            std = std * (hi - lo).abs()
        return mean, std

    plan._executors[key] = apply
    return apply


def execute_fused(plan: PackedPlan, x: torch.Tensor, *, moments: bool = False,
                  device: torch.device | str | None = None):
    """Run the whole plan in ONE kernel launch (kernels/fused_plan).

    x [B, D] -> samples [N, B, d_out], or ``moments=True`` ->
    (mean [B, d_out], std [B, d_out]) reduced over the mask axis inside the
    kernel (running Welford mean/M2), so the full sample tensor is never
    materialized. Matches ``execute`` / ``uncertainty.predictive_moments(
    execute(...))`` to fp32 tolerance. Raises :class:`FusedPlanUnsupported`
    when the plan has no fused form or its per-row footprint exceeds the
    shared-memory guard (callers fall back to :func:`execute`).
    """
    return fused_executor(plan, moments=moments, device=device)(x)


# ---------------------------------------------------------------------------
# transformer FFN serving leaves (mask-zero skipping)
# ---------------------------------------------------------------------------


@torch.no_grad()
def pack_ffn_leaves(ffn: Params, masks) -> Params:
    """Transformer FFN block params {wg?, wu, wd} (leaves optionally stacked
    [R, ...] over repeats) + masks [N, F] -> packed serving leaves
    {wgp?, wup [.., N, D, K], wdp [.., N, K, D]} — the form
    ``models.layers.ffn_apply`` runs through :func:`ffn_leaves_apply`."""
    idx = packing.kept_indices(torch.as_tensor(masks).float())

    def out_g(w: torch.Tensor) -> torch.Tensor:    # [.., D, F] -> [.., N, D, K]
        return packing.gather_units(w, idx, axis=-1).movedim(0, -3) \
            .contiguous()

    def in_g(w: torch.Tensor) -> torch.Tensor:     # [.., F, D] -> [.., N, K, D]
        return packing.gather_units(w, idx, axis=-2).movedim(0, -3) \
            .contiguous()

    out = {"wup": out_g(ffn["wu"]["w"]), "wdp": in_g(ffn["wd"]["w"])}
    if "wg" in ffn:
        out["wgp"] = out_g(ffn["wg"]["w"])
    return out


def ffn_leaves_apply(p: Params, x: torch.Tensor, activation: str
                     ) -> torch.Tensor:
    """Packed transformer-FFN leaves on x [B, S, D] with rows grouped
    mask-major (row j uses mask j // (B/N)) -> same shape. The gated form
    (wgp present) is silu/gelu-gated; the hidden width is the kept K."""
    act = activation_fn(activation)
    n = p["wdp"].shape[0]
    b = x.shape[0]
    if b % n != 0:
        raise ValueError(
            f"ffn_leaves_apply: batch rows {b} not divisible by the "
            f"packed mask count {n} — rows must be grouped mask-major")
    xg = x.reshape(n, b // n, *x.shape[1:])        # [N, B/N, S, D]
    if "wgp" in p:
        h = act(torch.einsum("nbsd,ndk->nbsk", xg, p["wgp"])) * \
            torch.einsum("nbsd,ndk->nbsk", xg, p["wup"])
    else:
        h = act(torch.einsum("nbsd,ndk->nbsk", xg, p["wup"]))
    y = torch.einsum("nbsk,nkd->nbsd", h, p["wdp"])
    return y.reshape(x.shape)


# ---------------------------------------------------------------------------
# fused serving-decode step (kernels/fused_decode)
# ---------------------------------------------------------------------------
#
# One serving decode step of the whole mask-expanded slot pool — KV gather,
# attention over the slot-pool cache, the (packed) Bayesian FFN and the
# Welford posterior — lowered onto the FusedStep vocabulary and run as ONE
# kernel launch. serving/server.step_fns routes its decode hot loop through
# compile_decode_step, with the per-op transformer.decode_step path as the
# FusedPlanUnsupported fallback.


def lower_fused_decode(cfg, *, expand_masks: bool = True
                       ) -> fused_ref.FusedDecodeSpec:
    """Lower a ModelConfig's serving decode step to the fused decode IR:
    ``(norm, attn, norm, ffn) × L + (final norm, lm-head dense)``, segments
    flattened rep-major. Raises :class:`FusedPlanUnsupported` for configs
    with no fused decode form (non-causal, M-RoPE, int8 KV, or any block
    kind other than attn/local_attn)."""
    if not cfg.causal:
        raise FusedPlanUnsupported("encoder-only config has no decode step")
    if cfg.m_rope_sections:
        raise FusedPlanUnsupported("M-RoPE decode has no fused lowering")
    if cfg.kv_dtype == "int8":
        raise FusedPlanUnsupported(
            "int8 KV cache has no fused decode lowering")
    d, dh = cfg.d_model, cfg.resolved_head_dim
    rot = int(dh * cfg.rope_pct)
    rot -= rot % 2
    bayes = cfg.bayesian and expand_masks
    n = cfg.mask_samples if bayes else 1
    packed = cfg.bayesian and cfg.packed_ffn_serving
    gated = cfg.activation in ("silu", "gelu")
    ln_bias = cfg.norm == "layernorm"
    d_hidden = (masks_lib.keep_count(cfg.d_ff, cfg.mask_samples,
                                     cfg.mask_scale) if packed else cfg.d_ff)
    norm = fused_ref.FusedStep("norm", norm=cfg.norm, shared_bias=ln_bias,
                               d_in=d, d_out=d)
    steps: list[fused_ref.FusedStep] = []
    for seg in cfg.segments():
        for kind in seg.pattern:
            if kind not in ("attn", "local_attn"):
                raise FusedPlanUnsupported(
                    f"block kind {kind!r} has no fused decode lowering")
        for _ in range(seg.reps):
            for kind in seg.pattern:
                steps.append(norm)
                steps.append(fused_ref.FusedStep(
                    "attn", d_in=d, d_out=d, n_heads=cfg.n_heads,
                    n_kv_heads=cfg.n_kv_heads, head_dim=dh, rot_dim=rot,
                    qkv_bias=cfg.qkv_bias,
                    window=cfg.local_window if kind == "local_attn" else 0))
                steps.append(norm)
                steps.append(fused_ref.FusedStep(
                    "ffn", activation=cfg.activation, gated=gated,
                    per_sample=packed, masked=cfg.bayesian and not packed,
                    ffn_bias=not gated and not packed, d_hidden=d_hidden,
                    d_in=d, d_out=d))
    steps.append(norm)
    steps.append(fused_ref.FusedStep("dense", d_in=d, d_out=cfg.vocab_size))
    return fused_ref.FusedDecodeSpec(steps=tuple(steps), n_samples=n,
                                     d_model=d, vocab=cfg.vocab_size,
                                     kv_dtype=cfg.kv_dtype)


def _decode_mask_ids(cfg, rows: int, expand_masks: bool,
                     device) -> torch.Tensor:
    """Per-row mask assignment of the decode pool — the ids the per-op path
    uses (mask-major groups when expanded, the Masksembles batch-group
    default otherwise)."""
    n = cfg.mask_samples
    if expand_masks:
        return torch.arange(n, device=device).repeat_interleave(rows // n)
    return masksembles.mask_ids_for_batch(rows, n, device=device)


def _decode_flat_params(spec: fused_ref.FusedDecodeSpec, cfg, params: Params,
                        rows: int, expand_masks: bool
                        ) -> tuple[torch.Tensor, ...]:
    """Flatten the transformer param tree into ``decode_param_slots`` order
    (stacked leaves sliced per repeat; the Bayesian mask matrix gathered
    per row). Every tensor is contiguous: the kernel reads them in place,
    so a tied LM head is handed over as a contiguous copy of ``embed.T``
    ([d, V]; the runner keeps it with the rest of the flattened tuple)."""
    flat: list[torch.Tensor] = []

    def push_norm(p):
        flat.append(p["scale"])
        if "bias" in p:
            flat.append(p["bias"])

    for si, seg in enumerate(cfg.segments()):
        seg_params = params["segments"][si]
        for r in range(seg.reps):
            for bi in range(len(seg.pattern)):
                block = tree_map(lambda a, r=r: a[r], seg_params[f"b{bi}"])
                push_norm(block["norm1"])
                at = block["attn"]
                for w in ("wq", "wk", "wv"):
                    flat.append(at[w]["w"])
                    if "b" in at[w]:
                        flat.append(at[w]["b"])
                flat.append(at["wo"]["w"])
                push_norm(block["norm2"])
                ffn = block["ffn"]
                if "wdp" in ffn:                    # packed serving leaves
                    if "wgp" in ffn:
                        flat.append(ffn["wgp"])
                    flat += [ffn["wup"], ffn["wdp"]]
                else:
                    if "wg" in ffn:
                        flat.append(ffn["wg"]["w"])
                    flat.append(ffn["wu"]["w"])
                    if "b" in ffn["wu"]:
                        flat.append(ffn["wu"]["b"])
                    flat.append(ffn["wd"]["w"])
                    if "b" in ffn["wd"]:
                        flat.append(ffn["wd"]["b"])
                    if "masks" in ffn:
                        ids = _decode_mask_ids(cfg, rows, expand_masks,
                                               ffn["masks"].device)
                        flat.append(ffn["masks"][ids])
    push_norm(params["final_norm"])
    emb = params["embed"]
    flat.append(emb["unembed"]["w"] if "unembed" in emb
                else emb["embed"].T.contiguous())
    want = len(fused_ref.decode_param_slots(spec))
    if len(flat) != want:
        raise FusedPlanUnsupported(
            f"param tree does not match the lowered decode spec "
            f"({len(flat)} arrays vs {want} slots)")
    return tuple(flat)


def _decode_flat_caches(cfg, caches) -> tuple[torch.Tensor, ...]:
    """Flatten pooled KV caches to ``(k, v, kpos)`` per 'attn' step, in the
    lowering's rep-major step order (views, no copies)."""
    flat: list[torch.Tensor] = []
    for si, seg in enumerate(cfg.segments()):
        for r in range(seg.reps):
            for bi in range(len(seg.pattern)):
                c = caches[si][f"b{bi}"]
                flat += [c["k"][r], c["v"][r], c["kpos"][r]]
    return tuple(flat)


def _decode_commit_caches(cfg, caches, knew: torch.Tensor,
                          vnew: torch.Tensor, pos: torch.Tensor):
    """Commit the kernel's fresh per-layer k/v [L, R, hkv, dh] into the
    pooled caches with ``layers.kv_cache_update``'s slot formula and cast,
    one indexed write per segment block over all its repeats. Functional,
    like the per-op path: the caches passed in are left as they were."""
    out = []
    ai = 0
    rows = knew.shape[1]
    for si, seg in enumerate(cfg.segments()):
        new_seg = {}
        width = len(seg.pattern)
        for bi, kind in enumerate(seg.pattern):
            c = caches[si][f"b{bi}"]
            smax = c["k"].shape[3]
            window = cfg.local_window if kind == "local_attn" else 0
            p64 = pos.to(torch.int64)
            slot = ((p64 % window) if window else p64) % smax       # [R]
            layer = ai + bi + width * torch.arange(seg.reps,
                                                   device=knew.device)
            reps = torch.arange(seg.reps, device=knew.device)[:, None]
            bidx = torch.arange(rows, device=knew.device)[None, :]
            k, v, kpos = c["k"].clone(), c["v"].clone(), c["kpos"].clone()
            k[reps, bidx, :, slot[None, :]] = knew[layer].to(k.dtype)
            v[reps, bidx, :, slot[None, :]] = vnew[layer].to(v.dtype)
            kpos[reps, bidx, slot[None, :]] = pos.to(torch.int32)[None, :]
            new_seg[f"b{bi}"] = {"k": k, "v": v, "kpos": kpos}
        ai += width * seg.reps
        out.append(new_seg)
    return out


@functools.lru_cache(maxsize=64)
def _decode_runner(cfg, expand_masks: bool, device: torch.device):
    """One decode-step executor per (config, expansion, device). The
    flattened parameter tuple is kept for the last ``params`` tree seen
    (an identity check), so a serving loop flattens once, not per step."""
    spec = lower_fused_decode(cfg, expand_masks=expand_masks)
    rot = next(s.rot_dim for s in spec.steps if s.kind == "attn")
    last: dict[str, Any] = {}
    build_counts[("decode", cfg, expand_masks, device)] += 1

    @torch.no_grad()
    def run(params, caches, tokens, pos):
        from repro_torch.models import layers
        tokens = tokens.to(device)
        rows = tokens.shape[0]
        pos_r = torch.as_tensor(pos, dtype=torch.int32, device=device)
        if pos_r.ndim == 0:
            pos_r = pos_r.expand(rows).contiguous()
        if last.get("params") is not params or last.get("rows") != rows:
            last.update(params=params, rows=rows, flat=_decode_flat_params(
                spec, cfg, params, rows, expand_masks))
        x = layers.embed_tokens(params["embed"], tokens[:, 0])
        cos, sin = layers.rope_cos_sin(pos_r, rot, cfg.rope_theta)
        fc = _decode_flat_caches(cfg, caches)
        mean, rel, knew, vnew = fd_ops.fused_decode(
            spec, x, last["flat"], fc, pos_r, cos, sin)
        return mean, rel, _decode_commit_caches(cfg, caches, knew, vnew,
                                                pos_r)

    return run


def compile_decode_step(cfg, *, expand_masks: bool = True,
                        device: torch.device | str | None = None
                        ) -> Callable:
    """Lower once, decode many: the fused serving decode step of ``cfg`` as
    a cached executor ``(params, caches, tokens [R,1], pos) ->
    (mean_logp [b, V], rel_unc [b], new_caches)`` on ``device`` (None ->
    the card).

    ``pos`` is a scalar or per-row ``[R]`` vector; rows are mask-major
    (``expand_masks=True``: row ``r`` is mask ``r // b``). Raises
    :class:`FusedPlanUnsupported` immediately when the config has no fused
    decode lowering; the kernel wrapper's own limits fire from the first
    call (``serving.server.step_fns`` catches around it)."""
    dev = device_lib.resolve(device)
    return _decode_runner(cfg, bool(expand_masks), dev)


def decode_fused_spec(cfg, *, expand_masks: bool = True
                      ) -> fused_ref.FusedDecodeSpec:
    """Static shape-key of the fused decode executor."""
    return lower_fused_decode(cfg, expand_masks=expand_masks)


# ---------------------------------------------------------------------------
# bucketed prefill
# ---------------------------------------------------------------------------
#
# The bucketed form zero-pads the prompt to one of a small set of length
# buckets (powers of two up to max_seq, plus max_seq) and runs the prefill at
# the bucket length: the last-token logits are gathered at length-1 (causal
# attention makes that position blind to the pad tail) and the pad tail's
# cache entries are trimmed back to the init state — equal to an
# exact-length prefill. Support is gated through the fused decode lowering
# (lower_fused_decode + check_prefill_paddable).


@functools.lru_cache(maxsize=None)
def prefill_buckets(max_seq: int,
                    buckets: tuple[int, ...] | None = None
                    ) -> tuple[int, ...]:
    """Resolve the prefill length-bucket set against a cache capacity:
    ``None`` -> powers of two below ``max_seq`` plus ``max_seq``; an
    explicit set is validated, sorted, deduplicated and capped."""
    if max_seq < 1:
        raise ValueError(f"max_seq {max_seq} < 1")
    if buckets is None:
        out, b = [], 1
        while b < max_seq:
            out.append(b)
            b <<= 1
        out.append(max_seq)
        return tuple(sorted(set(out)))
    vals = tuple(int(b) for b in buckets)
    if not vals:
        raise ValueError("empty prefill bucket set (use None for the "
                         "power-of-two default, or () upstream to disable "
                         "bucketing)")
    if any(b < 1 for b in vals):
        raise ValueError(f"non-positive prefill bucket in {vals}")
    return tuple(sorted({b for b in vals if b <= max_seq}))


def prefill_bucket(length: int, max_seq: int,
                   buckets: tuple[int, ...] | None = None) -> int | None:
    """Smallest bucket >= ``length`` (None when no bucket covers it)."""
    for b in prefill_buckets(max_seq, buckets):
        if b >= length:
            return b
    return None


def prefill_fused_spec(cfg, *, expand_masks: bool = True
                       ) -> fused_ref.FusedDecodeSpec:
    """Static shape-key of the bucketed prefill, and its support gate:
    raises :class:`FusedPlanUnsupported` when padded-bucket prefill would
    not be exact for ``cfg``."""
    return fused_ref.check_prefill_paddable(
        lower_fused_decode(cfg, expand_masks=expand_masks))


@functools.lru_cache(maxsize=256)
def _prefill_runner(cfg, expand_masks: bool, bucket: int, max_seq: int):
    prefill_fused_spec(cfg, expand_masks=expand_masks)
    bayes = cfg.bayesian and expand_masks
    n = cfg.mask_samples if bayes else 1
    build_counts[("prefill", cfg, expand_masks, bucket, max_seq)] += 1

    @torch.no_grad()
    def run(params, tokens, length: int):
        from repro_torch.models import transformer
        rows = tokens.shape[0]
        ids = (torch.arange(n, device=tokens.device)
               .repeat_interleave(rows // n) if bayes else None)
        logits, caches = transformer.prefill(
            cfg, params, {"tokens": tokens}, max_seq=max_seq,
            mask_ids=ids, last_index=length - 1)
        caches = transformer.cache_trim_positions(caches, length)
        mean, rel = unc_lib.token_posterior(logits, n)
        return mean, rel, caches

    return run


def compile_prefill_step(cfg, bucket: int, max_seq: int, *,
                         expand_masks: bool = True) -> Callable:
    """The bucketed prefill of ``cfg`` at one length bucket:
    ``(params, tokens [R, bucket], length) -> (mean_logp [b, V],
    rel_unc [b], caches)``, with ``tokens`` the prompt zero-padded to
    ``bucket`` columns and ``length`` its true length."""
    if not 1 <= bucket <= max_seq:
        raise ValueError(f"bucket {bucket} outside [1, max_seq={max_seq}]")
    return _prefill_runner(cfg, bool(expand_masks), int(bucket),
                           int(max_seq))


# ---------------------------------------------------------------------------
# decode-step pricing
# ---------------------------------------------------------------------------


def decode_stage_traffic(spec: fused_ref.FusedDecodeSpec, rows: int,
                         max_seq: int, bytes_per_el: int = 2, *,
                         fused: bool = True
                         ) -> dict[str, sched_lib.TrafficModel]:
    """Per-stage split of :func:`decode_traffic`: one TrafficModel per step
    kind (``norm``/``attn``/``ffn``/``dense`` — attn includes its KV-cache
    bytes) plus ``interstage`` (activations between launches, and the launch
    count). Weights priced at ``bytes_per_el``, KV rows at the spec's
    ``kv_dtype`` width (int8 adds its fp32 scale per cached vector),
    ``kpos`` at 4 bytes."""
    d, v, n = spec.d_model, spec.vocab, spec.n_samples
    b = rows // n
    kv_b = {"bfloat16": 2, "int8": 1}.get(spec.kv_dtype, bytes_per_el)
    acc: dict[str, list[int]] = {}

    def add(kind: str, w: int = 0, kv: int = 0, pos: int = 0,
            scale: int = 0, fl: int = 0) -> None:
        cur = acc.setdefault(kind, [0, 0, 0, 0, 0])
        for j, inc in enumerate((w, kv, pos, scale, fl)):
            cur[j] += inc

    layers_l = 0
    for st in spec.steps:
        if st.kind == "norm":
            add("norm", w=d * (2 if st.shared_bias else 1))
        elif st.kind == "attn":
            hh, hkv, dh = st.n_heads, st.n_kv_heads, st.head_dim
            smax = min(st.window, max_seq) if st.window else max_seq
            proj = d * hh * dh + 2 * d * hkv * dh + hh * dh * d
            if st.qkv_bias:
                proj += hh * dh + 2 * hkv * dh
            add("attn", w=proj,
                kv=rows * hkv * smax * dh * 2 + rows * hkv * dh * 2,
                pos=rows * smax + rows,
                scale=(rows * hkv * smax + rows * hkv
                       if spec.kv_dtype == "int8" else 0),
                fl=2 * rows * proj + 4 * rows * hh * dh * (smax + 1))
            layers_l += 1
        elif st.kind == "ffn":
            mats = 3 if st.gated else 2
            if st.per_sample:
                add("ffn", w=n * mats * d * st.d_hidden,
                    fl=2 * rows * mats * d * st.d_hidden)
            else:
                w = mats * d * st.d_hidden \
                    + (st.d_hidden + d if st.ffn_bias else 0)
                if st.masked:
                    w += n * st.d_hidden
                add("ffn", w=w, fl=2 * rows * mats * d * st.d_hidden)
        elif st.kind == "dense":
            add("dense",
                w=st.d_in * st.d_out + (st.d_out if st.shared_bias else 0),
                fl=2 * rows * st.d_in * st.d_out)
        elif st.kind != "act":
            raise ValueError(f"decode_stage_traffic: unpriced step kind "
                             f"{st.kind!r}")
    if fused:
        act_el = rows * d + b * v + b
        launches = 1
    else:
        act_el = layers_l * 4 * rows * d + rows * d + 2 * rows * v \
            + b * v + b
        launches = 2 * layers_l + 2
    out = {kind: sched_lib.TrafficModel(
        weight_bytes=w * bytes_per_el + kv * kv_b + pos * 4 + scale * 4,
        act_bytes=0, flops=fl, weight_loads=0)
        for kind, (w, kv, pos, scale, fl) in acc.items()}
    out["interstage"] = sched_lib.TrafficModel(
        weight_bytes=0, act_bytes=act_el * bytes_per_el, flops=0,
        weight_loads=launches)
    return out


def decode_traffic(spec: fused_ref.FusedDecodeSpec, rows: int, max_seq: int,
                   bytes_per_el: int = 2, *, fused: bool = True
                   ) -> sched_lib.TrafficModel:
    """Modeled device-memory traffic and FLOPs of ONE pool decode step,
    priced from the spec (the sum of :func:`decode_stage_traffic`)."""
    stages = decode_stage_traffic(spec, rows, max_seq, bytes_per_el,
                                  fused=fused)
    return sched_lib.TrafficModel(
        weight_bytes=sum(t.weight_bytes for t in stages.values()),
        act_bytes=sum(t.act_bytes for t in stages.values()),
        flops=sum(t.flops for t in stages.values()),
        weight_loads=sum(t.weight_loads for t in stages.values()))
