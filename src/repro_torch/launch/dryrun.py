"""Multi-pod dry-run of the port (the twin of ``repro.launch.dryrun``), in
one process: every (arch x shape) cell's own step run once on the
production mesh, on shapes alone.

Per cell:
  * a ``fake`` process group of 256 ranks (512 with ``--multi-pod``) in
    this process, this process being rank 0, and the production mesh over
    it (``launch.mesh.make_production_mesh``: (16, 16) ``("data",
    "model")`` or (2, 16, 16) ``("pod", "data", "model")``);
  * the cell's train state, or its parameters and caches, as ``meta``
    DTensors laid out by ``distributed.sharding`` (``param_shardings``,
    ``batch_shardings``, ``cache_shardings``): nothing is allocated;
  * the port's own ``train.make_train_step``, ``Model.prefill`` or
    ``Model.decode_step`` run once on them, under the ambient mesh, as a
    user would call them (no kernel launches: the kernel wrappers take
    their plain versions on ``meta`` tensors, and the plain versions'
    products are what is counted);
  * ``memory_analytic``: resident bytes of rank 0 summed from its local
    shard shapes, plus the reference's modeled activation terms;
  * ``cost``: per-device FLOPs and bytes counted over each operation's
    *local* operands (:class:`LocalCosts`, under DTensor's dispatch).
    FLOPs are the matrix products' (``torch.utils.flop_counter``'s
    registry); bytes are each non-view operation's inputs read once plus
    its outputs written once, unfused (a fusing compiler moves fewer).
    ``FlopCounterMode`` cannot be used: it sees each operation at the
    DTensor level and counts the global product, 256 times a device's;
  * ``collectives``: per-device output bytes of the functional
    collectives DTensor issues, by kind (all-reduce counted once, as the
    reference counts it);
  * ``roofline``: the three terms priced by ``core.latency_model.
    roofline_terms`` on the ``H100`` spec, with ``model_flops_*`` (6ND
    train, 2ND prefill, 2NB decode; N = active parameters) and
    ``useful_flops_ratio``.

Left out of the reference's result: the compiler's ``memory_analysis``
(no compiler runs here), the scan-body probes and their extrapolation (the
reference's HLO counts a loop body once, so it fits unrolled probes; here
eager execution runs every layer and every attention chunk, so the counts
are whole), and ``--hlo-dump`` (there is no HLO). Where the reference
names the TPU's 16 GB (``fits_16gb_*``), the result names the H100's
80 GB (``fits_h100_80gb_analytic``).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k \
      [--multi-pod] [--bayesian N] [--out results/...json] \
      [--override key=value ...]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.configs.base import SHAPES
from repro_torch.configs.cells import skip_reason
from repro_torch.configs.registry import get_config
from repro_torch.core import tree as tree_lib
from repro_torch.core.latency_model import H100, roofline_terms
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.model import build_model
from repro_torch.optim import OptimizerConfig, build_optimizer
from repro_torch.train import TrainConfig, make_train_step, train_state_specs

__all__ = ["LocalCosts", "fake_world", "pick_optimizer", "model_flops",
           "sharded_bytes", "analytic_memory", "trace_cell", "run_cell",
           "main", "COLLECTIVES"]

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
#: Functional-collective op names (``_c10d_functional``) -> the kind.
_COLLECTIVE_OPS = {"all_gather_into_tensor": "all-gather",
                   "all_gather_into_tensor_coalesced": "all-gather",
                   "all_reduce": "all-reduce",
                   "all_reduce_coalesced": "all-reduce",
                   "reduce_scatter_tensor": "reduce-scatter",
                   "reduce_scatter_tensor_coalesced": "reduce-scatter",
                   "all_to_all_single": "all-to-all",
                   "broadcast": "collective-permute"}
#: Operations that move no data (their outputs are uninitialised).
_NO_BYTES = ("empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided")


def _tensor_bytes(tree) -> int:
    leaves, _ = tree_flatten(tree)
    return sum(t.numel() * t.element_size() for t in leaves
               if isinstance(t, torch.Tensor))


class LocalCosts(TorchDispatchMode):
    """Per-device costs of what runs inside it: an operation on DTensors is
    handed to DTensor (``NotImplemented``), which runs it on each rank's
    local shards, and those local operations — and the collectives DTensor
    issues — are what this mode counts. ``flops``: matrix-product FLOPs of
    the local operands; ``bytes``: inputs read plus outputs written of each
    non-view operation; ``collectives``: output bytes by kind."""

    def __init__(self) -> None:
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collectives = dict.fromkeys(COLLECTIVES, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types) or isinstance(
                out, FakeTensor):
            # DTensor's sharding propagation deriving an output's global
            # shape on fake tensors: no device runs it
            return out
        packet = getattr(func, "_overloadpacket", None)
        ns = getattr(func, "namespace", "")
        name = getattr(packet, "__name__", "").split(".")[-1]
        if ns in ("_c10d_functional", "c10d_functional"):
            kind = _COLLECTIVE_OPS.get(name)
            if kind:
                self.collectives[kind] += _tensor_bytes(out)
            return out
        if getattr(func, "is_view", False) or name in _NO_BYTES:
            return out
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        self.bytes += _tensor_bytes((args, kwargs)) + _tensor_bytes(out)
        return out


@contextlib.contextmanager
def fake_world(world_size: int):
    """A ``fake`` default process group of ``world_size`` ranks for the
    block (``launch.mesh.init_fake_world``), destroyed after it."""
    mesh_lib.init_fake_world(world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def pick_optimizer(cfg) -> OptimizerConfig:
    """Adafactor above ~40B parameters, without the global-norm clip (the
    reference's choice: Adam's fp32 moments would not fit the device
    budget for arctic and qwen2-vl-72b); AdamW below."""
    if cfg.param_count() > 40e9:
        return OptimizerConfig(name="adafactor", clip_norm=0.0)
    return OptimizerConfig(name="adamw")


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS: 6*N*D train (fwd+bwd), 2*N*D prefill, 2*N*B decode;
    N = active params for MoE."""
    n = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6 if shape.kind == "train" else 2
    return float(mult) * n * tokens


def _shard_numel(shape: tuple, spec: tuple, sizes: dict) -> int:
    n = 1
    for i, d in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        split = 1
        for a in axes:
            split *= sizes[a]
        n *= -(-d // split)
    return n


def sharded_bytes(specs, shardings) -> int:
    """Resident bytes on one device of a tree of tensors (``meta`` or real)
    under its tree of ``sharding.NamedSharding``: each leaf's local shard
    shape times its element size (the reference's ``_sharded_bytes``; the
    rules only shard a dim that the mesh dims divide)."""
    total = 0
    for t, sh in zip(tree_lib.leaves(specs), tree_lib.leaves(shardings)):
        sizes = mesh_lib.mesh_shape(sh.mesh)
        total += _shard_numel(tuple(t.shape), sh.spec, sizes) \
            * t.element_size()
    return total


def analytic_memory(cfg, shape, n_chips: int, resident_trees) -> dict:
    """Per-device memory: the exact resident state (parameters, optimizer
    state, error feedback, caches — from the sharding trees) plus the
    reference's modeled activation terms."""
    resident = sum(sharded_bytes(s, sh) for s, sh in resident_trees)
    out = {"resident_state_bytes": int(resident)}
    b, s, d = shape.global_batch, shape.seq_len, cfg.d_model
    if shape.kind == "train":
        resid = cfg.n_layers * b * s * d * 2 / n_chips
        grads = 2 * cfg.param_count() / n_chips
        f_eff = max(cfg.d_ff, d)
        trans = 3 * b * s * (d + f_eff) * 2 / n_chips
        out["residual_stack_bytes"] = int(resid)
        out["grad_bytes"] = int(grads)
        out["transient_model_bytes"] = int(trans)
        out["analytic_bytes"] = int(resident + resid + grads + trans)
    else:
        trans = (3 * b * min(s, cfg.attn_chunk) * d * 2 / n_chips
                 if shape.kind == "prefill"
                 else 2 * b * d * 2 / max(1, n_chips // 16))
        out["transient_model_bytes"] = int(trans)
        out["analytic_bytes"] = int(resident + trans)
    out["fits_h100_80gb_analytic"] = bool(out["analytic_bytes"]
                                          < H100.hbm_bytes)
    return out


def _cell_config(arch: str, bayesian: int, overrides: dict | None):
    over = dict(overrides or {})
    if bayesian:
        over.update(mask_samples=bayesian)
    return get_config(arch, **over)


def _meta_tree(shapes):
    """``(shape, dtype)`` leaves (``Model.cache_specs``) as ``meta``
    tensors."""
    if isinstance(shapes, dict):
        return {k: _meta_tree(v) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_meta_tree(v) for v in shapes]
    shape, dtype = shapes
    return torch.empty(shape, dtype=dtype, device="meta")


def trace_cell(arch: str, shape_name: str, mesh, *, bayesian: int = 0,
               overrides: dict | None = None) -> tuple[dict, LocalCosts]:
    """Build one cell on ``mesh`` as ``meta`` DTensors and run its step
    once under :class:`LocalCosts`. Returns (meta dict, costs)."""
    shape = SHAPES[shape_name]
    cfg = _cell_config(arch, bayesian, overrides)
    if bayesian and shape.kind != "train":
        # Bayesian serving: every request under all N masks, so the served
        # batch is N x the request batch (mask-major rows)
        shape = dataclasses.replace(shape,
                                    global_batch=shape.global_batch
                                    * bayesian)
    model = build_model(cfg)
    costs = LocalCosts()
    meta: dict = {"cfg": cfg, "shape": shape}
    if shape.kind == "train":
        opt_cfg = pick_optimizer(cfg)
        optimizer = build_optimizer(opt_cfg)
        tcfg = TrainConfig(grad_accum=1,
                           compress_grads="pod" in mesh.mesh_dim_names)
        specs = train_state_specs(model, optimizer,
                                  compress=tcfg.compress_grads)
        state_sh = sharding.param_shardings(mesh, specs)
        batch = model.input_specs(shape)["batch"]
        state = sharding.distribute_tree(specs, state_sh)
        batch = sharding.distribute_tree(
            batch, sharding.batch_shardings(mesh, batch))
        step = make_train_step(model, optimizer, tcfg)
        from torch.distributed.tensor.experimental import implicit_replication
        with mesh_lib.use_mesh(mesh), implicit_replication(), costs:
            step(state, batch)
        meta.update(kind="train", optimizer=opt_cfg.name,
                    resident=[(specs, state_sh)])
        return meta, costs
    params_specs = model.param_specs()
    params_sh = sharding.param_shardings(mesh, params_specs)
    params = sharding.distribute_tree(params_specs, params_sh)
    cache_sp = _meta_tree(model.cache_specs(shape.global_batch,
                                            shape.seq_len))
    cache_sh = sharding.cache_shardings(mesh, cache_sp)
    resident = [(params_specs, params_sh), (cache_sp, cache_sh)]
    if shape.kind == "prefill":
        batch = model.input_specs(shape)["batch"]
        batch = sharding.distribute_tree(
            batch, sharding.batch_shardings(mesh, batch))
        with mesh_lib.use_mesh(mesh), costs:
            model.prefill(params, batch, max_seq=shape.seq_len)
        meta.update(kind="prefill", resident=resident)
        return meta, costs
    # decode: one new token against a seq_len-deep cache
    ins = model.input_specs(shape)
    caches = sharding.distribute_tree(cache_sp, cache_sh)
    tokens = sharding.distribute_tree(
        {"tokens": ins["tokens"]},
        sharding.batch_shardings(mesh, {"tokens": ins["tokens"]}))["tokens"]
    with mesh_lib.use_mesh(mesh), costs:
        model.decode_step(params, caches, tokens, ins["pos"])
    meta.update(kind="decode", resident=resident)
    return meta, costs


def analyze(meta: dict, costs: LocalCosts, mesh) -> dict:
    """The result record of one traced cell (the reference's keys where
    they mean the same)."""
    cfg, shape = meta["cfg"], meta["shape"]
    n_chips = mesh.size()
    result: dict = {
        "env": {"torch": torch.__version__, "backend": "fake",
                "device": "meta"},
        "arch": cfg.arch_id, "shape": shape.name, "kind": meta["kind"],
        "mesh": mesh_lib.mesh_shape(mesh), "n_chips": n_chips,
        "memory_analytic": analytic_memory(cfg, shape, n_chips,
                                           meta["resident"]),
        "cost": {"hlo_flops_per_device": float(costs.flops),
                 "hlo_bytes_per_device": float(costs.bytes),
                 "source": "local operands, unfused"},
        "collectives": dict(costs.collectives),
    }
    if "optimizer" in meta:
        result["optimizer"] = meta["optimizer"]
    flops, bytes_ = float(costs.flops), float(costs.bytes)
    terms = roofline_terms(flops, bytes_, sum(costs.collectives.values()),
                           H100)
    mf = model_flops(cfg, shape)
    result["roofline"] = {
        "device": H100.name,
        "compute_s": terms.compute_s,
        "memory_s": terms.memory_s,
        "collective_s": terms.collective_s,
        "dominant": terms.dominant,
        "bound_s": terms.bound_s,
        "model_flops_total": mf,
        "model_flops_per_device": mf / n_chips,
        "useful_flops_ratio": (mf / n_chips / flops) if flops else None,
        "roofline_fraction": ((mf / n_chips) / terms.bound_s
                              / H100.peak_flops) if terms.bound_s else None,
    }
    return result


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             bayesian: int = 0, overrides: dict | None = None) -> dict:
    """One cell end to end in this process: the fake world, the mesh, the
    traced step and its record (``trace_s``: the step's wall time on this
    host). The world is destroyed before it returns."""
    world = 512 if multi_pod else 256
    with fake_world(world):
        mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod,
                                             device_type="cpu")
        t0 = time.perf_counter()
        meta, costs = trace_cell(arch, shape_name, mesh, bayesian=bayesian,
                                 overrides=overrides)
        trace_s = time.perf_counter() - t0
        result = analyze(meta, costs, mesh)
    result["trace_s"] = round(trace_s, 1)
    if bayesian:
        result["bayesian_samples"] = bayesian
    return result


def _parse_overrides(items: list[str]) -> dict:
    overrides = {}
    for kv in items:
        k, v = kv.split("=", 1)
        if v in ("True", "False"):
            v = v == "True"
        else:
            for cast in (int, float):
                try:
                    v = cast(v)
                    break
                except ValueError:
                    pass
        overrides[k] = v
    return overrides


def _write(result: dict, out: str) -> None:
    print(json.dumps(result, indent=2))
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            json.dump(result, f, indent=2)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=sorted(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--bayesian", type=int, default=0,
                    help="enable Masksembles with N samples")
    ap.add_argument("--out", default="")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg overrides key=value (int/float/str)")
    args = ap.parse_args(argv)
    reason = skip_reason(args.arch, SHAPES[args.shape])
    if reason:
        _write({"arch": args.arch, "shape": args.shape, "skipped": reason},
               args.out)
        return 0
    _write(run_cell(args.arch, args.shape, multi_pod=args.multi_pod,
                    bayesian=args.bayesian,
                    overrides=_parse_overrides(args.override)), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
