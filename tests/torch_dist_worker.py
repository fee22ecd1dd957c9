"""One rank of a multi-rank scenario of the port's mesh layer, on the CPU
(gloo), and the launcher that spawns a world of them.

    python tests/torch_dist_worker.py <scenario> <rank> <world> <init file>
        <work dir>

Each rank is its own process (``file://`` rendezvous, a 60 s collective
timeout): the pytest process keeps no process group. Rank 0 writes what
the tests read into the work dir (checkpoints in the port's layout, JSON,
``.npy``); a failed check raises, so the rank exits non-zero and the
launcher raises with every rank's stderr. Imports torch and the port only.

Scenarios:
  train        4 ranks, (2, 2): one sharded train step of each family
               the test listed in ``families.json``, from the state it
               saved, under a spy that counts ``full_tensor`` calls inside
               the step and one that records the scan's operands.
  elastic_a    4 ranks, (2, 2): three sharded steps, save; restore that
               checkpoint on (1, 4) and (4, 1).
  elastic_b    2 ranks: plan_remesh to (1, 2), restore with shardings=,
               one step with grad_accum 2 on batch 3.
  collectives  4 ranks: pipeline_forward on a 4-stage mesh (and a ragged
               call), compressed_allreduce under a spy on all_reduce.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")

#: Sizes of every train scenario (smoke configs; the MoE one at its smoke
#: capacity E / top_k, which drops no token).
SEQ, BATCH, LR = 16, 8, 1e-3


def spawn(scenario: str, world: int, workdir: str,
          timeout_s: float = 120.0) -> None:
    """Run ``scenario`` on ``world`` ranks; raise with their stderr if any
    rank fails or the world outlives ``timeout_s``."""
    init = os.path.join(tempfile.mkdtemp(dir=workdir), "rendezvous")
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), scenario, str(r),
         str(world), init, workdir], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=timeout_s)
            errs.append(err)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode, e[-3000:]) for r, (p, e)
           in enumerate(zip(procs, errs)) if p.returncode]
    if bad or len(errs) < world:
        raise RuntimeError(f"{scenario}: ranks failed: {bad}")


# ---------------------------------------------------------------------------
# rank side
# ---------------------------------------------------------------------------


def _setup(rank: int, world: int, init: str):
    import torch
    from repro_torch.launch import mesh as mesh_lib
    torch.set_num_threads(1)
    mesh_lib.init_world("file://" + init, rank, world, device_type="cpu",
                        timeout_s=60)


@contextlib.contextmanager
def _count_calls(owner, name: str, log: list):
    """Append each call's arguments to ``log`` while inside."""
    orig = getattr(owner, name)

    def spy(*args, **kwargs):
        log.append((args, kwargs))
        return orig(*args, **kwargs)

    setattr(owner, name, spy)
    try:
        yield log
    finally:
        setattr(owner, name, orig)


def _model(arch: str, **overrides):
    from repro_torch.configs import registry
    from repro_torch.models.model import build_model
    from repro_torch.optim import OptimizerConfig, build_optimizer
    cfg = registry.smoke_config(arch, **overrides)
    return cfg, build_model(cfg), build_optimizer(OptimizerConfig(lr=LR))


def _data(cfg):
    from repro_torch.data import LMDataConfig
    return LMDataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                        global_batch=BATCH)


def _sharded_step(step, mesh, state, batch):
    """One step on DTensors (the batch laid out by batch_shardings);
    returns (state, loss, gnorm, full_tensor calls inside the step)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.distributed import sharding
    from repro_torch.launch import mesh as mesh_lib
    batch = sharding.distribute_tree(batch,
                                     sharding.batch_shardings(mesh, batch))
    with _count_calls(DTensor, "full_tensor", []) as gathers, \
            mesh_lib.use_mesh(mesh), implicit_replication():
        state, metrics = step(state, batch)
    return (state, float(metrics["loss"].full_tensor()),
            float(metrics["gnorm"].full_tensor()), len(gathers))


def scenario_train(rank: int, workdir: str) -> None:
    from repro_torch.distributed import checkpoint, sharding
    from repro_torch.data import lm_batch
    from repro_torch.kernels.rglru_scan import ops as scan_ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.train import (TrainConfig, make_train_step,
                                   train_state_specs)
    mesh = mesh_lib.make_mesh((2, 2), ("data", "model"), device_type="cpu")
    with open(os.path.join(workdir, "families.json")) as f:
        families = json.load(f)
    for arch in families:
        cfg, model, opt = _model(arch)
        d = os.path.join(workdir, arch)
        state, _ = checkpoint.restore_checkpoint(
            d, 0, train_state_specs(model, opt),
            shardings=sharding.param_shardings(
                mesh, train_state_specs(model, opt)))
        step = make_train_step(model, opt, TrainConfig())
        with _count_calls(scan_ops, "rglru_scan", []) as fwd, \
                _count_calls(scan_ops, "rglru_scan_backward", []) as bwd:
            state, loss, gnorm, gathers = _sharded_step(
                step, mesh, state, lm_batch(_data(cfg), 0, "cpu"))
        meta = {"loss": loss, "gnorm": gnorm, "gathers": gathers,
                "scan_shapes": [list(a[0].shape) for a, _ in fwd],
                "scan_bwd_shapes": [list(a[0].shape) for a, _ in bwd]}
        checkpoint.save_checkpoint(d, 1, state, meta)


def scenario_elastic_a(rank: int, workdir: str) -> None:
    import torch
    from repro_torch.core import tree as tree_lib
    from repro_torch.data import lm_batch
    from repro_torch.distributed import checkpoint, sharding
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.train import (TrainConfig, make_train_step,
                                   train_state_init, train_state_specs)
    cfg, model, opt = _model("qwen2-1.5b", n_layers=2)
    mesh = mesh_lib.make_mesh((2, 2), ("data", "model"), device_type="cpu")
    state = train_state_init(model, opt, torch.Generator().manual_seed(0),
                             device="cpu")
    state = sharding.distribute_tree(
        state, sharding.param_shardings(mesh, state))
    step = make_train_step(model, opt, TrainConfig())
    losses = []
    for i in range(3):
        state, loss, _, _ = _sharded_step(step, mesh, state,
                                          lm_batch(_data(cfg), i, "cpu"))
        losses.append(loss)
    ckpt = os.path.join(workdir, "ckpt")
    checkpoint.save_checkpoint(ckpt, 3, state, {"losses": losses})
    # the same checkpoint on two other meshes of the same world
    target = train_state_specs(model, opt)
    plain, _ = checkpoint.restore_checkpoint(ckpt, 3, target)
    layouts = {}
    for shape in ((1, 4), (4, 1)):
        m = mesh_lib.make_mesh(shape, ("data", "model"), device_type="cpu")
        got, _ = checkpoint.restore_checkpoint(
            ckpt, 3, target, shardings=sharding.param_shardings(m, target))
        emb = got["params"]["embed"]["embed"]
        layouts[str(shape)] = {
            "embed_local": list(emb.to_local().shape),
            "embed_shard_dims": [p.dim if p.is_shard() else None
                                 for p in emb.placements]}
        for a, b in zip(tree_lib.leaves(sharding.gather_tree(got)),
                        tree_lib.leaves(plain)):
            if not torch.equal(a, b):
                raise AssertionError(f"reshard onto {shape} changed a leaf")
    if rank == 0:
        with open(os.path.join(workdir, "layouts.json"), "w") as f:
            json.dump(layouts, f)


def scenario_elastic_b(rank: int, workdir: str) -> None:
    from repro_torch.data import lm_batch
    from repro_torch.distributed import checkpoint, elastic, sharding
    from repro_torch.train import (TrainConfig, make_train_step,
                                   train_state_specs)
    cfg, model, opt = _model("qwen2-1.5b", n_layers=2)
    plan = elastic.plan_remesh({"data": 2, "model": 2}, n_alive=2)
    accum = elastic.grad_accum_for_batch(BATCH, old_dp=2,
                                         new_dp=plan.new_shape["data"])
    mesh = elastic.mesh_from_plan(plan, device_type="cpu")
    target = train_state_specs(model, opt)
    state, _ = checkpoint.restore_checkpoint(
        os.path.join(workdir, "ckpt"), 3, target,
        shardings=sharding.param_shardings(mesh, target))
    step = make_train_step(model, opt, TrainConfig(grad_accum=accum))
    state, loss, gnorm, _ = _sharded_step(step, mesh, state,
                                          lm_batch(_data(cfg), 3, "cpu"))
    checkpoint.save_checkpoint(
        os.path.join(workdir, "restarted"), 4, state,
        {"loss": loss, "gnorm": gnorm, "new_shape": plan.new_shape,
         "accum": accum, "mesh_dims": list(mesh.mesh_dim_names)})


def scenario_collectives(rank: int, workdir: str) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import compression, pipeline
    from repro_torch.launch import mesh as mesh_lib
    # GPipe over 4 stages against the sequential run
    mesh = mesh_lib.make_mesh((4,), ("stage",), device_type="cpu")
    rng = np.random.default_rng(0)
    ws = torch.from_numpy(rng.normal(size=(4, 8, 8)).astype(np.float32)
                          * 0.3)
    x = torch.from_numpy(rng.normal(size=(8, 8)).astype(np.float32))

    def stage_fn(w, h):
        return torch.tanh(h @ w)

    want = x
    for i in range(4):
        want = stage_fn(ws[i], want)
    got = pipeline.pipeline_forward(mesh, stage_fn, ws, x, n_micro=4)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    comm: list = []
    with _count_calls(dist, "batch_isend_irecv", comm), \
            _count_calls(dist, "broadcast", comm):
        try:
            pipeline.pipeline_forward(mesh, stage_fn, ws, x, n_micro=3)
        except ValueError as e:
            ragged = str(e)
        else:
            raise AssertionError("a ragged microbatch split did not raise")
    if comm:
        raise AssertionError("the ragged call communicated first")
    # the int8 all-reduce over the world, under a spy on all_reduce
    xs = np.load(os.path.join(workdir, "allreduce_in.npy"))
    reduces: list = []
    with _count_calls(dist, "all_reduce", reduces):
        out = compression.compressed_allreduce(torch.from_numpy(xs[rank]))
    if rank == 0:
        np.save(os.path.join(workdir, "allreduce_out.npy"), out.numpy())
        with open(os.path.join(workdir, "collectives.json"), "w") as f:
            json.dump({"ragged": ragged, "reduces": [
                {"dtype": str(a[0].dtype), "shape": list(a[0].shape),
                 "op": str(kw.get("op"))} for a, kw in reduces]}, f)


SCENARIOS = {"train": scenario_train, "elastic_a": scenario_elastic_a,
             "elastic_b": scenario_elastic_b,
             "collectives": scenario_collectives}


def main(argv: list[str]) -> None:
    scenario, rank, world, init, workdir = argv
    rank, world = int(rank), int(world)
    _setup(rank, world, init)
    import torch.distributed as dist
    try:
        SCENARIOS[scenario](rank, workdir)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
