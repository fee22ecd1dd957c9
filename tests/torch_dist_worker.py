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
  serve        4 ranks, (2, 2): each family the test listed in
               ``families.json``, its parameters restored as DTensors
               (``param_shardings``): prefill + 4 decode steps on the
               tokens the test saved, and ``serve_uncertain(mesh=)``
               per-op, under spies that record the ``flash_attention`` and
               ``moments`` calls' operand shapes.
  einsum       4 ranks, (2, 2): ``layers.einsum`` on DTensors against
               ``torch.einsum`` on whole tensors, values and gradients
               (:data:`EINSUM_CASES`).
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


def scenario_serve(rank: int, workdir: str) -> None:
    import numpy as np
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed import checkpoint, sharding
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.moments import ops as moments_ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import transformer
    from repro_torch.serving import engine
    mesh = mesh_lib.make_mesh((2, 2), ("data", "model"), device_type="cpu")
    with open(os.path.join(workdir, "families.json")) as f:
        families = json.load(f)

    def shapes(args):
        return [[type(t).__name__, list(t.shape)] for t in args
                if isinstance(t, torch.Tensor)]

    for arch in families:
        cfg, model, _ = _model(arch)
        d = os.path.join(workdir, arch)
        specs = model.param_specs()
        params, _ = checkpoint.restore_checkpoint(
            d, 0, specs, shardings=sharding.param_shardings(mesh, specs))
        io = np.load(os.path.join(d, "io.npz"))
        toks, steps = torch.from_numpy(io["tokens"]), io["steps"]
        n = cfg.mask_samples
        ids = torch.arange(n).repeat_interleave(toks.shape[0] // n)
        s = toks.shape[1]
        with _count_calls(flash_ops, "flash_attention", []) as flash, \
                _count_calls(moments_ops, "moments", []) as moments, \
                mesh_lib.use_mesh(mesh):
            logits, caches = transformer.prefill(
                cfg, params, {"tokens": toks}, max_seq=s + len(steps),
                mask_ids=ids)
            out = [sharding.whole(logits)]
            for i, tok in enumerate(steps):
                logits, caches = transformer.decode_step(
                    cfg, params, caches, torch.from_numpy(tok), s + i,
                    mask_ids=ids)
                out.append(sharding.whole(logits))
            layouts = {f"{si}/{b}/{name}": [str(p) for p in t.placements]
                       for si, seg in enumerate(caches)
                       for b, c in seg.items() for name, t in c.items()
                       if isinstance(t, DTensor)}
            plain = [name for seg in caches for c in seg.values()
                     for name, t in c.items() if not isinstance(t, DTensor)]
            gen, unc, flags = engine.serve_uncertain(
                model, params, toks[:toks.shape[0] // n],
                engine.ServeConfig(max_new_tokens=len(steps), fused=False),
                mesh=mesh, device="cpu")
        if rank == 0:
            np.savez(os.path.join(d, "sharded.npz"),
                     logits=torch.stack(out).numpy(), gen=gen.numpy(),
                     unc=unc.numpy(), flags=flags.numpy())
            with open(os.path.join(d, "sharded.json"), "w") as f:
                json.dump({"cache_layouts": layouts, "plain_leaves": plain,
                           "flash": [shapes(a) for a, _ in flash],
                           "moments": [shapes(a) for a, _ in moments]}, f)


#: ``layers.einsum`` cases: (equation, [(shape, placements on the (2, 2)
#: mesh: "R", "P" or a dim to shard) an operand, None for a plain one],
#: whether the shards line up).
EINSUM_CASES = [
    # the mLSTM chunk's products (dh split over "model")
    ("bhqd,bhtd->bhqt", [((4, 2, 6, 8), (0, 3)), ((4, 2, 6, 8), (0, 3))],
     True),
    ("bhqt,bhtd->bhqd", [((4, 2, 6, 6), (0, "R")), ((4, 2, 6, 8), (0, 3))],
     True),
    ("bhqd,bhde->bhqe", [((4, 2, 6, 8), (0, 3)), ((4, 2, 8, 8), None)],
     True),
    ("bht,bhtd,bhte->bhde", [((4, 2, 6), (0, "R")), ((4, 2, 6, 8), (0, 3)),
                             ((4, 2, 6, 8), (0, "R"))], True),
    # the decode step: a partial q against C split over its second dh
    ("bhd,bhde->bhe", [((4, 2, 8), ("P", "R")), ((4, 2, 8, 8), ("R", 3))],
     True),
    # grouped attention, GQA (2 KV heads, 2 queries each), heads split
    ("bkgqd,bksd->bkgqs", [((4, 2, 2, 6, 8), (0, 1)), ((4, 2, 6, 8), (0, 1))],
     True),
    ("bkgqs,bksd->bkgqd", [((4, 2, 2, 6, 6), (0, 1)), ((4, 2, 6, 8), (0, 1))],
     True),
    # two subscripts split over one mesh dim: DTensor chooses
    ("bhqd,bhde->bhqe", [((4, 2, 6, 8), (0, 3)), ((4, 2, 8, 8), (0, 3))],
     False),
]


def scenario_einsum(rank: int, workdir: str) -> None:
    """Each :data:`EINSUM_CASES` product by ``layers.einsum`` on DTensors
    against ``torch.einsum`` on the whole tensors: values, and the
    gradients of every operand through a fixed random cotangent."""
    import torch
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard, distribute_tensor)
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import layers
    mesh = mesh_lib.make_mesh((2, 2), ("data", "model"), device_type="cpu")
    gen = torch.Generator().manual_seed(0)
    for eq, specs, lined_up in EINSUM_CASES:
        whole = [torch.randn(shape, generator=gen, dtype=torch.float64)
                 for shape, _ in specs]
        ops, leaves = [], []
        for t, (_, pl) in zip(whole, specs):
            if pl is None:
                leaf = t.clone().requires_grad_()
                ops.append(leaf)
            elif "P" in pl:
                # a partial sum: every rank holds its share of t
                leaf = (t / mesh.size(pl.index("P"))).requires_grad_()
                ops.append(DTensor.from_local(leaf, mesh, tuple(
                    Partial() if p == "P" else Replicate() for p in pl),
                    run_check=False))
            else:
                leaf = distribute_tensor(t, mesh, tuple(
                    Replicate() if p == "R" else Shard(p) for p in pl)
                ).requires_grad_()
                ops.append(leaf)
            leaves.append(leaf)
        dts = tuple(o if isinstance(o, DTensor) else DTensor.from_local(
            o, mesh, (Replicate(), Replicate()), run_check=False)
            for o in ops)
        if (layers._lined_up(eq, dts) is not None) != lined_up:
            raise AssertionError(f"{eq} {specs}: lined up is not "
                                 f"{lined_up}")
        out = layers.einsum(eq, *ops).full_tensor()
        plain = [t.clone().requires_grad_() for t in whole]
        want = torch.einsum(eq, *plain)
        torch.testing.assert_close(out, want, rtol=1e-12, atol=1e-12)
        cot = torch.randn(want.shape, generator=gen, dtype=torch.float64)
        (out * cot).sum().backward()
        (want * cot).sum().backward()
        for leaf, p, (_, pl) in zip(leaves, plain, specs):
            got = leaf.grad.full_tensor() if isinstance(
                leaf.grad, DTensor) else leaf.grad
            torch.testing.assert_close(got, p.grad, rtol=1e-12, atol=1e-12,
                                       msg=lambda m: f"{eq} {pl}: {m}")


SCENARIOS = {"train": scenario_train, "elastic_a": scenario_elastic_a,
             "elastic_b": scenario_elastic_b,
             "collectives": scenario_collectives, "serve": scenario_serve,
             "einsum": scenario_einsum}


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
