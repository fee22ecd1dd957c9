"""The port's elastic restart, checkpoint resharding, GPipe stages and the
int8 all-reduce, on gloo ranks on the CPU (``tests/torch_dist_worker.py``).

* Elastic restart (the twin of ``tests/test_distributed.py``'s
  ``test_elastic_restart_end_to_end``): 4 ranks on (2, 2) train qwen2's
  smoke config 3 steps and save; 2 survive: ``plan_remesh`` -> (1, 2),
  ``grad_accum_for_batch`` -> 2, ``mesh_from_plan``, restore with
  ``shardings=``, one step on batch 3. Held to the single-device steps
  (3 steps; then grad_accum 2 from the saved state) within the reference's
  bars, loss 1e-4 relative and parameters 5e-3. Gaps measured: the three
  losses within 8.6e-8 relative, the parameters within 4.2e-7 after 3
  steps; the restarted step's loss equal, its parameters within 1.7e-7.
* The (2, 2) checkpoint restored on (1, 4) and (4, 1): bit-equal leaves,
  each rank holding its shard.
* ``pipeline_forward`` on 4 stages equals the sequential run (rtol = atol
  = 1e-5); a ragged microbatch split raises before any message.
* ``compressed_allreduce`` on 4 ranks is bit-equal to the reference's
  ``shard_map`` form over 4 host devices on the same numpy inputs; the
  payload-shaped reduction is int32 and none is float32.
"""

import json
import os
import subprocess
import sys
import tempfile
import threading

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.core import tree as tree_lib
from repro_torch.data import LMDataConfig, lm_batch
from repro_torch.distributed import checkpoint
from repro_torch.models.model import build_model
from repro_torch.optim import OptimizerConfig, build_optimizer
from repro_torch.train import (TrainConfig, make_train_step,
                               train_state_init, train_state_specs)

import torch_dist_worker as worker

TOL_LOSS = 1e-4
TOL_PARAM = 5e-3
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _qwen2():
    cfg = registry.smoke_config("qwen2-1.5b", n_layers=2)
    data = LMDataConfig(vocab_size=cfg.vocab_size, seq_len=worker.SEQ,
                        global_batch=worker.BATCH)
    return (build_model(cfg), build_optimizer(OptimizerConfig(lr=worker.LR)),
            data)


def _in_thread(fn, *args):
    """Run ``fn`` in a thread; join() re-raises its exception."""
    failure = []

    def run():
        try:
            fn(*args)
        except Exception as e:          # noqa: BLE001 — re-raised in join
            failure.append(e)

    thread = threading.Thread(target=run)
    thread.start()

    def join():
        thread.join()
        if failure:
            raise failure[0]

    return join


def _gap(a_tree, b_tree) -> float:
    return max(float((a.detach() - b.detach()).abs().max())
               for a, b in zip(tree_lib.leaves(a_tree),
                               tree_lib.leaves(b_tree)))


@pytest.fixture(scope="module")
def workdir():
    with tempfile.TemporaryDirectory() as d:
        yield d


@pytest.fixture(scope="module")
def trained(workdir):
    """The (2, 2) world's three steps, its checkpoint and its restores
    onto (1, 4) and (4, 1); the single-device steps run here meanwhile."""
    model, opt, data = _qwen2()
    join = _in_thread(worker.spawn, "elastic_a", 4, workdir)
    state = train_state_init(model, opt, torch.Generator().manual_seed(0),
                             device="cpu")
    step = make_train_step(model, opt, TrainConfig())
    losses = []
    for i in range(3):
        state, m = step(state, lm_batch(data, i, "cpu"))
        losses.append(float(m["loss"]))
    join()
    saved, meta = checkpoint.restore_checkpoint(
        os.path.join(workdir, "ckpt"), 3, train_state_specs(model, opt))
    with open(os.path.join(workdir, "layouts.json")) as f:
        layouts = json.load(f)
    return {"three": (state, losses), "saved": (saved, meta),
            "layouts": layouts}


@pytest.fixture(scope="module")
def restarted(workdir, trained):
    """The 2-rank world's restart from that checkpoint, and the
    single-device grad_accum 2 step from it (run here meanwhile)."""
    model, opt, data = _qwen2()
    join = _in_thread(worker.spawn, "elastic_b", 2, workdir)
    target = train_state_specs(model, opt)
    state, _ = checkpoint.restore_checkpoint(
        os.path.join(workdir, "ckpt"), 3, target)
    single, m = make_train_step(model, opt, TrainConfig(grad_accum=2))(
        state, lm_batch(data, 3, "cpu"))
    join()
    got, meta = checkpoint.restore_checkpoint(
        os.path.join(workdir, "restarted"), 4, target)
    return {"single": (single, float(m["loss"])), "restarted": (got, meta)}


def test_sharded_training_matches_single_device_over_three_steps(trained):
    state, losses = trained["three"]
    saved, meta = trained["saved"]
    np.testing.assert_allclose(meta["losses"], losses, rtol=TOL_LOSS)
    assert _gap(saved["params"], state["params"]) < TOL_PARAM
    assert int(saved["opt"]["step"]) == 3


def test_elastic_restart_to_a_smaller_world(restarted):
    """The survivors' mesh keeps the model axis and the old axis order,
    raises grad_accum to keep the global batch, and the restored step
    equals the single-device step with grad_accum 2 from the same state."""
    got, meta = restarted["restarted"]
    single, loss = restarted["single"]
    assert meta["new_shape"] == {"data": 1, "model": 2}
    assert meta["mesh_dims"] == ["data", "model"]
    assert meta["accum"] == 2
    np.testing.assert_allclose(meta["loss"], loss, rtol=TOL_LOSS)
    assert _gap(got["params"], single["params"]) < TOL_PARAM
    np.testing.assert_allclose(meta["gnorm"],
                               float(single["opt"]["gnorm"]), rtol=TOL_LOSS)
    assert int(got["opt"]["step"]) == 4


@pytest.mark.parametrize("shape,local,dims", [
    ("(1, 4)", [64, 64], [None, 0]), ("(4, 1)", [256, 16], [1, None])])
def test_checkpoint_restores_onto_other_meshes(trained, shape, local, dims):
    """embed [V 256, D 64] is ("model", "data"): the "data" mesh dim
    shards D, "model" shards V (a mesh dim of size 1 replicates), so each
    rank keeps V / model x D / data; every restored leaf gathers back
    bit-equal (checked on the ranks)."""
    got = trained["layouts"][shape]
    assert got["embed_local"] == local
    assert got["embed_shard_dims"] == dims


# ---------------------------------------------------------------------------
# pipeline stages and the int8 all-reduce: one 4-rank world
# ---------------------------------------------------------------------------

_JAX_ALLREDUCE = """
import sys
import jax, numpy as np
from jax.sharding import PartitionSpec as P
from repro import compat
from repro.distributed import compression
x = np.load(sys.argv[1])
mesh = compat.make_mesh((4,), ("data",))
fn = jax.jit(compat.shard_map(
    lambda v: compression.compressed_allreduce(v[0], "data"),
    mesh=mesh, in_specs=P("data"), out_specs=P()))
np.save(sys.argv[2], np.asarray(fn(x)))
"""


@pytest.fixture(scope="module")
def collectives():
    with tempfile.TemporaryDirectory() as workdir:
        rng = np.random.default_rng(0)
        xs = (rng.normal(size=(4, 4, 32))
              * np.array([1.0, 0.5, 3.0, 0.01])[:, None, None]).astype(
                  np.float32)
        src = os.path.join(workdir, "allreduce_in.npy")
        np.save(src, xs)
        join = _in_thread(worker.spawn, "collectives", 4, workdir)
        env = dict(os.environ, PYTHONPATH=SRC,
                   XLA_FLAGS="--xla_force_host_platform_device_count=4")
        ref = os.path.join(workdir, "reference.npy")
        out = subprocess.run([sys.executable, "-c", _JAX_ALLREDUCE, src, ref],
                             env=env, capture_output=True, text=True,
                             timeout=120)
        assert out.returncode == 0, out.stderr[-3000:]
        join()
        with open(os.path.join(workdir, "collectives.json")) as f:
            log = json.load(f)
        yield {"xs": xs, "got": np.load(os.path.join(workdir,
                                                     "allreduce_out.npy")),
               "want": np.load(ref), "log": log}


def test_pipeline_forward_on_four_stages(collectives):
    """Equal to the sequential run on every rank (asserted there), and a
    batch of 8 in 3 microbatches raises the reference's ValueError before
    any message."""
    assert "not divisible by n_micro" in collectives["log"]["ragged"]


def test_compressed_allreduce_bit_equal_to_reference(collectives):
    got, want, xs = collectives["got"], collectives["want"], collectives["xs"]
    assert got.dtype == np.float32 and got.shape == (4, 32)
    np.testing.assert_array_equal(got, want)
    # and within the shared grid's rounding of the exact sum
    step = np.abs(xs).max(axis=(0, 2), keepdims=True)[0] / 127.0
    assert (np.abs(got - xs.sum(0)) <= 4 * 0.5 * step + 1e-6).all()


def test_compressed_allreduce_moves_int32(collectives):
    """The payload-shaped reduction runs over int32 words; the float
    reduction is the per-row amax (a scalar a row), a MAX."""
    reduces = collectives["log"]["reduces"]
    payload = [r for r in reduces if r["shape"] == [4, 32]]
    assert [r["dtype"] for r in payload] == ["torch.int32"]
    assert "SUM" in payload[0]["op"]
    floats = [r for r in reduces if r["dtype"] == "torch.float32"]
    assert [r["shape"] for r in floats] == [[4, 1]]
    assert "MAX" in floats[0]["op"]
