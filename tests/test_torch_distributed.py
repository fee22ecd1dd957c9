"""The port's sharded train step and the serving ``mesh=`` arguments, on
the CPU.

Multi-rank runs spawn gloo ranks (``tests/torch_dist_worker.py``: one
process a rank, ``file://`` rendezvous, a 60 s collective timeout); this
process keeps no process group, but for the one-rank serving mesh, which it
makes and destroys inside its fixture.

The sharded step: 4 ranks on a (2, 2) ``("data", "model")`` mesh, the
state laid out by ``param_shardings`` and the batch by
``batch_shardings``, the port's ``make_train_step`` unchanged under
``implicit_replication``. It is held to the port's single-device step and
to the reference's step on the same weights (``train_state_from_jax``),
within the reference's own bars (``tests/test_distributed.py``): loss 1e-4
relative, every parameter within 5e-3 after the step (AdamW, lr 1e-3).
Gaps measured here (loss relative; largest parameter gap) against the
single-device step / the reference: qwen2 0 / 2.1e-7, 8.5e-8 / 2.1e-7;
phi3.5-moe 0 / 6.0e-8, 8.0e-8 / 8.2e-8; arctic 0 / 1.8e-7, 0 / 1.9e-7
(each mixer's and each block's output stated batch-sharded, as the
reference states the residual stream, so arctic's MoE groups split over
"data" alone);
recurrentgemma 0 / 3.5e-7, 1.6e-7 / 2.8e-7; xlstm 7.8e-8 / 3.0e-7,
1.6e-7 / 7.2e-7. The one-rank
serving mesh (plain and DTensor parameters), the scan's refusal of a
sequence shard and a one-stage pipeline run in this process.
"""

import contextlib
import json
import os
import tempfile
import threading

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as j_registry
from repro.data import LMDataConfig as JDataConfig
from repro.data import lm_batch as j_lm_batch
from repro.models import build_model as j_build_model
from repro.optim import OptimizerConfig as JOptConfig
from repro.optim import build_optimizer as j_build_optimizer
from repro.serving import router as j_router
from repro.train import TrainConfig as JTrainConfig
from repro.train import make_train_step as j_make_train_step
from repro.train import train_state_init as j_train_state_init
from repro_torch.configs import registry as t_registry
from repro_torch.core import tree as tree_lib
from repro_torch.data import LMDataConfig, lm_batch
from repro_torch.distributed import checkpoint, sharding
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer
from repro_torch.models.model import build_model
from repro_torch.optim import OptimizerConfig, build_optimizer
from repro_torch.serving import engine, router, server
from repro_torch.train import (TrainConfig, make_train_step,
                               train_state_specs)

import torch_dist_worker as worker

TOL_LOSS = 1e-4
TOL_PARAM = 5e-3


def _reference_step(arch):
    """(the reference's initial state as numpy, its state and loss after
    one step on batch 0)."""
    cfg = j_registry.smoke_config(arch)
    model = j_build_model(cfg)
    opt = j_build_optimizer(JOptConfig(lr=worker.LR))
    state = j_train_state_init(model, opt, jax.random.PRNGKey(0))
    data = JDataConfig(vocab_size=cfg.vocab_size, seq_len=worker.SEQ,
                       global_batch=worker.BATCH)
    new, metrics = jax.jit(j_make_train_step(model, opt, JTrainConfig()))(
        state, j_lm_batch(data, 0))
    return (jax.tree.map(np.asarray, state), jax.tree.map(np.asarray, new),
            float(metrics["loss"]))


def _single_step(arch, workdir):
    """The port's single-device step from the saved initial state."""
    cfg = t_registry.smoke_config(arch)
    model = build_model(cfg)
    opt = build_optimizer(OptimizerConfig(lr=worker.LR))
    state, _ = checkpoint.restore_checkpoint(
        os.path.join(workdir, arch), 0, train_state_specs(model, opt))
    data = LMDataConfig(vocab_size=cfg.vocab_size, seq_len=worker.SEQ,
                        global_batch=worker.BATCH)
    state, metrics = make_train_step(model, opt, TrainConfig())(
        state, lm_batch(data, 0, "cpu"))
    return state, float(metrics["loss"])


@contextlib.contextmanager
def train_world(families):
    """Each family's sharded step on 4 ranks (in a thread), its
    single-device and reference steps here meanwhile -> {arch: results}."""
    with tempfile.TemporaryDirectory() as workdir:
        refs = {}
        for arch in families:
            init, new, loss = _reference_step(arch)
            refs[arch] = (new, loss)
            cfg = t_registry.smoke_config(arch)
            checkpoint.save_checkpoint(
                os.path.join(workdir, arch), 0,
                transformer.train_state_from_jax(cfg, init, device="cpu"))
        with open(os.path.join(workdir, "families.json"), "w") as f:
            json.dump(list(families), f)
        failure = []

        def run():
            try:
                worker.spawn("train", 4, workdir)
            except Exception as e:      # noqa: BLE001 — re-raised below
                failure.append(e)

        thread = threading.Thread(target=run)
        thread.start()
        singles = {arch: _single_step(arch, workdir) for arch in families}
        thread.join()
        if failure:
            raise failure[0]
        out = {}
        for arch in families:
            cfg = t_registry.smoke_config(arch)
            model = build_model(cfg)
            opt = build_optimizer(OptimizerConfig(lr=worker.LR))
            sharded, meta = checkpoint.restore_checkpoint(
                os.path.join(workdir, arch), 1, train_state_specs(model, opt))
            out[arch] = {"sharded": sharded, "meta": meta,
                         "single": singles[arch], "ref": refs[arch]}
        yield out


def _np(t) -> np.ndarray:
    return (t.detach().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(t, np.float32))


def _max_gap(a_tree, b_leaves) -> float:
    return max(float(np.abs(_np(a) - _np(b)).max())
               for a, b in zip(tree_lib.leaves(a_tree), b_leaves))


def check_sharded_step(arch: str) -> dict:
    """One family's sharded step (its own 4-rank world) against the
    single-device step and the reference's: loss and gnorm, every
    parameter; no whole-value gather inside the step; each ``rec`` layer's
    scan forward and backward on a rank's [B/2, S, W/2] shard (B over
    "data", W over "model": no collective inside the scan). Returns the
    gaps."""
    with train_world([arch]) as world:
        got = world[arch]
    meta = got["meta"]
    single_state, single_loss = got["single"]
    ref_state, ref_loss = got["ref"]
    np.testing.assert_allclose(meta["loss"], single_loss, rtol=TOL_LOSS)
    np.testing.assert_allclose(meta["loss"], ref_loss, rtol=TOL_LOSS)
    params = got["sharded"]["params"]
    gaps = {"param_single": _max_gap(
                params, tree_lib.leaves(single_state["params"])),
            "param_ref": _max_gap(params,
                                  jax.tree.leaves(ref_state["params"])),
            "loss_single": abs(meta["loss"] / single_loss - 1),
            "loss_ref": abs(meta["loss"] / ref_loss - 1)}
    assert gaps["param_single"] < TOL_PARAM, gaps
    assert gaps["param_ref"] < TOL_PARAM, gaps
    np.testing.assert_allclose(
        meta["gnorm"], float(single_state["opt"]["gnorm"]), rtol=TOL_LOSS)
    # no rank gathered a DTensor's whole value inside the step
    assert meta["gathers"] == 0
    cfg = t_registry.smoke_config(arch)
    local = [worker.BATCH // 2, worker.SEQ, (cfg.lru_width or 0) // 2]
    n_rec = sum(seg.pattern.count("rec") * seg.reps
                for seg in cfg.segments())
    assert meta["scan_shapes"] == [local] * n_rec
    assert meta["scan_bwd_shapes"] == [local] * n_rec
    return gaps


@pytest.mark.parametrize("arch", ("qwen2-1.5b", "phi3.5-moe-42b-a6.6b",
                                  "arctic-480b"))
def test_sharded_step_matches_single_device_and_reference(arch):
    check_sharded_step(arch)


# ---------------------------------------------------------------------------
# a one-rank gloo world in this process: serving under a mesh, the scan's
# refusal of a sequence shard, one pipeline stage
# ---------------------------------------------------------------------------


@pytest.fixture
def one_rank_mesh():
    with tempfile.TemporaryDirectory() as d:
        mesh_lib.init_world("file://" + os.path.join(d, "rendezvous"), 0, 1,
                            device_type="cpu")
        try:
            yield mesh_lib.make_mesh((1, 1), ("data", "model"),
                                     device_type="cpu")
        finally:
            torch.distributed.destroy_process_group()


def _lm():
    cfg = t_registry.smoke_config("qwen2-1.5b", n_layers=2)
    model = build_model(cfg)
    return model, model.init(torch.Generator().manual_seed(0), device="cpu")


def test_serve_uncertain_under_mesh_is_bit_equal(one_rank_mesh):
    model, params = _lm()
    toks = torch.randint(0, 256, (2, 5), generator=torch.Generator()
                         .manual_seed(1))
    cfg = engine.ServeConfig(max_new_tokens=4)
    want = engine.serve_uncertain(model, params, toks, cfg, device="cpu")
    got = engine.serve_uncertain(model, params, toks, cfg,
                                 mesh=one_rank_mesh, device="cpu")
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(
        engine.generate(model, params, toks, cfg, mesh=one_rank_mesh,
                        device="cpu"),
        engine.generate(model, params, toks, cfg, device="cpu"))
    assert mesh_lib.get_mesh() is None          # the scope was left


def test_server_under_mesh_is_bit_equal(one_rank_mesh):
    model, params = _lm()
    prompts = [[1, 2, 3], [4, 5, 6, 7, 8], [9]]

    def serve(mesh):
        srv = server.BayesianLMServer(
            model, params, server.ServerConfig(max_slots=2, max_prompt_len=8,
                                        max_new_tokens=4),
            mesh=mesh, device="cpu")
        rids = [srv.submit(p, max_new_tokens=4) for p in prompts]
        srv.run()
        return [(srv.result(r).generated, srv.result(r).uncertainty)
                for r in rids]

    assert serve(one_rank_mesh) == serve(None)


def test_serving_takes_dtensor_params(one_rank_mesh):
    """Parameters laid out by ``param_shardings`` on the one-rank mesh:
    ``serve_uncertain`` (fused and per-op), ``generate`` and the server give
    exactly the outputs of the plain parameters (every placement on a mesh
    of one device is ``Replicate``)."""
    model, params = _lm()
    sharded = sharding.distribute_tree(
        params, sharding.param_shardings(one_rank_mesh, params))
    toks = torch.randint(0, 256, (2, 5), generator=torch.Generator()
                         .manual_seed(2))
    for fused in (None, False):
        cfg = engine.ServeConfig(max_new_tokens=4, fused=fused)
        want = engine.serve_uncertain(model, params, toks, cfg, device="cpu")
        got = engine.serve_uncertain(model, sharded, toks, cfg,
                                     mesh=one_rank_mesh, device="cpu")
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    cfg = engine.ServeConfig(max_new_tokens=4)
    assert torch.equal(
        engine.generate(model, sharded, toks, cfg, mesh=one_rank_mesh,
                        device="cpu"),
        engine.generate(model, params, toks, cfg, device="cpu"))

    def serve(p, mesh):
        srv = server.BayesianLMServer(
            model, p, server.ServerConfig(max_slots=2, max_prompt_len=8,
                                          max_new_tokens=4),
            mesh=mesh, device="cpu")
        rids = [srv.submit(q, max_new_tokens=4)
                for q in ([1, 2, 3], [4, 5, 6, 7, 8], [9])]
        srv.run()
        return [(srv.result(r).generated, srv.result(r).uncertainty)
                for r in rids]

    assert serve(sharded, one_rank_mesh) == serve(params, None)


def test_rglru_scan_refuses_a_sequence_shard(one_rank_mesh):
    """The recurrence runs over the whole sequence on one rank: a DTensor
    sharded over S raises before any scan; B or W shards run."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.models import rglru
    cfg = t_registry.smoke_config("recurrentgemma-2b")
    p = rglru.rglru_init(torch.Generator().manual_seed(0), cfg.lru_width,
                         torch.float32)
    x = torch.randn(2, 8, cfg.lru_width)
    want, _ = rglru.rglru_scan(p, x)
    dp = sharding.distribute_tree(p, tree_lib.tree_map(
        lambda _: sharding.replicated(one_rank_mesh), p))
    with pytest.raises(ValueError, match="sequence"):
        rglru.rglru_scan(dp, distribute_tensor(x, one_rank_mesh,
                                               (Shard(1), Replicate())))
    got, _ = rglru.rglru_scan(dp, distribute_tensor(x, one_rank_mesh,
                                                    (Shard(0), Shard(2))))
    assert torch.equal(got.full_tensor(), want)


def test_one_stage_pipeline_sends_nothing(one_rank_mesh, monkeypatch):
    from repro_torch.distributed import pipeline
    mesh = mesh_lib.make_mesh((1,), ("stage",), device_type="cpu")
    sent = []
    for name in ("batch_isend_irecv", "broadcast"):
        monkeypatch.setattr(torch.distributed, name,
                            lambda *a, **k: sent.append(a))
    w = torch.randn(1, 6, 6)
    x = torch.randn(4, 6)
    got = pipeline.pipeline_forward(mesh, lambda wi, h: torch.tanh(h @ wi),
                                    w, x, n_micro=2)
    torch.testing.assert_close(got, torch.tanh(x @ w[0]))
    assert not sent
    assert pipeline.bubble_fraction(4, 4) == 3 / 7


@pytest.mark.parametrize("n_hosts,shape", [
    (2, None), (2, {"pod": 2, "data": 1, "model": 1}),
    (3, {"pod": 3, "data": 2, "model": 2}), (2, {"data": 1, "model": 1}),
    (2, {"pod": 3, "data": 1, "model": 1})])
def test_router_mesh_shape_checked_as_the_reference(n_hosts, shape):
    """RouterConfig.mesh_shape: "pod" is the host axis; a pod extent other
    than n_hosts raises in both packages alike."""
    def outcome(cls):
        try:
            cls(n_hosts=n_hosts, mesh_shape=shape)
        except ValueError as e:
            return str(e)
        return None

    got, want = outcome(router.RouterConfig), outcome(j_router.RouterConfig)
    assert got == want


def test_router_passes_its_mesh_and_chips_per_host(one_rank_mesh):
    model, params = _lm()
    r = router.ServingRouter(
        model, params, server.ServerConfig(max_slots=1),
        router.RouterConfig(n_hosts=2,
                            mesh_shape={"pod": 2, "data": 2, "model": 2}),
        mesh=one_rank_mesh, device="cpu")
    assert all(h.server.mesh is one_rank_mesh for h in r.hosts)
    assert r._chips_per_host == 4
