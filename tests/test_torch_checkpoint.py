"""The port's checkpoints and error-feedback compression
(``repro_torch.distributed.checkpoint``, ``compression``) against the JAX
package's, on the CPU: twins of tests/test_distributed.py's checkpoint and
EF tests, checkpoints read across in both directions, and ``Trainer``
resume.

Tolerances: checkpoints are exact (the same bytes); the EF transforms'
dequantized gradient and residual equal the reference's bit for bit on the
same fp32 input (the same division, the same rounding), and its int8
values too.
"""

import json
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as j_registry
from repro.distributed import checkpoint as J_CKPT
from repro.distributed import compression as J_COMP
from repro.models import build_model as j_build_model
from repro.optim import OptimizerConfig as JOptConfig
from repro.optim import build_optimizer as j_build_optimizer
from repro.train import train_state_init as j_train_state_init
from repro_torch.configs import registry as t_registry
from repro_torch.core import tree as tree_lib
from repro_torch.data import LMDataConfig
from repro_torch.distributed import checkpoint as CKPT
from repro_torch.distributed import compression as COMP
from repro_torch.models import model as t_model
from repro_torch.models import transformer as t_transformer
from repro_torch.optim import OptimizerConfig, build_optimizer
from repro_torch.train import TrainConfig, Trainer


def _np(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# twins of tests/test_distributed.py
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip_and_rotation():
    tree = {"a": torch.arange(6.0).reshape(2, 3), "b": {"c": torch.ones(4)}}
    with tempfile.TemporaryDirectory() as d:
        mgr = CKPT.CheckpointManager(d, keep=2)
        for step in (1, 2, 3):
            mgr.save(step, tree, {"step": step})
        assert CKPT.latest_step(d) == 3
        steps = sorted(int(x.split("_")[1]) for x in os.listdir(d)
                       if x.startswith("step_"))
        assert steps == [2, 3]
        target = tree_lib.tree_map(lambda t: t.to("meta"), tree)
        step, restored, meta = mgr.restore_latest(target)
        assert step == 3 and meta["step"] == 3
        assert torch.equal(restored["a"], tree["a"])
        assert restored["b"]["c"].device.type == "cpu"


def test_checkpoint_crash_atomicity():
    tree = {"x": torch.ones(3)}
    with tempfile.TemporaryDirectory() as d:
        CKPT.save_checkpoint(d, 5, tree)
        os.makedirs(os.path.join(d, "step_00000009.tmp/arrays"))
        assert CKPT.latest_step(d) == 5
        restored, _ = CKPT.restore_checkpoint(d, 5, tree)
        np.testing.assert_array_equal(_np(restored["x"]), 1.0)
        CKPT.CheckpointManager(d, keep=2).save(6, tree)   # clears debris
        assert sorted(os.listdir(d)) == ["step_00000005", "step_00000006"]


def test_checkpoint_shape_mismatch_rejected():
    with tempfile.TemporaryDirectory() as d:
        CKPT.save_checkpoint(d, 1, {"x": torch.ones(3)})
        with pytest.raises(ValueError, match="shape mismatch"):
            CKPT.restore_checkpoint(d, 1, {"x": torch.ones(4)})
        with pytest.raises(ValueError, match="leaves"):
            CKPT.restore_checkpoint(d, 1, {"x": torch.ones(3),
                                           "y": torch.ones(1)})


def test_int8_quantization_bounds():
    x = torch.randn((16, 64), generator=torch.Generator().manual_seed(0)) * 5
    q, s = COMP.quantize_int8(x)
    err = (COMP.dequantize_int8(q, s) - x).abs()
    amax = x.abs().amax(-1, keepdim=True)
    assert bool((err <= amax / 127.0 * 0.5 + 1e-6).all())


def test_error_feedback_accumulates():
    g = torch.randn((8, 32), generator=torch.Generator().manual_seed(1)) \
        * 0.01
    grads = {"w": g}
    res = COMP.ef_init(grads)
    applied = torch.zeros_like(g)
    for _ in range(30):
        deq, res = COMP.ef_update(grads, res)
        applied = applied + deq["w"]
    want = g * 30
    rel = float((applied - want).abs().max() / (want.abs().max() + 1e-12))
    assert rel < 0.02, rel


def test_compress_tree_passthrough_small():
    tree = {"scalar": torch.ones(()), "vec": torch.ones(5),
            "mat": torch.ones((4, 4)), "masks": torch.ones((2, 4, 6))}
    comp = COMP.compress_tree(tree)
    assert "raw" in comp["scalar"] and "raw" in comp["vec"]
    assert "q" in comp["mat"] and "q" in comp["masks"]
    assert comp["mat"]["q"].dtype == torch.int8
    dec = COMP.decompress_tree(comp)
    np.testing.assert_allclose(_np(dec["mat"]), 1.0, rtol=0.02)


# ---------------------------------------------------------------------------
# the EF transforms against the reference's, bit for bit
# ---------------------------------------------------------------------------


def test_ef_update_bit_equal_to_reference():
    rng = np.random.default_rng(3)
    grads = {"w": rng.normal(size=(3, 4, 40)).astype(np.float32),
             "b": rng.normal(size=(40,)).astype(np.float32),
             "m": (rng.normal(size=(6, 9)) * 1e-3).astype(np.float32)}
    jres = J_COMP.ef_init(jax.tree.map(jnp.asarray, grads))
    tres = COMP.ef_init({k: torch.from_numpy(v) for k, v in grads.items()})
    for step in range(3):
        g = {k: v * (step + 1) for k, v in grads.items()}
        jdeq, jres = J_COMP.ef_update(jax.tree.map(jnp.asarray, g), jres)
        tdeq, tres = COMP.ef_update(
            {k: torch.from_numpy(v) for k, v in g.items()}, tres)
        for k in grads:
            np.testing.assert_array_equal(_np(tdeq[k]), np.asarray(jdeq[k]))
            np.testing.assert_array_equal(_np(tres[k]), np.asarray(jres[k]))
    jc = J_COMP.compress_tree(jax.tree.map(jnp.asarray, grads))
    tc = COMP.compress_tree({k: torch.from_numpy(v)
                             for k, v in grads.items()})
    for k in grads:
        assert set(tc[k]) == set(jc[k])
        for leaf in tc[k]:
            np.testing.assert_array_equal(_np(tc[k][leaf]),
                                          np.asarray(jc[k][leaf]))


# ---------------------------------------------------------------------------
# checkpoints across the two packages
# ---------------------------------------------------------------------------


def _j_state(name):
    cfg = j_registry.smoke_config("qwen2-1.5b")
    opt = j_build_optimizer(JOptConfig(name=name))
    state = j_train_state_init(j_build_model(cfg), opt,
                               jax.random.PRNGKey(0), True)
    # a non-zero optimizer state, so the moments' bytes are checked too
    return jax.tree.map(lambda x: x + 0.25 if x.dtype == jnp.float32
                        else x + 7, state)


@pytest.mark.parametrize("name", ("adamw", "adafactor"))
def test_port_restores_a_reference_checkpoint(name):
    js = _j_state(name)
    tcfg = t_registry.smoke_config("qwen2-1.5b")
    target = t_transformer.train_state_from_jax(
        tcfg, jax.tree.map(lambda x: np.zeros_like(np.asarray(x)), js),
        device="cpu")
    with tempfile.TemporaryDirectory() as d:
        J_CKPT.save_checkpoint(d, 4, js, {"loss": 1.5})
        step, got, meta = CKPT.CheckpointManager(d).restore_latest(target)
    assert step == 4 and meta == {"loss": 1.5}
    want = jax.tree_util.tree_flatten_with_path(js)[0]
    flat = tree_lib.flatten_with_path(got)
    assert len(flat) == len(want)
    for (_, t), (_, w) in zip(flat, want):
        np.testing.assert_array_equal(_np(t), np.asarray(w))


@pytest.mark.parametrize("name", ("adamw", "adafactor"))
def test_reference_restores_a_port_checkpoint(name):
    js = _j_state(name)
    tcfg = t_registry.smoke_config("qwen2-1.5b")
    ts = t_transformer.train_state_from_jax(
        tcfg, jax.tree.map(np.asarray, js), device="cpu")
    with tempfile.TemporaryDirectory() as d:
        path = CKPT.save_checkpoint(d, 2, ts, {"final": True})
        # the same file names as the reference writes
        with open(os.path.join(path, "manifest.json")) as f:
            names = [leaf["file"] for leaf in json.load(f)["leaves"]]
        with tempfile.TemporaryDirectory() as d2:
            jpath = J_CKPT.save_checkpoint(d2, 2, js)
            with open(os.path.join(jpath, "manifest.json")) as f:
                assert names == [leaf["file"]
                                 for leaf in json.load(f)["leaves"]]
        got, meta = J_CKPT.restore_checkpoint(
            d, 2, jax.eval_shape(lambda: js))
    assert meta == {"final": True}
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(js)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_bf16_round_trips_bit_for_bit():
    """bf16 leaves go to disk as the reference writes them (two raw bytes
    an element, dtype "bfloat16" in the manifest) and come back bit for
    bit, NaN payloads and signed zeros included; the port also reads the
    reference's bf16 files."""
    bits = torch.tensor([0, 0x8000, 0x7FC1, 0x3F80, 0xFF80, 0x0001, 0xC2F7],
                        dtype=torch.int32).to(torch.int16)
    tree = {"w": bits.view(torch.bfloat16).reshape(7, 1),
            "f": torch.arange(3.0)}
    with tempfile.TemporaryDirectory() as d:
        path = CKPT.save_checkpoint(d, 1, tree)
        with open(os.path.join(path, "manifest.json")) as f:
            info = json.load(f)["leaves"]
        assert info[1]["dtype"] == "bfloat16"
        got, _ = CKPT.restore_checkpoint(d, 1, tree)
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16), tree["w"].view(
        torch.int16))
    jtree = {"w": jnp.asarray([1.5, -2.25, 3.0e-3], jnp.bfloat16)}
    with tempfile.TemporaryDirectory() as d:
        J_CKPT.save_checkpoint(d, 1, jtree)
        got, _ = CKPT.restore_checkpoint(
            d, 1, {"w": torch.zeros(3, dtype=torch.bfloat16)})
    np.testing.assert_array_equal(got["w"].float().numpy(),
                                  np.asarray(jtree["w"], np.float32))


# ---------------------------------------------------------------------------
# Trainer resume
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,compress", [("adafactor", False),
                                           ("adamw", True)])
def test_trainer_resume_with_optimizer_and_ef_state(name, compress):
    """Cut and resumed runs equal an uninterrupted one bit for bit with
    Adafactor's factored moments and with the EF residual in the
    checkpoint; keep-last-2 rotation leaves the two newest."""
    cfg = t_registry.smoke_config("recurrentgemma-2b", n_layers=3)
    model = t_model.build_model(cfg)
    opt = build_optimizer(OptimizerConfig(name=name, lr=2e-3,
                                          warmup_steps=2))
    data = LMDataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                        global_batch=4)

    def tcfg(steps, d=""):
        return TrainConfig(steps=steps, checkpoint_dir=d, checkpoint_every=2,
                           keep_checkpoints=2, compress_grads=compress)

    want_state, want = Trainer(model, opt, tcfg(5), data, "cpu").run()
    with tempfile.TemporaryDirectory() as d:
        _, first = Trainer(model, opt, tcfg(3, d), data, "cpu").run()
        state, rest = Trainer(model, opt, tcfg(5, d), data, "cpu").run()
        assert sorted(os.listdir(d)) == ["step_00000004", "step_00000005"]
    assert [h["loss"] for h in first + rest] == [h["loss"] for h in want]
    assert set(state) == ({"params", "opt", "ef"} if compress
                          else {"params", "opt"})
    for a, b in zip(tree_lib.leaves(state), tree_lib.leaves(want_state)):
        assert torch.equal(a, b)
