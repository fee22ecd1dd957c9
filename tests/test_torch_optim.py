"""The port's optimizers (``repro_torch.optim``) against the JAX package's
(``repro.optim``), on the CPU, and twins of tests/test_optim.py.

The same numpy parameters and gradients go through both; the parameter
tree holds a stacked [3, 4, 5] leaf (updated one layer slice at a time in
both), a matrix, a vector, a scalar and Masksembles ``masks``. Tolerances:
the parameters and moments after each step within 2e-6 relative / 1e-7
absolute (one fp32 update, ``pow``/``rsqrt`` of another library), the
schedule within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import OptimizerConfig as JOptConfig
from repro.optim import build_optimizer as j_build_optimizer
from repro.optim import cosine_schedule as j_cosine_schedule
from repro_torch.core import tree as tree_lib
from repro_torch.optim import (OptimizerConfig, build_optimizer,
                               clip_by_global_norm, cosine_schedule)

RTOL, ATOL = 2e-6, 1e-7


def _tree(rng, scale=1.0):
    return {"stack": {"w": rng.normal(size=(3, 4, 5)).astype(np.float32)
                      * scale},
            "mat": rng.normal(size=(6, 7)).astype(np.float32) * scale,
            "vec": rng.normal(size=(9,)).astype(np.float32) * scale,
            "one": rng.normal(size=(1, 8)).astype(np.float32) * scale,
            "ffn": {"masks": (rng.uniform(size=(2, 4, 6)) > 0.5).astype(
                np.float32)}}


def _torch(tree):
    return tree_lib.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(got, want):
    g = [t.numpy() for t in tree_lib.leaves(got)]
    w = [np.asarray(t) for t in jax.tree.leaves(want)]
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("clip", (1.0, 0.0))
@pytest.mark.parametrize("name", ("adamw", "adafactor"))
def test_update_matches_jax(name, clip):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    kw = dict(name=name, lr=0.05, warmup_steps=2, decay_steps=6,
              clip_norm=clip)
    jo, to = j_build_optimizer(JOptConfig(**kw)), build_optimizer(
        OptimizerConfig(**kw))
    jp = jax.tree.map(jnp.asarray, params)
    tp = _torch(params)
    js, ts = jo.init(jp), to.init(tp)
    assert [tuple(t.shape) for t in tree_lib.leaves(ts)] == \
        [np.asarray(t).shape for t in jax.tree.leaves(js)]
    for step in range(4):
        grads = _tree(np.random.default_rng(10 + step), scale=3.0)
        jp, js = jo.update(jax.tree.map(jnp.asarray, grads), js, jp)
        tp, ts = to.update(_torch(grads), ts, tp)
        _close(tp, jp)
        _close({k: v for k, v in ts.items() if k != "step"},
               {k: v for k, v in js.items() if k != "step"})
        assert int(ts["step"]) == int(js["step"]) == step + 1
    np.testing.assert_array_equal(tp["ffn"]["masks"].numpy(),
                                  params["ffn"]["masks"])


def test_update_keeps_dtype_and_works_in_place():
    """bf16 parameters stay bf16 (the update in fp32, cast back), the trees
    passed in are the trees returned, and the clip scales a bf16 gradient
    in bf16."""
    rng = np.random.default_rng(1)
    p = {"w": torch.from_numpy(rng.normal(size=(4, 5)).astype(
        np.float32)).to(torch.bfloat16)}
    g = {"w": torch.full((4, 5), 10.0, dtype=torch.bfloat16)}
    opt = build_optimizer(OptimizerConfig(lr=0.1, warmup_steps=0))
    st = opt.init(p)
    w = p["w"]
    new_p, new_st = opt.update(g, st, p)
    assert new_p is p and new_st is st and p["w"] is w
    assert p["w"].dtype == torch.bfloat16
    assert st["mu"]["w"].dtype == torch.float32
    clipped, gnorm = clip_by_global_norm(g, 1.0)
    assert clipped["w"].dtype == torch.bfloat16
    assert float(gnorm) == pytest.approx(10.0 * np.sqrt(20), rel=1e-6)


# ---------------------------------------------------------------------------
# twins of tests/test_optim.py
# ---------------------------------------------------------------------------


def _quadratic_losses(name, steps=120):
    cfg = OptimizerConfig(name=name, lr=0.1, warmup_steps=5,
                          decay_steps=steps, weight_decay=0.0)
    opt = build_optimizer(cfg)
    target = torch.tensor([[1.0, -2.0], [3.0, 0.5]])
    params = {"w": torch.zeros((2, 2)), "masks": torch.ones((2, 2))}
    st = opt.init(params)
    losses = []
    for _ in range(steps):
        grads = {"w": params["w"] - target, "masks": torch.ones((2, 2))}
        losses.append(float(torch.sum((params["w"] - target) ** 2)))
        params, st = opt.update(grads, st, params)
    return losses, params


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_converges_on_quadratic(name):
    losses, _ = _quadratic_losses(name)
    assert losses[-1] < losses[0] * 0.01


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_masks_never_updated(name):
    _, params = _quadratic_losses(name, steps=20)
    np.testing.assert_array_equal(params["masks"].numpy(), 1.0)


def test_mapped_stack_update_matches_unstacked():
    """The slice-at-a-time update of a stacked [L, ...] leaf equals
    updating each slice on its own (Adafactor's row means and RMS clip are
    per slice)."""
    cfg = OptimizerConfig(name="adafactor", lr=0.05, warmup_steps=1,
                          decay_steps=50, weight_decay=0.0, clip_norm=0.0)
    L, m, n = 3, 4, 5
    stack = torch.randn((L, m, n), generator=torch.Generator().manual_seed(0))
    gstack = torch.randn((L, m, n),
                         generator=torch.Generator().manual_seed(1))
    opt = build_optimizer(cfg)
    ps = {"w": stack.clone()}
    upd_stack, _ = opt.update({"w": gstack}, opt.init(ps), ps)
    for i in range(L):
        pi = {"w": stack[i].clone()}
        upd_i, _ = opt.update({"w": gstack[i]}, opt.init(pi), pi)
        torch.testing.assert_close(upd_stack["w"][i], upd_i["w"],
                                   rtol=1e-5, atol=1e-6)


def test_adafactor_state_is_factored():
    opt = build_optimizer(OptimizerConfig(name="adafactor"))
    params = {"big": torch.ones((64, 128)), "vec": torch.ones(7)}
    st = opt.init(params)
    assert st["v"]["big"]["vr"].shape == (64,)
    assert st["v"]["big"]["vc"].shape == (128,)
    assert st["v"]["vec"]["v"].shape == (7,)
    assert (st["v"]["big"]["vr"].numel() + st["v"]["big"]["vc"].numel()
            < params["big"].numel() // 10)


def test_clip_by_global_norm():
    grads = {"a": torch.ones((10,)) * 100.0}
    clipped, gnorm = clip_by_global_norm(grads, 1.0)
    assert float(gnorm) == pytest.approx(100.0 * np.sqrt(10), rel=1e-5)
    norm_after = float(torch.sqrt(torch.sum(clipped["a"] ** 2)))
    assert norm_after == pytest.approx(1.0, rel=1e-2)


def test_cosine_schedule_shape():
    cfg = OptimizerConfig(lr=1.0, warmup_steps=10, decay_steps=100,
                          min_lr_ratio=0.1)
    lrs = [float(cosine_schedule(cfg, torch.tensor(s)))
           for s in (0, 5, 10, 55, 100, 200)]
    assert lrs[0] == 0.0
    assert lrs[1] == pytest.approx(0.5)
    assert lrs[2] == pytest.approx(1.0)
    assert 0.1 < lrs[3] < 1.0
    assert lrs[4] == pytest.approx(0.1, rel=1e-3)
    assert lrs[5] == pytest.approx(0.1, rel=1e-3)


def test_cosine_schedule_matches_jax():
    for kw in (dict(lr=3e-4, warmup_steps=100, decay_steps=10_000),
               dict(lr=1e-3, warmup_steps=5, decay_steps=20),
               dict(lr=0.5, warmup_steps=0, decay_steps=0)):
        jc, tc = JOptConfig(**kw), OptimizerConfig(**kw)
        for s in (0, 1, 3, 5, 7, 19, 20, 21, 99, 100, 5000, 20_000):
            np.testing.assert_allclose(
                float(cosine_schedule(tc, torch.tensor(s, dtype=torch.int32))),
                float(j_cosine_schedule(jc, jnp.asarray(s, jnp.int32))),
                rtol=1e-6)


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optimizer"):
        build_optimizer(OptimizerConfig(name="sgd"))
