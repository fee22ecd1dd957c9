"""The port's MoE FFN (``repro_torch.models.moe``) and the MoE stacks
against the JAX package, on the CPU.

Models: ``smoke_config("phi3.5-moe-42b-a6.6b")`` (2 layers, d 64, 8
experts top-2, d_ff 128, layernorm, vocab 256, N 4, fp32, group 64, the
dropless capacity E/top_k) and ``smoke_config("arctic-480b")`` (the same
widths, rmsnorm, arctic's dense residual FFN beside the experts), the
reference's weights carried over by ``transformer.params_from_jax``,
inputs from numpy seeds.

Routing is held exactly: the same tokens are dropped at a capacity factor
of 0.5, and top-k breaks ties by the lower expert index, as
``jax.lax.top_k`` does. Tolerances: 1e-5 on one layer or one
prefill/decode step (fp32 sums in another order); posteriors over several
greedy steps ``rtol=1e-4, atol=1e-5`` (the reference's own bar);
generated tokens equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as j_registry
from repro.models import build_model as j_build_model
from repro.models import moe as j_moe
from repro.models import transformer as j_transformer
from repro.serving import engine as j_engine
from repro_torch.configs import registry as t_registry
from repro_torch.core import plan as t_plan
from repro_torch.models import model as t_model
from repro_torch.models import moe as t_moe
from repro_torch.models import transformer as t_transformer
from repro_torch.serving import engine as t_engine
from repro_torch.serving import server as t_server

TOL = 1e-5
POST = dict(rtol=1e-4, atol=1e-5)
ARCHS = ("phi3.5-moe-42b-a6.6b", "arctic-480b")


def _close(got, want, tol=TOL, **kw):
    kw = kw or dict(rtol=tol, atol=tol)
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **kw)


def _tree_close(got, want, tol=TOL):
    g = jax.tree.leaves(jax.tree.map(
        lambda t: t.float().numpy(), got,
        is_leaf=lambda x: isinstance(x, torch.Tensor)))
    w = jax.tree.leaves(jax.tree.map(np.asarray, want))
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == b.shape
        _close(a, b, tol)


def _cfgs(arch, **overrides):
    return (j_registry.smoke_config(arch, **overrides),
            t_registry.smoke_config(arch, **overrides))


def _layer(arch, zero_router=False, **overrides):
    """(jcfg, tcfg, reference MoE layer params, the port's copy)."""
    jcfg, tcfg = _cfgs(arch, **overrides)
    jp = j_moe.moe_init(jax.random.PRNGKey(3), jcfg, jnp.float32)
    if zero_router:
        jp["router"]["w"] = jnp.zeros_like(jp["router"]["w"])
    tp = t_transformer.params_from_jax(tcfg, jax.tree.map(np.asarray, jp),
                                       device="cpu")
    return jcfg, tcfg, jp, tp


def _x(b, s, d=64, seed=0):
    return np.random.default_rng(seed).normal(size=(b, s, d)).astype(
        np.float32)


def _apply_both(jcfg, tcfg, jp, tp, x, ids):
    jy, jaux = j_moe.moe_apply(jp, jnp.asarray(x), jcfg,
                               mask_ids=None if ids is None
                               else jnp.asarray(ids))
    ty, taux = t_moe.moe_apply(tp, torch.from_numpy(x), tcfg,
                               mask_ids=None if ids is None
                               else torch.from_numpy(ids))
    return (np.asarray(jy), float(jaux)), (ty.numpy(), float(taux))


@pytest.fixture(scope="module")
def stacks():
    out = {}

    def get(arch):
        if arch not in out:
            jcfg, tcfg = _cfgs(arch)
            jp = j_build_model(jcfg).init(jax.random.PRNGKey(0))
            tp = t_transformer.params_from_jax(
                tcfg, jax.tree.map(np.asarray, jp), device="cpu")
            out[arch] = (jcfg, tcfg, jp, tp)
        return out[arch]
    return get


# ---------------------------------------------------------------------------
# one MoE layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", (True, False))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_jax(arch, masked):
    """One layer at 32 tokens (one group): the output, with each row's mask
    id routed through the dispatch, and the aux loss; arctic adds its
    dense residual FFN, masked by the same ids."""
    jcfg, tcfg, jp, tp = _layer(arch)
    assert ("dense" in tp) == (arch == "arctic-480b")
    ids = np.arange(4, dtype=np.int32) if masked else None
    (jy, jaux), (ty, taux) = _apply_both(jcfg, tcfg, jp, tp, _x(4, 8), ids)
    _close(ty, jy)
    _close(taux, jaux)


@pytest.mark.parametrize("b,s,group", [(3, 30, 16), (2, 25, 16), (5, 7, 64)])
def test_moe_group_size_search_matches_jax(b, s, group):
    """Token counts the group size does not divide: the reference's divisor
    search (90 tokens -> groups of 18, 50 -> 25, 35 -> one group)."""
    jcfg, tcfg, jp, tp = _layer(ARCHS[0], moe_group_size=group)
    ids = np.arange(b, dtype=np.int32) % 4
    (jy, jaux), (ty, taux) = _apply_both(jcfg, tcfg, jp, tp, _x(b, s), ids)
    _close(ty, jy)
    _close(taux, jaux)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_drops_the_same_tokens_as_jax(arch):
    """capacity_factor 0.5: 4 slots an expert for 64 (token, choice) pairs
    over 8 experts, so most pairs are dropped. Both packages drop the same
    ones: the rows whose every choice was dropped are exactly zero in both
    (phi3.5; arctic's dense residual fills them), and every row agrees."""
    jcfg, tcfg, jp, tp = _layer(arch, capacity_factor=0.5)
    assert t_moe._capacity(tcfg, 32) == j_moe._capacity(jcfg, 32) == 4
    ids = np.arange(4, dtype=np.int32)
    (jy, _), (ty, _) = _apply_both(jcfg, tcfg, jp, tp, _x(4, 8, seed=1), ids)
    _close(ty, jy)
    if arch == "phi3.5-moe-42b-a6.6b":
        j_dropped = (jy == 0).all(-1)
        np.testing.assert_array_equal((ty == 0).all(-1), j_dropped)
        assert 0 < j_dropped.sum() < j_dropped.size
    # the same tokens at full capacity differ: the drops are real
    full = dataclasses.replace(tcfg, capacity_factor=4.0)
    y_full, _ = t_moe.moe_apply(tp, torch.from_numpy(_x(4, 8, seed=1)), full,
                                mask_ids=torch.from_numpy(ids))
    assert np.abs(y_full.numpy() - ty).max() > 1e-2


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ties_pick_the_lower_expert_like_jax(arch):
    """Zero router weights make every probability equal: both packages send
    every token to experts 0 and 1 (jax.lax.top_k's order on ties), and at
    capacity 0.5 drop the same tail of tokens."""
    ties = torch.zeros((2, 5, 8))
    vals, idx = t_moe.top_k(ties, 2)
    assert idx.tolist() == [[[0, 1]] * 5] * 2
    _, j_idx = jax.lax.top_k(jnp.zeros((2, 5, 8)), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    for cf in (4.0, 0.5):
        jcfg, tcfg, jp, tp = _layer(arch, zero_router=True,
                                    capacity_factor=cf)
        ids = np.arange(4, dtype=np.int32)
        (jy, jaux), (ty, taux) = _apply_both(jcfg, tcfg, jp, tp,
                                             _x(4, 8, seed=2), ids)
        _close(ty, jy)
        _close(taux, jaux)


def test_top_k_matches_jax_with_and_without_ties():
    rng = np.random.default_rng(4)
    x = rng.integers(0, 3, size=(6, 7, 16)).astype(np.float32) / 4
    for k in (1, 2, 5):
        vals, idx = t_moe.top_k(torch.from_numpy(x), k)
        j_vals, j_idx = jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(j_vals))


# ---------------------------------------------------------------------------
# the MoE stacks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_prefill_and_decode_match_jax(stacks, arch):
    jcfg, tcfg, jp, tp = stacks(arch)
    toks = np.random.default_rng(7).integers(0, 256, size=(4, 6)).astype(
        np.int32)
    ids = np.arange(4, dtype=np.int32)
    jl, jc = j_transformer.prefill(jcfg, jp, {"tokens": toks}, max_seq=9,
                                   mask_ids=jnp.asarray(ids))
    tl, tc = t_transformer.prefill(tcfg, tp, {"tokens": torch.from_numpy(
        toks)}, max_seq=9, mask_ids=torch.from_numpy(ids))
    _close(tl, jl)
    _tree_close(tc, jc)
    pos = np.array([6, 6, 3, 6], np.int32)
    nxt = toks[:, -1:]
    jl2, jc2 = j_transformer.decode_step(jcfg, jp, jc, nxt, pos,
                                         mask_ids=jnp.asarray(ids))
    tl2, tc2 = t_transformer.decode_step(tcfg, tp, tc, torch.from_numpy(nxt),
                                         torch.from_numpy(pos),
                                         mask_ids=torch.from_numpy(ids))
    _close(tl2, jl2)
    _tree_close(tc2, jc2)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_aux_matches_jax(stacks, arch):
    """forward's logits and the aux loss summed over the MoE layers, with
    the Masksembles batch-group assignment (no mask_ids)."""
    jcfg, tcfg, jp, tp = stacks(arch)
    toks = np.random.default_rng(8).integers(0, 256, size=(4, 9)).astype(
        np.int32)
    jl, jaux = j_transformer.forward(jcfg, jp, {"tokens": toks})
    tl, taux = t_transformer.forward(tcfg, tp,
                                     {"tokens": torch.from_numpy(toks)},
                                     device="cpu")
    _close(tl, jl)
    _close(taux, jaux)
    assert taux.dtype == torch.float32 and float(taux) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_serve_uncertain_matches_jax(stacks, arch):
    """Per-op decode and exact prefill (MoE has no fused lowering), equal
    tokens and flags, posteriors at the reference's bar."""
    jcfg, tcfg, jp, tp = stacks(arch)
    with pytest.raises(t_plan.FusedPlanUnsupported, match="moe"):
        t_plan.lower_fused_decode(tcfg)
    fns = t_server.step_fns(tcfg, device="cpu")
    assert fns.fused_spec is None and fns.prefill_spec is None
    toks = np.random.default_rng(5).integers(0, 256, size=(3, 7)).astype(
        np.int32)
    jg, ju, jf = j_engine.serve_uncertain(
        j_build_model(jcfg), jp, jnp.asarray(toks),
        j_engine.ServeConfig(fused=False, max_new_tokens=5))
    tg, tu, tf = t_engine.serve_uncertain(
        t_model.build_model(tcfg), tp, torch.from_numpy(toks),
        t_engine.ServeConfig(max_new_tokens=5), device="cpu")
    np.testing.assert_array_equal(np.asarray(tg), np.asarray(jg))
    _close(tu, ju, **POST)
    np.testing.assert_array_equal(np.asarray(tf), np.asarray(jf))
