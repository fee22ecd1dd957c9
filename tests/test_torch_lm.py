"""The port's LM layers and transformer against the JAX package, on the CPU.

The same numpy inputs go through the reference (``repro.models``) and the
port (``repro_torch.models``); the reference's weights from
``PRNGKey(0)`` cross over through ``transformer.params_from_jax``. Model:
``smoke_config("qwen2-1.5b", n_layers=2)`` (d 64, 4 heads, 2 KV heads,
dh 16, d_ff 128, vocab 256, N 4, fp32). Tolerance 1e-5 throughout: one
fp32 forward pass, sums taken in another order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as j_registry
from repro.models import build_model as j_build_model
from repro.models import layers as j_layers
from repro.models import transformer as j_transformer
from repro_torch.configs import registry as t_registry
from repro_torch.models import layers as t_layers
from repro_torch.models import model as t_model
from repro_torch.models import transformer as t_transformer

TOL = 1e-5


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _tree_close(got, want, tol=TOL):
    g_leaves = jax.tree.leaves(jax.tree.map(
        np.asarray, got, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    w_leaves = jax.tree.leaves(want)
    assert len(g_leaves) == len(w_leaves)
    for g, w in zip(g_leaves, w_leaves):
        assert g.shape == w.shape
        _close(g, w, tol)


def _cfgs(**overrides):
    return (j_registry.smoke_config("qwen2-1.5b", n_layers=2, **overrides),
            t_registry.smoke_config("qwen2-1.5b", n_layers=2, **overrides))


def _port_params(jcfg, tcfg, key=0):
    jp = j_build_model(jcfg).init(jax.random.PRNGKey(key))
    return jp, t_transformer.params_from_jax(
        tcfg, jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def qwen():
    jcfg, tcfg = _cfgs()
    jp, tp = _port_params(jcfg, tcfg)
    return jcfg, tcfg, jp, tp


def _rng(seed=0):
    return np.random.default_rng(seed)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ("rmsnorm", "layernorm"))
def test_norm_apply_matches_jax(kind):
    rng = _rng(1)
    x = rng.normal(size=(3, 5, 24)).astype(np.float32) * 2 + 0.5
    p = {"scale": rng.normal(size=24).astype(np.float32)}
    if kind == "layernorm":
        p["bias"] = rng.normal(size=24).astype(np.float32)
    want = j_layers.norm_apply(p, x, kind)
    got = t_layers.norm_apply({k: torch.from_numpy(v) for k, v in p.items()},
                              torch.from_numpy(x), kind)
    _close(got, want)


@pytest.mark.parametrize("rope_pct", (1.0, 0.25))
def test_rope_matches_jax(rope_pct):
    rng = _rng(2)
    x = rng.normal(size=(2, 3, 7, 16)).astype(np.float32)
    pos = np.array([0, 3, 9, 17, 100, 4096, 77], np.int32)
    rot = int(16 * rope_pct)
    jc, js = j_layers.rope_cos_sin(jnp.asarray(pos), rot, 1e6)
    tc, ts = t_layers.rope_cos_sin(torch.from_numpy(pos), rot, 1e6)
    _close(tc, jc)
    _close(ts, js)
    _close(t_layers.apply_rope(torch.from_numpy(x), tc, ts, rope_pct),
           j_layers.apply_rope(x, jc, js, rope_pct))


@pytest.mark.parametrize("per_row", (False, True))
def test_attention_decode_matches_jax(per_row):
    rng = _rng(3)
    b, h, hkv, s, dh = 5, 4, 2, 9, 16
    q = rng.normal(size=(b, h, 1, dh)).astype(np.float32)
    k = rng.normal(size=(b, hkv, s, dh)).astype(np.float32)
    v = rng.normal(size=(b, hkv, s, dh)).astype(np.float32)
    kpos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    kpos[:, 7:] = -1
    pos = (np.array([6, 3, 0, 6, 5], np.int32) if per_row
           else np.int32(5))
    want = j_layers.attention_decode(q, k, v, kpos, pos)
    got = t_layers.attention_decode(*map(torch.from_numpy, (q, k, v, kpos)),
                                    torch.as_tensor(pos))
    _close(got, want)


@pytest.mark.parametrize("pos,window", [
    (np.int32(4), 0), (np.array([0, 5, 8], np.int32), 0),
    (np.array([3, 7, 12], np.int32), 4), (np.int32(9), 4)])
def test_kv_cache_update_matches_jax(pos, window):
    rng = _rng(4)
    b, hkv, s, dh = 3, 2, 9 if not window else 4, 8
    cache = j_layers.init_kv_cache(b, hkv, s, dh, jnp.float32)
    kn = rng.normal(size=(b, hkv, 1, dh)).astype(np.float32)
    vn = rng.normal(size=(b, hkv, 1, dh)).astype(np.float32)
    want = j_layers.kv_cache_update(cache, kn, vn, pos, window)
    tcache = t_layers.init_kv_cache(b, hkv, s, dh, torch.float32,
                                    device="cpu")
    got = t_layers.kv_cache_update(tcache, torch.from_numpy(kn),
                                   torch.from_numpy(vn),
                                   torch.as_tensor(pos), window)
    for name in ("k", "v", "kpos"):
        np.testing.assert_array_equal(np.asarray(got[name]),
                                      np.asarray(want[name]))
    assert int(tcache["kpos"].max()) == -1        # functional: input intact


@pytest.mark.parametrize("arch,packed", [("qwen2-1.5b", False),
                                         ("qwen2-1.5b", True),
                                         ("granite-20b", False)])
def test_ffn_apply_matches_jax(arch, packed):
    jcfg = j_registry.smoke_config(arch, packed_ffn_serving=packed)
    tcfg = t_registry.smoke_config(arch, packed_ffn_serving=packed)
    jp = j_layers.ffn_init(jax.random.PRNGKey(5), jcfg)
    # non-zero biases so the plain-MLP bias terms are exercised
    jp = jax.tree.map(lambda a: a + 0.01 if a.ndim == 1 else a, jp)
    tp = t_transformer.params_from_jax(tcfg, jax.tree.map(np.asarray, jp),
                                       device="cpu")
    x = _rng(6).normal(size=(8, 3, 64)).astype(np.float32)
    ids = np.repeat(np.arange(4), 2).astype(np.int32)
    want = j_layers.ffn_apply(jp, x, jcfg, mask_ids=jnp.asarray(ids))
    got = t_layers.ffn_apply(tp, torch.from_numpy(x), tcfg,
                             mask_ids=torch.from_numpy(ids).long())
    _close(got, want)


def test_init_tree_matches_jax_layout(qwen):
    jcfg, tcfg, jp, _ = qwen
    tp = t_transformer.init(tcfg, torch.Generator().manual_seed(0),
                            device="cpu")
    j_shapes = jax.tree.map(lambda a: (a.shape, str(a.dtype)), jp)
    t_shapes = jax.tree.map(
        lambda a: (tuple(a.shape), str(a.dtype).replace("torch.", "")), tp,
        is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert jax.tree.structure(j_shapes, is_leaf=lambda x: isinstance(
        x, tuple)) == jax.tree.structure(t_shapes, is_leaf=lambda x:
                                         isinstance(x, tuple))
    assert jax.tree.leaves(j_shapes, is_leaf=lambda x: isinstance(
        x, tuple)) == jax.tree.leaves(t_shapes, is_leaf=lambda x:
                                      isinstance(x, tuple))
    _close(tp["segments"][0]["b0"]["ffn"]["masks"],
           jp["segments"][0]["b0"]["ffn"]["masks"], 0)


def test_pack_ffn_params_matches_jax(qwen):
    jcfg, tcfg, jp, tp = qwen
    _tree_close(t_transformer.pack_ffn_params(tcfg, tp),
                j_transformer.pack_ffn_params(jcfg, jp), 0)


# ---------------------------------------------------------------------------
# the transformer: prefill and decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mask_samples", (4, 1))
def test_prefill_and_decode_match_jax(mask_samples, qwen):
    if mask_samples == 4:
        jcfg, tcfg, jp, tp = qwen
    else:
        jcfg, tcfg = _cfgs(mask_samples=mask_samples)
        jp, tp = _port_params(jcfg, tcfg)
    toks = _rng(7).integers(0, 256, size=(4, 6)).astype(np.int32)
    ids = np.repeat(np.arange(jcfg.mask_samples), 4 // jcfg.mask_samples)
    jl, jc = j_transformer.prefill(jcfg, jp, {"tokens": toks}, max_seq=9,
                                   mask_ids=jnp.asarray(ids), last_index=4)
    tl, tc = t_transformer.prefill(tcfg, tp, {"tokens": torch.from_numpy(
        toks)}, max_seq=9, mask_ids=torch.from_numpy(ids), last_index=4)
    _close(tl, jl)
    _tree_close(tc, jc)
    nxt = toks[:, -1:]
    pos = np.array([6, 6, 3, 6], np.int32)
    jl2, jc2 = j_transformer.decode_step(jcfg, jp, jc, nxt, pos,
                                         mask_ids=jnp.asarray(ids))
    tl2, tc2 = t_transformer.decode_step(tcfg, tp, tc, torch.from_numpy(nxt),
                                         torch.from_numpy(pos),
                                         mask_ids=torch.from_numpy(ids))
    _close(tl2, jl2)
    _tree_close(tc2, jc2)


def test_prefill_attention_forms_match_jax():
    """Long prompts take the chunked (global) and banded (local window)
    prefill attention; both agree with the reference."""
    jcfg, tcfg = _cfgs(attn_chunk=4)
    jp, tp = _port_params(jcfg, tcfg)
    toks = _rng(8).integers(0, 256, size=(4, 8)).astype(np.int32)
    jl, _ = j_transformer.prefill(jcfg, jp, {"tokens": toks})
    tl, _ = t_transformer.prefill(tcfg, tp, {"tokens": torch.from_numpy(
        toks)})
    _close(tl, jl)
    over = dict(local_window=4, segments_override=((("local_attn",), 2),))
    jcfg, tcfg = _cfgs(**over)
    jp, tp = _port_params(jcfg, tcfg)
    jl, jc = j_transformer.prefill(jcfg, jp, {"tokens": toks}, max_seq=12)
    tl, tc = t_transformer.prefill(tcfg, tp, {"tokens": torch.from_numpy(
        toks)}, max_seq=12)
    _close(tl, jl)
    _tree_close(tc, jc)


def test_cache_trim_positions_matches_jax(qwen):
    jcfg, tcfg, jp, tp = qwen
    toks = _rng(9).integers(0, 256, size=(4, 6)).astype(np.int32)
    _, jc = j_transformer.prefill(jcfg, jp, {"tokens": toks}, max_seq=8)
    _, tc = t_transformer.prefill(tcfg, tp, {"tokens": torch.from_numpy(
        toks)}, max_seq=8)
    _tree_close(t_transformer.cache_trim_positions(tc, 3),
                j_transformer.cache_trim_positions(jc, 3))


def _shapes(tree):
    """``(shape, dtype name)`` leaves of a reference or port tree."""
    return jax.tree.map(
        lambda a: (tuple(a.shape), str(a.dtype).replace("torch.", "")),
        tree, is_leaf=lambda x: isinstance(x, torch.Tensor))


def assert_reference_layout(arch, **overrides):
    """The port builds ``smoke_config(arch)`` and its ``init`` holds the
    reference's tree: the same paths, shapes and dtypes (and its masks)."""
    jcfg = j_registry.smoke_config(arch, **overrides)
    tcfg = t_registry.smoke_config(arch, **overrides)
    model = t_model.build_model(tcfg)
    tp = model.init(torch.Generator().manual_seed(0), device="cpu")
    jp = jax.eval_shape(lambda: j_build_model(jcfg).init(
        jax.random.PRNGKey(0)))
    is_pair = lambda x: isinstance(x, tuple)      # noqa: E731
    j_shapes, t_shapes = _shapes(jp), _shapes(tp)
    assert jax.tree.structure(j_shapes, is_leaf=is_pair) == \
        jax.tree.structure(t_shapes, is_leaf=is_pair)
    assert jax.tree.leaves(j_shapes, is_leaf=is_pair) == \
        jax.tree.leaves(t_shapes, is_leaf=is_pair)
    j_masks = [np.asarray(m) for path, m in jax.tree_util.tree_leaves_with_path(
        j_build_model(jcfg).init(jax.random.PRNGKey(0)))
        if "masks" in jax.tree_util.keystr(path)]
    t_masks = [m for path, m in jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.numpy(), tp,
                     is_leaf=lambda x: isinstance(x, torch.Tensor)))
        if "masks" in jax.tree_util.keystr(path)]
    assert len(t_masks) == len(j_masks) > 0
    for got, want in zip(t_masks, j_masks):
        _close(got, want, 0)
    return tcfg, model


@pytest.mark.parametrize("arch", ("phi3.5-moe-42b-a6.6b",
                                  "recurrentgemma-2b", "xlstm-350m",
                                  "hubert-xlarge", "qwen2-vl-72b"))
def test_later_slice_families_raise(arch):
    """The families of the later slices build, with the reference's
    parameter layout; only a block kind no family has raises
    (``ValueError``, as in the reference), here in a hybrid stack."""
    assert_reference_layout(arch)
    if arch == "recurrentgemma-2b":
        cfg = dataclasses.replace(t_registry.smoke_config(arch),
                                  segments_override=(
            (("rec", "rec", "local_attn"), 1), (("conv",), 1)))
        with pytest.raises(ValueError, match="unknown block kind conv"):
            t_transformer.init(cfg, torch.Generator(), device="cpu")
        with pytest.raises(ValueError, match="conv"):
            t_transformer.init_cache(cfg, 1, 4, device="cpu")


def test_config_is_hashable_and_matches_reference():
    jcfg = j_registry.get_config("qwen2-1.5b", mask_samples=4)
    tcfg = t_registry.get_config("qwen2-1.5b", mask_samples=4)
    assert hash(tcfg) == hash(dataclasses.replace(tcfg))
    assert tcfg.param_count() == jcfg.param_count()
    fields = [f.name for f in dataclasses.fields(jcfg)]
    assert fields == [f.name for f in dataclasses.fields(tcfg)]
    for name in fields:
        if name != "dtype":
            assert getattr(tcfg, name) == getattr(jcfg, name), name
    assert tcfg.dtype == torch.bfloat16
    for arch in j_registry.ARCH_IDS:
        assert t_registry.get_config(arch).segments() == tuple(
            t_registry.get_config(arch).segments())
        assert [(s.pattern, s.reps) for s in
                t_registry.smoke_config(arch).segments()] == \
            [(s.pattern, s.reps) for s in
             j_registry.smoke_config(arch).segments()]
