"""The port's hybrid (RecurrentGemma) serving path and its two kernels'
modules against the JAX package, on the CPU.

Kernels: the plain versions of ``rglru_scan`` and ``flash_attention``
against the reference's plain versions and its kernel wrappers as its own
tests run them here (``repro.kernels.*.ops``: Pallas in interpret mode, or
its plain version). The CUDA kernels are held to the plain versions on the
card by tests/test_torch_cuda.py and chip_smoke.py.

Model: ``smoke_config("recurrentgemma-2b")`` (4 layers: rec, rec,
local_attn, rec; d 64, lru width 64, 4 heads, 1 KV head, dh 16, window 16,
vocab 256, N 4, fp32), the reference's weights from ``PRNGKey(0)`` carried
over by ``transformer.params_from_jax``, inputs from numpy seeds.

Tolerances, each fp32 with sums in another order than XLA's:
  * scan: 1e-6 against the reference's associative scan (the plain
    version repeats its odd/even order, so they meet to rounding), 1e-5
    against the reference's kernel wrapper (a sequential carry);
  * attention: 2e-5 (one softmax over <= 64 keys);
  * one block or one prefill/decode step: 1e-5 (TOL);
  * posteriors over several greedy steps: ``rtol=1e-4, atol=1e-5`` (POST,
    the reference's own fused-vs-per-op bar); generated tokens equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as j_registry
from repro.kernels.flash_attention import ops as j_fops
from repro.kernels.flash_attention import ref as j_fref
from repro.kernels.rglru_scan import ops as j_sops
from repro.kernels.rglru_scan import ref as j_sref
from repro.models import build_model as j_build_model
from repro.models import rglru as j_rglru
from repro.serving import engine as j_engine
from repro_torch.configs import registry as t_registry
from repro_torch.core import plan as t_plan
from repro_torch.kernels.flash_attention import ops as t_fops
from repro_torch.kernels.flash_attention import ref as t_fref
from repro_torch.kernels.rglru_scan import ops as t_sops
from repro_torch.kernels.rglru_scan import ref as t_sref
from repro_torch.models import model as t_model
from repro_torch.models import rglru as t_rglru
from repro_torch.models import transformer as t_transformer
from repro_torch.serving import engine as t_engine
from repro_torch.serving import server as t_server

ARCH = "recurrentgemma-2b"
TOL = 1e-5
TOL_SCAN_REF = 1e-6
TOL_ATTN = 2e-5
POST = dict(rtol=1e-4, atol=1e-5)


def _close(got, want, tol=TOL, **kw):
    kw = kw or dict(rtol=tol, atol=tol)
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **kw)


def _np_tree(tree):
    return jax.tree.map(lambda t: t.float().numpy(), tree,
                        is_leaf=lambda x: isinstance(x, torch.Tensor))


def _tree_close(got, want, tol=TOL):
    g = jax.tree.leaves(_np_tree(got))
    w = jax.tree.leaves(jax.tree.map(np.asarray, want))
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == b.shape
        _close(a, b, tol)


def _rng(seed=0):
    return np.random.default_rng(seed)


@pytest.fixture(scope="module")
def hybrid():
    jcfg = j_registry.smoke_config(ARCH)
    tcfg = t_registry.smoke_config(ARCH)
    jp = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    tp = t_transformer.params_from_jax(tcfg, jax.tree.map(np.asarray, jp),
                                       device="cpu")
    return jcfg, tcfg, jp, tp


def _prompts(b, plen, seed=1):
    return _rng(seed).integers(0, 256, size=(b, plen)).astype(np.int32)


# ---------------------------------------------------------------------------
# the rglru_scan kernel's module
# ---------------------------------------------------------------------------


def _gates(shape, seed):
    rng = _rng(seed)
    a = rng.uniform(0.85, 0.999, size=shape).astype(np.float32)
    b = (rng.normal(size=shape) * np.sqrt(1 - a * a)).astype(np.float32)
    return a, b


@pytest.mark.parametrize("shape", [(2, 1, 5), (3, 37, 11), (8, 64, 128),
                                   (4, 100, 17)])
def test_rglru_scan_plain_matches_jax(shape):
    a, b = _gates(shape, sum(shape))
    got = t_sops.rglru_scan(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32 and got.shape == shape
    _close(got, j_sref.rglru_scan_ref(jnp.asarray(a), jnp.asarray(b)),
           TOL_SCAN_REF)
    _close(got, j_sops.rglru_scan(jnp.asarray(a), jnp.asarray(b)))
    _close(t_sref.rglru_scan_ref(torch.from_numpy(a), torch.from_numpy(b)),
           got, 0.0)


def test_rglru_scan_plain_matches_step_recurrence():
    a, b = _gates((2, 40, 9), 3)
    h = np.zeros((2, 9), np.float32)
    want = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    got = t_sref.rglru_scan_ref(torch.from_numpy(a), torch.from_numpy(b))
    _close(got, np.stack(want, 1))


# ---------------------------------------------------------------------------
# models/rglru.py
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def rec_block(hybrid):
    jcfg, tcfg, _, _ = hybrid
    jp = j_rglru.rec_block_init(jax.random.PRNGKey(3), jcfg, jnp.float32)
    tp = t_transformer.params_from_jax(tcfg, jax.tree.map(np.asarray, jp),
                                       device="cpu")
    return jcfg, tcfg, jp, tp


def test_rglru_scan_and_step_match_jax(rec_block):
    _, _, jp, tp = rec_block
    x = _rng(4).normal(size=(3, 21, 64)).astype(np.float32)
    jy, jh = j_rglru.rglru_scan(jp["lru"], jnp.asarray(x))
    ty, th = t_rglru.rglru_scan(tp["lru"], torch.from_numpy(x))
    _close(ty, jy)
    _close(th, jh)
    h0 = _rng(5).normal(size=(3, 64)).astype(np.float32)
    jy, jh = j_rglru.rglru_step(jp["lru"], jnp.asarray(x[:, 0]),
                                jnp.asarray(h0))
    ty, th = t_rglru.rglru_step(tp["lru"], torch.from_numpy(x[:, 0]),
                                torch.from_numpy(h0))
    _close(ty, jy)
    _close(th, jh)


@pytest.mark.parametrize("s", (1, 2, 17))
def test_rec_block_apply_and_step_match_jax(rec_block, s):
    jcfg, tcfg, jp, tp = rec_block
    x = _rng(6 + s).normal(size=(2, s, 64)).astype(np.float32)
    jy, jst = j_rglru.rec_block_apply(jp, jnp.asarray(x), jcfg)
    ty, tst = t_rglru.rec_block_apply(tp, torch.from_numpy(x), tcfg)
    _close(ty, jy)
    _tree_close(tst, jst)
    x1 = _rng(9).normal(size=(2, 64)).astype(np.float32)
    jy, jst = j_rglru.rec_block_step(jp, jnp.asarray(x1), jst, jcfg)
    ty, tst = t_rglru.rec_block_step(tp, torch.from_numpy(x1), tst, tcfg)
    _close(ty, jy)
    _tree_close(tst, jst)
    assert tst["h"].dtype == torch.float32


def test_lambda_and_state_stay_fp32_in_bf16(rec_block):
    """``params_from_jax`` and ``init`` keep the RG-LRU's ``lambda`` fp32
    and ``init_cache`` keeps ``h`` fp32 in a bf16 model (rounding lambda
    would move every decay a); everything else is bf16."""
    jcfg, _, jp, _ = rec_block
    cfg = t_registry.smoke_config(ARCH, dtype=torch.bfloat16)
    tp = t_transformer.params_from_jax(cfg, jax.tree.map(np.asarray, jp),
                                       device="cpu")
    assert tp["lru"]["lambda"].dtype == torch.float32
    np.testing.assert_array_equal(tp["lru"]["lambda"].numpy(),
                                  np.asarray(jp["lru"]["lambda"]))
    assert tp["lru"]["wa"]["w"].dtype == torch.bfloat16
    assert tp["conv"].dtype == torch.bfloat16
    params = t_transformer.init(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    rec = params["segments"][0]["b0"]["rec"]
    assert rec["lru"]["lambda"].dtype == torch.float32
    assert rec["wgate"]["w"].dtype == torch.bfloat16
    caches = t_transformer.init_cache(cfg, 3, 8, device="cpu")
    assert caches[0]["b0"]["h"].dtype == torch.float32
    assert caches[0]["b0"]["conv"].dtype == torch.bfloat16
    specs = t_transformer.cache_specs(cfg, 3, 8)
    assert specs[0]["b0"] == {"h": ((1, 3, 64), torch.float32),
                              "conv": ((1, 3, 3, 64), torch.bfloat16)}
    state = t_rglru.rec_state_init(3, cfg, cfg.dtype, device="cpu")
    assert {k: (tuple(t.shape), t.dtype) for k, t in state.items()} == \
        t_rglru.rec_state_specs(3, cfg, cfg.dtype)
    assert not any(bool(t.any()) for t in state.values())
    # a bf16 prefill keeps h fp32 and the conv window bf16
    toks = torch.from_numpy(_prompts(2, 5))
    _, out = t_transformer.prefill(cfg, params, {"tokens": toks}, max_seq=8)
    assert out[1]["b0"]["h"].dtype == torch.float32
    assert out[1]["b0"]["conv"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the flash_attention kernel's module
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", (True, False))
@pytest.mark.parametrize("h,hkv", [(4, 1), (4, 2)])
def test_flash_plain_matches_jax(causal, h, hkv):
    rng = _rng(h + hkv + causal)
    b, s, dh = 2, 128, 16
    q, k, v = (rng.normal(size=(b, n, s, dh)).astype(np.float32) * 0.5
               for n in (h, hkv, hkv))
    got = t_fops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                 causal=causal)
    assert got.shape == (b, h, s, dh) and got.dtype == torch.float32
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    _close(got, j_fref.attention_ref(jq, jk, jv, causal=causal), TOL_ATTN)
    _close(got, j_fops.flash_attention(jq, jk, jv, causal=causal,
                                       block_q=64, block_k=64), TOL_ATTN)


def test_flash_plain_chunks_a_long_causal_prompt():
    """Past ``chunk`` query rows the plain version is the chunked prefill
    attention, which agrees with the full one."""
    rng = _rng(11)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 2, 48, 8))
                                .astype(np.float32)) for _ in range(3))
    _close(t_fref.flash_attention_ref(q, k, v, causal=True, chunk=16),
           t_fref.flash_attention_ref(q, k, v, causal=True), TOL_ATTN)


# ---------------------------------------------------------------------------
# the hybrid stack: prefill and decode against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rel", (-1, 0, 1, 16))
def test_hybrid_prefill_then_decode_matches_jax(hybrid, rel):
    """Prompts at w-1, w, w+1 and 2w: logits and every cache leaf (the
    rolling local-window cache and the rec state) equal the reference's,
    then four decode steps across the window boundary do too."""
    jcfg, tcfg, jp, tp = hybrid
    w = tcfg.local_window
    s = w + rel
    toks = _prompts(2, s, seed=20 + s)
    jm, tm = j_build_model(jcfg), t_model.build_model(tcfg)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, max_seq=s + 4)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                        max_seq=s + 4)
    _close(tl, jl)
    _tree_close(tc, jc)
    rec = tc[0]["b0"]
    assert rec["h"].dtype == torch.float32 and rec["h"].shape == (1, 2, 64)
    assert tc[0]["b2"]["kpos"].shape == (1, 2, min(w, s + 4))
    cur = np.asarray(jl).argmax(-1).astype(np.int32)
    for i in range(4):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(cur[:, None]),
                                jnp.int32(s + i))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(cur[:, None]),
                                s + i)
        _close(tl, jl)
        _tree_close(tc, jc)
        cur = np.asarray(jl).argmax(-1).astype(np.int32)


@pytest.mark.parametrize("s,flash", [(16, 1), (17, 0)])
def test_prefill_routes_kernels_by_shape(hybrid, monkeypatch, s, flash):
    """The prefill calls the scan wrapper once per rec block and the flash
    wrapper once per local-attention block whose window does not cut the
    prompt (s <= window); a longer prompt keeps the banded attention."""
    _, tcfg, _, tp = hybrid
    calls = {"scan": 0, "flash": 0}
    plain_scan, plain_flash = t_sops.rglru_scan, t_fops.flash_attention

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(t_rglru.scan_ops, "rglru_scan",
                        spy("scan", plain_scan))
    monkeypatch.setattr(t_transformer.flash_ops, "flash_attention",
                        spy("flash", plain_flash))
    toks = torch.from_numpy(_prompts(1, s))
    t_transformer.prefill(tcfg, tp, {"tokens": toks}, max_seq=s + 1)
    assert calls == {"scan": 3, "flash": flash}
    _, caches = t_transformer.prefill(tcfg, tp, {"tokens": toks[:, :4]},
                                      max_seq=5)
    calls.update(scan=0, flash=0)
    t_transformer.decode_step(tcfg, tp, caches, toks[:, 4:5], 4)
    assert calls == {"scan": 0, "flash": 0}


def test_dense_prefill_routes_flash_per_layer(monkeypatch):
    cfg = t_registry.smoke_config("qwen2-1.5b", n_layers=2)
    params = t_transformer.init(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    calls, plain = [], t_fops.flash_attention
    monkeypatch.setattr(
        t_transformer.flash_ops, "flash_attention",
        lambda *a, **kw: calls.append(kw) or plain(*a, **kw))
    toks = torch.from_numpy(_prompts(2, 7))
    t_transformer.prefill(cfg, params, {"tokens": toks}, max_seq=9)
    assert calls == [dict(causal=True, chunk=cfg.attn_chunk)] * 2
    calls.clear()
    cfg16 = dataclasses.replace(cfg, attn_scores_f32=False)
    t_transformer.prefill(cfg16, params, {"tokens": toks}, max_seq=9)
    assert not calls        # bf16 scores are another function


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def test_step_fns_pick_per_op_decode_and_exact_prefill(hybrid):
    _, tcfg, _, tp = hybrid
    with pytest.raises(t_plan.FusedPlanUnsupported, match="rec"):
        t_plan.lower_fused_decode(tcfg)
    with pytest.raises(t_plan.FusedPlanUnsupported):
        t_plan.prefill_fused_spec(tcfg)
    fns = t_server.step_fns(tcfg, device="cpu")
    assert fns.fused_spec is None and fns.prefill_spec is None
    toks = torch.from_numpy(np.tile(_prompts(2, 6, seed=7), (4, 1)))
    _, _, caches = fns.prefill(tp, toks, max_seq=9)
    fns.decode(tp, caches, toks[:, -1:], 6)
    assert fns.counts == {"prefill_exact": 1, "decode_per_op": 1}
    assert not fns.fused_live()
    with pytest.raises(t_plan.FusedPlanUnsupported):
        t_server.step_fns(tcfg, fused=True, device="cpu")
    with pytest.raises(ValueError, match="recurrent state"):
        t_transformer.cache_trim_positions(caches, 3)


def test_serve_uncertain_matches_jax(hybrid):
    jcfg, tcfg, jp, tp = hybrid
    toks = _prompts(3, 14, seed=5)
    scfg = dict(max_new_tokens=6)     # decodes across the 16-token window
    jg, ju, jf = j_engine.serve_uncertain(
        j_build_model(jcfg), jp, jnp.asarray(toks),
        j_engine.ServeConfig(fused=False, **scfg))
    tg, tu, tf = t_engine.serve_uncertain(
        t_model.build_model(tcfg), tp, torch.from_numpy(toks),
        t_engine.ServeConfig(**scfg), device="cpu")
    np.testing.assert_array_equal(np.asarray(tg), np.asarray(jg))
    _close(tu, ju, **POST)
    np.testing.assert_array_equal(np.asarray(tf), np.asarray(jf))


def test_generate_matches_jax(hybrid):
    jcfg, tcfg, jp, tp = hybrid
    toks = _prompts(2, 15, seed=6)
    want = j_engine.generate(j_build_model(jcfg), jp, jnp.asarray(toks),
                             j_engine.ServeConfig(max_new_tokens=4,
                                                  fused=False))
    got = t_engine.generate(t_model.build_model(tcfg), tp,
                            torch.from_numpy(toks),
                            t_engine.ServeConfig(max_new_tokens=4),
                            device="cpu")
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("arch", ("xlstm-350m", "arctic-480b",
                                  "qwen2-vl-72b", "hubert-xlarge"))
def test_unported_families_still_raise(arch):
    """Nothing is left unported: each family builds beside the hybrid with
    the reference's parameter layout, and a hybrid stack holding its block
    kinds (or, for the attention-only families, its config's attention
    form) builds the reference's tree too."""
    from test_torch_lm import assert_reference_layout
    tcfg, _ = assert_reference_layout(arch)
    assert_reference_layout(ARCH)
    kinds = {k for seg in tcfg.segments() for k in seg.pattern}
    if kinds - {"attn"}:
        assert_reference_layout(ARCH, segments_override=(
            (("rec", "rec", "local_attn"), 1), (tuple(sorted(kinds)), 1)),
            **({"n_experts": 8, "top_k": 2} if "moe" in kinds else {}))
