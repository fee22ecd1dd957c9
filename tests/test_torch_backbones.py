"""The port's remaining input forms against the JAX package, on the CPU:
M-RoPE and embeddings input (qwen2-vl), the encoder-only stack's
``forward`` (hubert) through the non-causal arm of the ``flash_attention``
kernel's plain version, the packing of MoE and xLSTM trees, and
``forward`` for every architecture of the registry.

Models: ``smoke_config(arch)`` of each registry architecture (2 layers,
or 4 for the hybrid and xLSTM; d 64, dh 16, vocab 256, N 4, fp32; qwen2-vl
with M-RoPE sections (2, 3, 3)), the reference's weights from
``PRNGKey(0)`` carried over by ``transformer.params_from_jax``, inputs from
numpy seeds. Tolerance 1e-5 (one fp32 forward, sums in another order),
``rtol=atol=1e-4`` for the xLSTM stack (its exponential gates,
tests/test_torch_xlstm.py), posteriors over greedy steps ``rtol=1e-4,
atol=1e-5``; tokens equal.
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
from repro.serving import engine as j_engine
from repro_torch.configs import registry as t_registry
from repro_torch.core import plan as t_plan
from repro_torch.kernels.flash_attention import ops as t_fops
from repro_torch.models import layers as t_layers
from repro_torch.models import model as t_model
from repro_torch.models import transformer as t_transformer
from repro_torch.serving import engine as t_engine

TOL = 1e-5
POST = dict(rtol=1e-4, atol=1e-5)


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


@pytest.fixture(scope="module")
def pair():
    out = {}

    def get(arch, **overrides):
        key = (arch, tuple(sorted(overrides.items())))
        if key not in out:
            jcfg = j_registry.smoke_config(arch, **overrides)
            tcfg = t_registry.smoke_config(arch, **overrides)
            jp = j_build_model(jcfg).init(jax.random.PRNGKey(0))
            tp = t_transformer.params_from_jax(
                tcfg, jax.tree.map(np.asarray, jp), device="cpu")
            out[key] = (jcfg, tcfg, jp, tp)
        return out[key]
    return get


def _rng(seed):
    return np.random.default_rng(seed)


def _vl_positions(b, grid, text, image_at=0):
    """Qwen2-VL's three position streams [3, B, S] for ``image_at`` text
    tokens, a ``grid x grid`` image (temporal fixed, height and width
    walking the grid) and ``text`` tokens after it (all three streams
    equal, continuing from the largest position so far + 1); row r's
    positions are shifted by r, so every row differs."""
    t, h, w = [], [], []
    for i in range(image_at):
        t.append(i), h.append(i), w.append(i)
    for i in range(grid * grid):
        t.append(image_at), h.append(image_at + i // grid)
        w.append(image_at + i % grid)
    nxt = max(t + h + w) + 1
    for i in range(text):
        t.append(nxt + i), h.append(nxt + i), w.append(nxt + i)
    base = np.array([t, h, w], np.int32)                     # [3, S]
    return base[:, None, :] + np.arange(b, dtype=np.int32)[None, :, None]


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(3, 7), (3, 2, 7)])
def test_mrope_cos_sin_matches_jax(shape):
    pos = _rng(0).integers(0, 500, size=shape).astype(np.int32)
    for rot, sections in ((16, (2, 3, 3)), (128, (16, 24, 24))):
        jc, js = j_layers.mrope_cos_sin(jnp.asarray(pos), rot, 1e6, sections)
        tc, ts = t_layers.mrope_cos_sin(torch.from_numpy(pos), rot, 1e6,
                                        sections)
        assert tuple(tc.shape) == shape[1:] + (rot // 2,)
        _close(tc, jc)
        _close(ts, js)


def test_mrope_sections_must_cover_the_rotary_half():
    pos = torch.zeros((3, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="must sum to rot_dim/2"):
        t_layers.mrope_cos_sin(pos, 16, 1e6, (2, 3, 2))
    with pytest.raises(ValueError, match="must sum to rot_dim/2"):
        j_layers.mrope_cos_sin(jnp.zeros((3, 4), jnp.int32), 16, 1e6,
                               (2, 3, 2))


def test_mrope_one_stream_equals_plain_rope():
    """Equal streams make M-RoPE plain RoPE: a 1-D position input is
    broadcast to the three streams."""
    cfg = t_registry.smoke_config("qwen2-vl-72b")
    pos = torch.arange(9, dtype=torch.int32)
    mc, ms = t_transformer._rope(cfg, pos)
    pc, ps = t_layers.rope_cos_sin(pos, 16, cfg.rope_theta)
    _close(mc[0, 0], pc, 0)
    _close(ms[0, 0], ps, 0)


# ---------------------------------------------------------------------------
# qwen2-vl: embeddings in, [3, B, S] positions, decode by tokens
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("form", ("rows", "shared", "default"))
def test_vlm_prefill_embeds_then_decode_match_jax(pair, form):
    """Prefill over ``embeds`` [B, S, D] with positions [3, B, S] (an image
    grid, then text), [3, S] shared by the rows, or the default; then three
    decode steps by tokens at per-row positions — the rope position and the
    cache slot both ``pos``, as in the reference."""
    jcfg, tcfg, jp, tp = pair("qwen2-vl-72b")
    b, grid, text = 4, 2, 5
    s = grid * grid + text + 1
    emb = _rng(1).normal(size=(b, s, 64)).astype(np.float32)
    jb, tb = {"embeds": jnp.asarray(emb)}, {"embeds": torch.from_numpy(emb)}
    if form != "default":
        pos = _vl_positions(b, grid, text, image_at=1)
        if form == "shared":
            pos = pos[:, 0]
        jb["positions"], tb["positions"] = jnp.asarray(pos), \
            torch.from_numpy(pos)
    ids = np.arange(4, dtype=np.int32)
    jl, jc = j_transformer.prefill(jcfg, jp, jb, max_seq=s + 3,
                                   mask_ids=jnp.asarray(ids))
    tl, tc = t_transformer.prefill(tcfg, tp, tb, max_seq=s + 3,
                                   mask_ids=torch.from_numpy(ids))
    _close(tl, jl)
    _tree_close(tc, jc)
    cur = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
    for i in range(3):
        pos = np.array([s + i] * 3 + [s - 2 + i], np.int32)
        jl, jc = j_transformer.decode_step(jcfg, jp, jc, cur, pos,
                                           mask_ids=jnp.asarray(ids))
        tl, tc = t_transformer.decode_step(
            tcfg, tp, tc, torch.from_numpy(cur), torch.from_numpy(pos),
            mask_ids=torch.from_numpy(ids))
        _close(tl, jl)
        _tree_close(tc, jc)
        cur = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
    # a scalar position: the [3, 1] form
    jl, _ = j_transformer.decode_step(jcfg, jp, jc, cur, s + 3,
                                      mask_ids=jnp.asarray(ids))
    tl, _ = t_transformer.decode_step(tcfg, tp, tc, torch.from_numpy(cur),
                                      s + 3, mask_ids=torch.from_numpy(ids))
    _close(tl, jl)


def test_embeds_are_cast_to_the_model_dtype(pair):
    """fp64 embeddings go in at ``cfg.dtype``, as the reference's
    ``_embed_in`` casts them; the logits equal an fp32 input's."""
    _, tcfg, _, tp = pair("qwen2-vl-72b")
    emb = _rng(2).normal(size=(2, 6, 64))
    l64, _ = t_transformer.prefill(tcfg, tp,
                                   {"embeds": torch.from_numpy(emb)})
    l32, _ = t_transformer.prefill(tcfg, tp, {"embeds": torch.from_numpy(
        emb.astype(np.float32))})
    assert l64.dtype == torch.float32
    assert torch.equal(l64, l32)


def test_vlm_serve_uncertain_by_tokens_matches_jax(pair):
    jcfg, tcfg, jp, tp = pair("qwen2-vl-72b")
    with pytest.raises(t_plan.FusedPlanUnsupported, match="M-RoPE"):
        t_plan.lower_fused_decode(tcfg)
    toks = _rng(5).integers(0, 256, size=(3, 7)).astype(np.int32)
    jg, ju, jf = j_engine.serve_uncertain(
        j_build_model(jcfg), jp, jnp.asarray(toks),
        j_engine.ServeConfig(fused=False, max_new_tokens=5))
    tg, tu, tf = t_engine.serve_uncertain(
        t_model.build_model(tcfg), tp, torch.from_numpy(toks),
        t_engine.ServeConfig(max_new_tokens=5), device="cpu")
    np.testing.assert_array_equal(np.asarray(tg), np.asarray(jg))
    _close(tu, ju, **POST)
    np.testing.assert_array_equal(np.asarray(tf), np.asarray(jf))


# ---------------------------------------------------------------------------
# hubert: the encoder-only forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masks", ("rows", "default"))
def test_encoder_forward_matches_jax(pair, masks):
    """Full (non-causal) attention over embeddings: logits at every frame,
    with explicit per-row mask ids or the Masksembles batch-group
    assignment. ``Model.forward`` is the same function."""
    jcfg, tcfg, jp, tp = pair("hubert-xlarge")
    assert not tcfg.causal and not tcfg.has_decode
    emb = _rng(3).normal(size=(4, 11, 64)).astype(np.float32)
    ids = np.array([2, 0, 3, 1], np.int32) if masks == "rows" else None
    jl, jaux = j_transformer.forward(
        jcfg, jp, {"embeds": jnp.asarray(emb)},
        mask_ids=None if ids is None else jnp.asarray(ids))
    tl, taux = t_transformer.forward(
        tcfg, tp, {"embeds": torch.from_numpy(emb)},
        mask_ids=None if ids is None else torch.from_numpy(ids),
        device="cpu")
    assert tuple(tl.shape) == (4, 11, tcfg.vocab_size)
    _close(tl, jl)
    assert float(taux) == float(jaux) == 0.0
    ml, _ = t_model.build_model(tcfg).forward(
        tp, {"embeds": torch.from_numpy(emb)},
        mask_ids=None if ids is None else torch.from_numpy(ids),
        device="cpu")
    assert torch.equal(ml, tl)


@pytest.mark.parametrize("arch", ("hubert-xlarge", "qwen2-vl-72b"))
def test_only_the_encoder_sees_the_future(pair, arch):
    """Another last frame moves the first frame's logits in the encoder;
    the causal stack leaves them bitwise equal."""
    _, tcfg, _, tp = pair(arch)
    rng = _rng(4)
    emb = torch.from_numpy(rng.normal(size=(1, 8, 64)).astype(np.float32))
    a, _ = t_transformer.forward(tcfg, tp, {"embeds": emb}, device="cpu")
    emb[:, -1] = torch.from_numpy(rng.normal(size=64).astype(np.float32))
    b, _ = t_transformer.forward(tcfg, tp, {"embeds": emb}, device="cpu")
    moved = float((a[:, 0] - b[:, 0]).abs().max())
    if tcfg.causal:
        assert moved == 0.0
    else:
        assert moved > 1e-3


def _spy_flash(monkeypatch):
    calls, plain = [], t_fops.flash_attention
    monkeypatch.setattr(
        t_transformer.flash_ops, "flash_attention",
        lambda *a, **kw: calls.append((tuple(a[0].shape), kw))
        or plain(*a, **kw))
    return calls


@pytest.mark.parametrize("arch,causal", [("hubert-xlarge", False),
                                         ("qwen2-vl-72b", True),
                                         ("phi3.5-moe-42b-a6.6b", True),
                                         ("arctic-480b", True)])
def test_prefill_and_forward_route_flash_by_shape(pair, monkeypatch, arch,
                                                  causal):
    """Every attention layer of a forward or prefill calls the flash wrapper
    once, causal for the decoder stacks and full (Sq == Skv) for the
    encoder; decode never does. A windowed full attention, which the kernel
    does not mask, keeps the plain full attention."""
    _, tcfg, _, tp = pair(arch)
    calls = _spy_flash(monkeypatch)
    b, s = 4, 9
    batch = ({"embeds": torch.from_numpy(_rng(6).normal(
        size=(b, s, 64)).astype(np.float32))} if tcfg.embeds_input
        else {"tokens": torch.from_numpy(_rng(6).integers(
            0, 256, size=(b, s)).astype(np.int32))})
    want = [((b, tcfg.n_heads, s, 16),
             dict(causal=causal, chunk=tcfg.attn_chunk))] * tcfg.n_layers
    t_transformer.forward(tcfg, tp, batch, device="cpu")
    assert calls == want
    calls.clear()
    _, caches = t_transformer.prefill(tcfg, tp, batch, max_seq=s + 1)
    assert calls == want
    calls.clear()
    if tcfg.has_decode:
        tok = torch.zeros((b, 1), dtype=torch.int32)
        t_transformer.decode_step(tcfg, tp, caches, tok, s)
        assert not calls
    windowed = dataclasses.replace(
        tcfg, causal=False, local_window=4,
        segments_override=((("local_attn",), 1),))
    p1 = t_transformer.init(windowed, torch.Generator().manual_seed(0),
                            device="cpu")
    x = torch.from_numpy(_rng(7).normal(size=(2, 3, 64)).astype(np.float32))
    t_transformer.forward(windowed, p1, {"embeds": x}, device="cpu")
    assert not calls


# ---------------------------------------------------------------------------
# every architecture: forward, pack_ffn_params
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", j_registry.ARCH_IDS)
def test_forward_matches_jax_for_every_arch(pair, arch):
    """``forward`` (logits at every position, the MoE aux loss) against the
    reference's inference graph, with per-row mask ids."""
    jcfg, tcfg, jp, tp = pair(arch)
    b, s = 4, 9
    if tcfg.embeds_input:
        emb = _rng(8).normal(size=(b, s, 64)).astype(np.float32)
        jb, tb = {"embeds": jnp.asarray(emb)}, {"embeds": torch.from_numpy(
            emb)}
    else:
        toks = _rng(8).integers(0, 256, size=(b, s)).astype(np.int32)
        jb, tb = {"tokens": toks}, {"tokens": torch.from_numpy(toks)}
    ids = np.arange(4, dtype=np.int32)
    jl, jaux = j_transformer.forward(jcfg, jp, jb, mask_ids=jnp.asarray(ids))
    tl, taux = t_transformer.forward(tcfg, tp, tb,
                                     mask_ids=torch.from_numpy(ids),
                                     device="cpu")
    kw = dict(rtol=1e-4, atol=1e-4) if tcfg.family == "ssm" else {}
    _close(tl, jl, **kw)
    _close(taux, jaux)


@pytest.mark.parametrize("arch", ("phi3.5-moe-42b-a6.6b", "arctic-480b",
                                  "xlstm-350m"))
def test_pack_ffn_params_keeps_moe_and_xlstm_masks(pair, arch):
    """Blocks without a dense ``ffn`` (MoE experts, arctic's dense residual,
    the xLSTM blocks' internal masks) keep the multiply form, as the
    reference leaves them; the tree equals the reference's."""
    jcfg, tcfg, jp, tp = pair(arch)
    packed = t_transformer.pack_ffn_params(tcfg, tp)
    _tree_close(packed, j_transformer.pack_ffn_params(jcfg, jp), 0)
    for seg, seg0 in zip(packed["segments"], tp["segments"]):
        for name, block in seg.items():
            assert "ffn" not in block
            inner = block.get("moe", block)
            assert inner["masks"] is (seg0[name].get("moe",
                                                     seg0[name])["masks"])
    if arch == "arctic-480b":
        assert "masks" in packed["segments"][0]["b0"]["moe"]["dense"]


def test_pack_ffn_params_packs_a_mixed_stack(pair):
    """A stack holding dense FFN blocks beside MoE blocks: the dense ones
    pack, the MoE ones keep their masks, as in the reference."""
    over = dict(segments_override=((("attn", "moe"), 1),))
    jcfg, tcfg, jp, tp = pair("phi3.5-moe-42b-a6.6b", **over)
    packed = t_transformer.pack_ffn_params(tcfg, tp)
    _tree_close(packed, j_transformer.pack_ffn_params(jcfg, jp), 0)
    assert "wdp" in packed["segments"][0]["b0"]["ffn"]
    assert "masks" in packed["segments"][0]["b1"]["moe"]
