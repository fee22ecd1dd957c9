"""The port's decode lowering, fused decode step and LM serving against the
JAX package, on the CPU (the kernel's plain version; the kernel itself is
held to it on the card by tests/test_torch_cuda.py and chip_smoke.py).

Model: ``smoke_config("qwen2-1.5b", n_layers=2)`` unless stated, fp32, the
reference's weights from ``PRNGKey(0)``. Tolerances: 1e-5 for one step's
values; ``rtol=1e-4, atol=1e-5`` for posteriors over several greedy steps
(the reference's own fused-vs-per-op bar, tests/test_fused_decode.py);
generated tokens equal.
"""

import dataclasses
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as j_registry
from repro.core import plan as j_plan
from repro.kernels.fused_plan import ref as j_fref
from repro.models import build_model as j_build_model
from repro.models import transformer as j_transformer
from repro.serving import engine as j_engine
from repro.serving import server as j_server
from repro_torch.configs import registry as t_registry
from repro_torch.core import plan as t_plan
from repro_torch.kernels.fused_decode import ops as t_dops
from repro_torch.kernels.fused_plan import ref as t_fref
from repro_torch.models import layers as t_layers
from repro_torch.models import model as t_model
from repro_torch.models import transformer as t_transformer
from repro_torch.serving import engine as t_engine
from repro_torch.serving import server as t_server

TOL = 1e-5
POST = dict(rtol=1e-4, atol=1e-5)

# (arch, overrides, packed) of the lowering / plain-kernel parity grid
CASES = {
    "masked": ("qwen2-1.5b", {}, False),
    "packed": ("qwen2-1.5b", {}, True),
    "layernorm_gelu_mlp": ("granite-20b", {}, False),
    "partial_rotary": ("stablelm-12b", {}, False),
    "local_window": ("qwen2-1.5b", dict(
        local_window=4, segments_override=((("local_attn",), 2),)), False),
}


def _close(got, want, **tol):
    tol = tol or dict(rtol=TOL, atol=TOL)
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


def _pair(arch="qwen2-1.5b", packed=False, **overrides):
    """(jcfg, tcfg, jax params, port params), packed after
    ``pack_ffn_params`` when asked."""
    kw = dict(n_layers=2) if "segments_override" not in overrides else {}
    kw.update(overrides)
    jcfg = j_registry.smoke_config(arch, **kw)
    tcfg = t_registry.smoke_config(arch, **kw)
    jp = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    if packed:
        jp = j_transformer.pack_ffn_params(jcfg, jp)
        jcfg = dataclasses.replace(jcfg, packed_ffn_serving=True)
        tcfg = dataclasses.replace(tcfg, packed_ffn_serving=True)
    tp = t_transformer.params_from_jax(tcfg, jax.tree.map(np.asarray, jp),
                                       device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def qwen():
    return _pair()


def _prompts(b, plen, vocab=256, seed=1):
    return np.random.default_rng(seed).integers(
        0, vocab, size=(b, plen)).astype(np.int32)


# ---------------------------------------------------------------------------
# lowering and the plain kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("expand", (True, False))
@pytest.mark.parametrize("name", sorted(CASES))
def test_lower_fused_decode_matches_jax(name, expand):
    arch, over, packed = CASES[name]
    kw = dict(n_layers=2) if "segments_override" not in over else {}
    kw.update(over, packed_ffn_serving=packed)
    jspec = j_plan.lower_fused_decode(j_registry.smoke_config(arch, **kw),
                                      expand_masks=expand)
    tspec = t_plan.lower_fused_decode(t_registry.smoke_config(arch, **kw),
                                      expand_masks=expand)
    assert (tspec.n_samples, tspec.d_model, tspec.vocab, tspec.kv_dtype) \
        == (jspec.n_samples, jspec.d_model, jspec.vocab, jspec.kv_dtype)
    assert [dataclasses.astuple(s) for s in tspec.steps] == \
        [dataclasses.astuple(s) for s in jspec.steps]
    assert t_fref.decode_param_slots(tspec) == \
        j_fref.decode_param_slots(jspec)


def _step_inputs(jcfg, tcfg, jp, tp, *, b=3, plen=5, max_seq=9, seed=1):
    """The same decode-step operands in both packages: a prefilled
    mask-major pool at position ``plen`` (row 1 inactive, pos -1)."""
    n = jcfg.mask_samples
    toks = np.tile(_prompts(b, plen, seed=seed), (n, 1))
    ids = np.repeat(np.arange(n), b)
    _, jc = j_transformer.prefill(jcfg, jp, {"tokens": toks},
                                  max_seq=max_seq, mask_ids=jnp.asarray(ids))
    _, tc = t_transformer.prefill(tcfg, tp, {"tokens": torch.from_numpy(
        toks)}, max_seq=max_seq, mask_ids=torch.from_numpy(ids))
    rows = n * b
    pos = np.full((rows,), plen, np.int32)
    pos[1] = -1
    jspec = j_plan.lower_fused_decode(jcfg)
    tspec = t_plan.lower_fused_decode(tcfg)
    rot = next(s.rot_dim for s in jspec.steps if s.kind == "attn")
    jcos, jsin = j_transformer.layers.rope_cos_sin(jnp.asarray(pos), rot,
                                                   jcfg.rope_theta)
    tpos = torch.from_numpy(pos)
    tcos, tsin = t_layers.rope_cos_sin(tpos, rot, tcfg.rope_theta)
    x = np.asarray(jp["embed"]["embed"])[toks[:, -1]]
    jargs = (jnp.asarray(x), j_plan._decode_flat_params(
        jspec, jcfg, jp, rows, True), j_plan._decode_flat_caches(jcfg, jc),
        jnp.asarray(pos), jcos, jsin)
    targs = (torch.from_numpy(x), t_plan._decode_flat_params(
        tspec, tcfg, tp, rows, True), t_plan._decode_flat_caches(tcfg, tc),
        tpos, tcos, tsin)
    return jspec, jargs, tspec, targs


@pytest.mark.parametrize("name", sorted(CASES))
def test_fused_decode_plain_matches_jax(name):
    arch, over, packed = CASES[name]
    jcfg, tcfg, jp, tp = _pair(arch, packed, **over)
    jspec, jargs, tspec, targs = _step_inputs(jcfg, tcfg, jp, tp)
    assert [tuple(t.shape) for t in targs[1]] == \
        [tuple(a.shape) for a in jargs[1]]
    want = j_fref.fused_decode_ref(jspec, *jargs)
    got = t_fref.fused_decode_ref(tspec, *targs)
    for g, w in zip(got, want):
        _close(g, w)
    # the wrapper on CPU tensors is the plain version and launches nothing
    before = t_dops.fused_decode.launches
    for g, w in zip(t_dops.fused_decode(tspec, *targs), want):
        _close(g, w)
    assert t_dops.fused_decode.launches == before


def test_fused_decode_matches_pallas_interpret():
    """Ties the port's fused step to the Pallas kernel body itself, run
    through the reference's interpret mode (one layer, one step)."""
    jcfg, tcfg, jp, tp = _pair(n_layers=1)
    n, b, plen = 4, 2, 4
    toks = np.tile(_prompts(b, plen, seed=3), (n, 1))
    ids = np.repeat(np.arange(n), b)
    _, jc = j_transformer.prefill(jcfg, jp, {"tokens": toks}, max_seq=6,
                                  mask_ids=jnp.asarray(ids))
    _, tc = t_transformer.prefill(tcfg, tp, {"tokens": torch.from_numpy(
        toks)}, max_seq=6, mask_ids=torch.from_numpy(ids))
    nxt = toks[:, -1:]
    jm, jr, jc2 = j_plan.compile_decode_step(
        jcfg, backend="pallas-interpret")(jp, jc, jnp.asarray(nxt),
                                          jnp.int32(plen))
    tm, tr, tc2 = t_plan.compile_decode_step(tcfg, device="cpu")(
        tp, tc, torch.from_numpy(nxt), plen)
    _close(tm, jm)
    _close(tr, jr, **POST)
    for g, w in zip(jax.tree.leaves(jax.tree.map(
            np.asarray, tc2, is_leaf=lambda x: isinstance(x, torch.Tensor))),
            jax.tree.leaves(jc2)):
        _close(g, w)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def _greedy(decode, params, caches, tok0, n, start, steps, to_dev):
    cur, toks, rels = tok0, [], []
    for i in range(steps):
        mean, rel, caches = decode(params, caches, to_dev(np.tile(
            cur, n)[:, None]), to_dev(np.int32(start + i)))
        cur = np.asarray(mean).argmax(-1).astype(np.int32)
        toks.append(cur)
        rels.append(np.asarray(rel))
    return np.stack(toks), np.stack(rels)


def test_fused_step_matches_jax_fused_step(qwen):
    """The port's fused step against the reference's
    ``compile_decode_step(backend="xla")`` over four greedy steps, both
    from the same prefilled pool."""
    jcfg, tcfg, jp, tp = qwen
    n, b, plen = 4, 3, 6
    toks = np.tile(_prompts(b, plen, seed=4), (n, 1))
    jfns = j_server.step_fns(jcfg, fused=False)
    tfns = t_server.step_fns(tcfg, fused=False, device="cpu")
    jm, _, jc = jfns.prefill(jp, jnp.asarray(toks), max_seq=12)
    tm, _, tc = tfns.prefill(tp, torch.from_numpy(toks), max_seq=12)
    _close(tm, jm)
    tok0 = np.asarray(jm).argmax(-1).astype(np.int32)
    jt, jr = _greedy(j_plan.compile_decode_step(jcfg, backend="xla"), jp,
                     jc, tok0, n, plen, 4, jnp.asarray)
    tt, tr = _greedy(t_plan.compile_decode_step(tcfg, device="cpu"), tp, tc,
                     tok0, n, plen, 4, torch.as_tensor)
    np.testing.assert_array_equal(tt, jt)
    _close(tr, jr, **POST)


@pytest.mark.parametrize("fused", (None, False))
def test_serve_uncertain_matches_jax(fused, qwen):
    jcfg, tcfg, jp, tp = qwen
    toks = _prompts(3, 6, seed=5)
    scfg = dict(max_new_tokens=5)
    jg, ju, jf = j_engine.serve_uncertain(
        j_build_model(jcfg), jp, jnp.asarray(toks),
        j_engine.ServeConfig(fused=False, **scfg))
    tg, tu, tf = t_engine.serve_uncertain(
        t_model.build_model(tcfg), tp, torch.from_numpy(toks),
        t_engine.ServeConfig(fused=fused, **scfg), device="cpu")
    np.testing.assert_array_equal(np.asarray(tg), np.asarray(jg))
    _close(tu, ju, **POST)
    np.testing.assert_array_equal(np.asarray(tf), np.asarray(jf))


def test_generate_matches_jax(qwen):
    jcfg, tcfg, jp, tp = qwen
    toks = _prompts(2, 5, seed=6)
    want = j_engine.generate(j_build_model(jcfg), jp, jnp.asarray(toks),
                             j_engine.ServeConfig(max_new_tokens=4,
                                                  fused=False))
    got = t_engine.generate(t_model.build_model(tcfg), tp,
                            torch.from_numpy(toks),
                            t_engine.ServeConfig(max_new_tokens=4),
                            device="cpu")
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_port_fused_matches_port_per_op(qwen):
    """Within the port: fused vs per-op decode over greedy steps with
    per-row positions, and one fused call per decode step."""
    _, tcfg, _, tp = qwen
    n, b, plen = 4, 3, 5
    toks = torch.from_numpy(np.tile(_prompts(b, plen, seed=7), (n, 1)))
    fused = t_server.step_fns(tcfg, device="cpu")
    perop = t_server.step_fns(tcfg, fused=False, device="cpu")
    mean, _, caches = perop.prefill(tp, toks, max_seq=10)
    tok0 = mean.argmax(-1).to(torch.int32).numpy()
    calls = []
    real = t_dops.fused_decode
    t_dops.fused_decode = lambda *a: calls.append(1) or real(*a)
    try:
        before = fused.counts["decode_fused"]
        ft, fr = _greedy(fused.decode, tp, caches, tok0, n, plen, 4,
                         torch.as_tensor)
    finally:
        t_dops.fused_decode = real
    assert len(calls) == 4 and fused.counts["decode_fused"] - before == 4
    pt, pr = _greedy(perop.decode, tp, caches, tok0, n, plen, 4,
                     torch.as_tensor)
    np.testing.assert_array_equal(ft, pt)
    _close(fr, pr, **POST)
    assert fused.fused_live() and perop.fused_spec is None


def test_bucketed_prefill_equals_exact_in_port(qwen):
    """Within the port: the bucketed prefill (prompt padded to the 8-bucket,
    then trimmed) is bitwise the exact-length prefill."""
    _, tcfg, _, tp = qwen
    toks = torch.from_numpy(np.tile(_prompts(2, 5, seed=8), (4, 1)))
    bucketed = t_server.step_fns(tcfg, fused=False, device="cpu")
    exact = t_server.step_fns(tcfg, fused=False, prefill_buckets=(),
                              device="cpu")
    assert bucketed.prefill_spec is not None and exact.prefill_spec is None
    got = bucketed.prefill(tp, toks, max_seq=12)
    want = exact.prefill(tp, toks, max_seq=12)
    assert bucketed.counts["prefill_bucketed"] >= 1
    for g, w in zip(jax.tree.leaves(jax.tree.map(
            np.asarray, got, is_leaf=lambda x: isinstance(x, torch.Tensor))),
            jax.tree.leaves(jax.tree.map(
                np.asarray, want,
                is_leaf=lambda x: isinstance(x, torch.Tensor)))):
        np.testing.assert_array_equal(g, w)


def test_step_fns_cache_keys_on_config():
    cfg = t_registry.smoke_config("qwen2-1.5b", n_layers=1, mask_seed=11)
    model = t_model.build_model(cfg)
    fns = t_server.step_fns(model, device="cpu")
    assert t_server.step_fns(model.cfg, device="cpu") is fns
    ref = weakref.ref(model)
    del model
    gc.collect()
    assert ref() is None                 # the cache pins no Model


def test_fallback_only_on_fused_plan_unsupported(qwen, monkeypatch):
    _, _, _, tp = qwen
    cfg = t_registry.smoke_config("qwen2-1.5b", n_layers=2, mask_seed=12)
    n, b, plen = 4, 2, 4
    toks = torch.from_numpy(np.tile(_prompts(b, plen, seed=9), (n, 1)))

    def refuse(*a):
        raise t_dops.FusedPlanUnsupported("refused for the test")

    monkeypatch.setattr(t_dops, "fused_decode", refuse)
    fns = t_server.step_fns(cfg, device="cpu")
    _, _, caches = fns.prefill(tp, toks, max_seq=8)
    key = str((n * b, 8))
    before = t_server.fallback_counts[("call", key)]
    mean, _, _ = fns.decode(tp, caches, toks[:, -1:], plen)
    assert t_server.fallback_counts[("call", key)] == before + 1
    assert fns.counts["decode_per_op"] == 1 and not fns.fused_live()
    want, _, _ = t_server.step_fns(cfg, fused=False, device="cpu").decode(
        tp, caches, toks[:, -1:], plen)
    torch.testing.assert_close(mean, want, rtol=0, atol=0)
    with pytest.raises(t_dops.FusedPlanUnsupported):
        t_server.step_fns(cfg, fused=True, device="cpu").decode(
            tp, caches, toks[:, -1:], plen)

    def broken(*a):
        raise RuntimeError("not a refusal")

    monkeypatch.setattr(t_dops, "fused_decode", broken)
    cfg2 = dataclasses.replace(cfg, mask_seed=13)
    with pytest.raises(RuntimeError, match="not a refusal"):
        t_server.step_fns(cfg2, device="cpu").decode(
            tp, caches, toks[:, -1:], plen)


def test_build_fallback_for_config_without_lowering():
    cfg = t_registry.smoke_config("qwen2-1.5b", n_layers=1, kv_dtype="int8")
    before = t_server.fallback_counts[("build", "decode")]
    fns = t_server.step_fns(cfg, device="cpu")
    assert fns.fused_spec is None
    assert t_server.fallback_counts[("build", "decode")] == before + 1
    with pytest.raises(t_dops.FusedPlanUnsupported):
        t_server.step_fns(cfg, fused=True, device="cpu")


def test_decode_traffic_matches_jax():
    for packed in (False, True):
        kw = dict(n_layers=2, packed_ffn_serving=packed)
        jspec = j_plan.lower_fused_decode(j_registry.smoke_config(
            "qwen2-1.5b", **kw))
        tspec = t_plan.lower_fused_decode(t_registry.smoke_config(
            "qwen2-1.5b", **kw))
        for fused in (True, False):
            j = j_plan.decode_traffic(jspec, 12, 9, fused=fused)
            t = t_plan.decode_traffic(tspec, 12, 9, fused=fused)
            assert (t.weight_bytes, t.act_bytes, t.flops, t.weight_loads) \
                == (j.weight_bytes, j.act_bytes, j.flops, j.weight_loads)
