"""The port's xLSTM blocks (``repro_torch.models.xlstm``) and the xLSTM
stack against the JAX package, on the CPU.

Cells: the mLSTM's chunkwise form and its decode step, the sLSTM cell
stepped over time, on the reference's own inputs (``_mlstm_inputs`` of
tests/test_sequence_mixers.py: gates of scale 2, k scaled by 1/sqrt(dh)).
Model: ``smoke_config("xlstm-350m")`` (4 layers: mlstm x3, slstm; d 64, 4
heads, pf 2, chunk 8, vocab 256, N 4, fp32), the reference's weights from
``PRNGKey(0)`` carried over by ``transformer.params_from_jax``.

Tolerances: 1e-5 (TOL) for one decode step of the cell against the
reference's (1.1e-5 largest absolute gap, within the relative part).
Where the exponential gates compound — the chunked cell, the blocks, the
stack's prefill and decode, the pooled state — the sums of exp(i - m)
terms land in another order than XLA's and the bar is ``rtol=atol=1e-4``
(TOL_EXP); the largest absolute gaps measured on the CPU were 2.1e-5 (the
chunked cell), 3.0e-5 (logits and state after the 4-layer prefill and
decode) and 1.9e-5 (the server's pooled sLSTM state). The chunked form
against the step recurrence, two algebras of one function, keeps the
reference's own bar (``rtol=2e-4, atol=2e-5``; 2.8e-5 measured).
Posteriors over several greedy steps: ``rtol=1e-4, atol=1e-5``; tokens
equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as j_registry
from repro.models import build_model as j_build_model
from repro.models import transformer as j_transformer
from repro.models import xlstm as j_xlstm
from repro.serving import BayesianLMServer as JServer
from repro.serving import ServerConfig as JServerConfig
from repro.serving import engine as j_engine
from repro_torch.configs import registry as t_registry
from repro_torch.core import plan as t_plan
from repro_torch.models import model as t_model
from repro_torch.models import transformer as t_transformer
from repro_torch.models import xlstm as t_xlstm
from repro_torch.serving import BayesianLMServer, ServerConfig
from repro_torch.serving import engine as t_engine

ARCH = "xlstm-350m"
TOL = 1e-5
TOL_EXP = dict(rtol=1e-4, atol=1e-4)
RECURRENCE = dict(rtol=2e-4, atol=2e-5)
POST = dict(rtol=1e-4, atol=1e-5)


def _close(got, want, tol=TOL, **kw):
    kw = kw or dict(rtol=tol, atol=tol)
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **kw)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _tree_close(got, want, **kw):
    g = jax.tree.leaves(jax.tree.map(
        _np, got, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    w = jax.tree.leaves(jax.tree.map(np.asarray, want))
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == b.shape
        _close(a, b, **(kw or dict(tol=TOL)))


def _mlstm_inputs(b=2, h=2, s=24, dh=8, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, s, dh)).astype(np.float32)
    k = (rng.normal(size=(b, h, s, dh)) / np.sqrt(dh)).astype(np.float32)
    v = rng.normal(size=(b, h, s, dh)).astype(np.float32)
    ig = (rng.normal(size=(b, h, s)) * 2.0).astype(np.float32)
    fg = (rng.normal(size=(b, h, s)) + 2.0).astype(np.float32)
    return q, k, v, ig, fg


def _carry(b, h, dh, torch_=False):
    c = (np.zeros((b, h, dh, dh), np.float32), np.zeros((b, h, dh),
                                                         np.float32),
         np.full((b, h), t_xlstm.NEG, np.float32))
    return tuple(map(torch.from_numpy, c)) if torch_ else c


@pytest.fixture(scope="module")
def model():
    jcfg = j_registry.smoke_config(ARCH)
    tcfg = t_registry.smoke_config(ARCH)
    jp = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    tp = t_transformer.params_from_jax(tcfg, jax.tree.map(np.asarray, jp),
                                       device="cpu")
    return jcfg, tcfg, jp, tp


def _prompts(b, plen, seed=1):
    return np.random.default_rng(seed).integers(
        0, 256, size=(b, plen)).astype(np.int32)


# ---------------------------------------------------------------------------
# the mLSTM cell
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s,chunk", [(24, 1), (24, 2), (24, 4), (24, 8),
                                     (21, 8), (7, 4)])
def test_mlstm_parallel_matches_jax(s, chunk):
    """Every chunk size, and lengths no chunk divides (21 and 7: one chunk
    of the whole sequence, the reference's fallback)."""
    b, h, dh = 2, 2, 8
    args = _mlstm_inputs(b, h, s, dh)
    jo, jc = j_xlstm.mlstm_parallel(*map(jnp.asarray, args),
                                    _carry(b, h, dh), chunk)
    to, tc = t_xlstm.mlstm_parallel(*map(torch.from_numpy, args),
                                    _carry(b, h, dh, True), chunk)
    _close(to, jo, **TOL_EXP)
    _tree_close(tc, jc, **TOL_EXP)


def test_mlstm_step_matches_jax_and_the_chunked_form():
    """The decode step against the reference's step at every position, and
    24 steps against the chunked form (at the reference's own bar)."""
    b, h, s, dh = 2, 2, 24, 8
    q, k, v, ig, fg = map(torch.from_numpy, _mlstm_inputs(b, h, s, dh))
    carry, j_carry = _carry(b, h, dh, True), _carry(b, h, dh)
    outs = []
    for t in range(s):
        cols = [a[:, :, t] for a in (q, k, v, ig, fg)]
        o, carry = t_xlstm.mlstm_step(*cols, carry)
        jo, j_carry = j_xlstm.mlstm_step(*(jnp.asarray(c.numpy())
                                           for c in cols), j_carry)
        _close(o, jo)
        outs.append(o)
    _tree_close(carry, j_carry)
    chunked, (c_c, _, m_c) = t_xlstm.mlstm_parallel(q, k, v, ig, fg,
                                                    _carry(b, h, dh, True), 8)
    _close(torch.stack(outs, 2), chunked, **RECURRENCE)
    _close(carry[0], c_c, **RECURRENCE)
    _close(carry[2], m_c, tol=TOL)


def test_mlstm_stability_extreme_gates():
    """Exponential input gates of e^30 and near-zero forget gates: finite
    outputs and states, as the reference's stabiliser keeps them, and
    equal to the reference's."""
    b, h, s, dh = 1, 1, 16, 4
    q, k, v, _, _ = _mlstm_inputs(b, h, s, dh, seed=7)
    ig = np.full((b, h, s), 30.0, np.float32)
    fg = np.full((b, h, s), -10.0, np.float32)
    args = (q, k, v, ig, fg)
    out, (c, n, m) = t_xlstm.mlstm_parallel(*map(torch.from_numpy, args),
                                            _carry(b, h, dh, True), 4)
    assert bool(torch.isfinite(out).all())
    assert bool(torch.isfinite(c).all()) and bool(torch.isfinite(m).all())
    jo, jc = j_xlstm.mlstm_parallel(*map(jnp.asarray, args),
                                    _carry(b, h, dh), 4)
    _close(out, jo, **TOL_EXP)
    _tree_close((c, n, m), jc, **TOL_EXP)


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------


def _block_params(model, kind):
    """The first block of ``kind`` in the smoke model, repeat 0."""
    jcfg, tcfg, jp, tp = model
    name = "b0" if kind == "mlstm" else "b3"
    pick = lambda tree, f: jax.tree.map(   # noqa: E731
        f, tree["segments"][0][name],
        is_leaf=lambda x: isinstance(x, torch.Tensor))
    return (jcfg, tcfg, pick(jp, lambda a: a[0]),
            pick(tp, lambda a: a[0]))


@pytest.mark.parametrize("kind", ("mlstm", "slstm"))
def test_block_apply_and_step_match_jax(model, kind):
    """Prefill of 11 positions (mask ids routed) and three decode steps
    from its state, against the reference's block."""
    jcfg, tcfg, jp, tp = _block_params(model, kind)
    j_apply = getattr(j_xlstm, f"{kind}_block_apply")
    j_step = getattr(j_xlstm, f"{kind}_block_step")
    t_apply = getattr(t_xlstm, f"{kind}_block_apply")
    t_step = getattr(t_xlstm, f"{kind}_block_step")
    x = np.random.default_rng(3).normal(size=(4, 11, 64)).astype(np.float32)
    ids = np.arange(4, dtype=np.int32)
    jy, jst = j_apply(jp, jnp.asarray(x), jcfg, mask_ids=jnp.asarray(ids))
    ty, tst = t_apply(tp, torch.from_numpy(x), tcfg,
                      mask_ids=torch.from_numpy(ids))
    _close(ty, jy, **TOL_EXP)
    _tree_close(tst, jst, **TOL_EXP)
    for t in range(3):
        xt = x[:, t] * 0.5
        jy, jst = j_step(jp, jnp.asarray(xt), jst, jcfg,
                         mask_ids=jnp.asarray(ids))
        ty, tst = t_step(tp, torch.from_numpy(xt), tst, tcfg,
                         mask_ids=torch.from_numpy(ids))
        _close(ty, jy, **TOL_EXP)
        _tree_close(tst, jst, **TOL_EXP)


def test_states_stay_fp32_in_bf16(model):
    _, tcfg, _, tp = model
    import dataclasses
    cfg16 = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    p16 = t_transformer.params_from_jax(
        cfg16, jax.tree.map(lambda t: t.numpy(), tp,
                            is_leaf=lambda x: isinstance(x, torch.Tensor)),
        device="cpu")
    toks = torch.from_numpy(_prompts(4, 9))
    logits, caches = t_transformer.prefill(cfg16, p16, {"tokens": toks},
                                           max_seq=10)
    assert logits.dtype == torch.bfloat16
    for seg in caches:
        for leaves in seg.values():
            assert all(t.dtype == torch.float32 for t in leaves.values())
    assert bool(torch.isfinite(logits.float()).all())


def test_init_cache_m_starts_at_neg(model):
    """The stabiliser m starts at -1e30 (C/n/c/h zero), as the reference's
    state init: a 0 there would clamp the first step's max."""
    jcfg, tcfg, _, _ = model
    t_c = t_transformer.init_cache(tcfg, 3, 5, device="cpu")
    j_c = j_transformer.init_cache(jcfg, 3, 5)
    _tree_close(t_c, j_c, tol=0)
    for seg in t_c:
        for leaves in seg.values():
            assert (leaves["m"] == -1e30).all()
            assert all((t == 0).all() for n, t in leaves.items() if n != "m")
    specs = t_transformer.cache_specs(tcfg, 3, 5)
    assert [{b: {n: s for n, (s, _) in c.items()} for b, c in seg.items()}
            for seg in specs] == [
        {b: {n: tuple(t.shape) for n, t in c.items()} for b, c in seg.items()}
        for seg in t_c]


# ---------------------------------------------------------------------------
# the stack and serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("plen", (5, 8, 13))
def test_xlstm_prefill_and_decode_match_jax(model, plen):
    """Prompts shorter than, equal to and longer than the chunk (8; 13 is
    no multiple: one chunk), then two decode steps at per-row positions."""
    jcfg, tcfg, jp, tp = model
    toks = _prompts(4, plen, seed=plen)
    ids = np.arange(4, dtype=np.int32)
    jl, jc = j_transformer.prefill(jcfg, jp, {"tokens": toks},
                                   max_seq=plen + 2,
                                   mask_ids=jnp.asarray(ids))
    tl, tc = t_transformer.prefill(tcfg, tp, {"tokens": torch.from_numpy(
        toks)}, max_seq=plen + 2, mask_ids=torch.from_numpy(ids))
    _close(tl, jl, **TOL_EXP)
    _tree_close(tc, jc, **TOL_EXP)
    cur = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
    for i in range(2):
        pos = np.full(4, plen + i, np.int32)
        jl, jc = j_transformer.decode_step(jcfg, jp, jc, cur, pos,
                                           mask_ids=jnp.asarray(ids))
        tl, tc = t_transformer.decode_step(
            tcfg, tp, tc, torch.from_numpy(cur), torch.from_numpy(pos),
            mask_ids=torch.from_numpy(ids))
        _close(tl, jl, **TOL_EXP)
        _tree_close(tc, jc, **TOL_EXP)
        cur = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]


def test_xlstm_serve_uncertain_matches_jax(model):
    jcfg, tcfg, jp, tp = model
    with pytest.raises(t_plan.FusedPlanUnsupported, match="mlstm"):
        t_plan.lower_fused_decode(tcfg)
    toks = _prompts(3, 10, seed=5)
    jg, ju, jf = j_engine.serve_uncertain(
        j_build_model(jcfg), jp, jnp.asarray(toks),
        j_engine.ServeConfig(fused=False, max_new_tokens=6))
    tg, tu, tf = t_engine.serve_uncertain(
        t_model.build_model(tcfg), tp, torch.from_numpy(toks),
        t_engine.ServeConfig(max_new_tokens=6), device="cpu")
    np.testing.assert_array_equal(np.asarray(tg), np.asarray(jg))
    _close(tu, ju, **POST)
    np.testing.assert_array_equal(np.asarray(tf), np.asarray(jf))


def _pool_close(got, want):
    g = {(si, b, n): _np(t) for si, seg in enumerate(got)
         for b, c in seg.items() for n, t in c.items()}
    w = {(si, b, n): np.asarray(t) for si, seg in enumerate(want)
         for b, c in seg.items() for n, t in c.items()}
    assert g.keys() == w.keys()
    for key in g:
        assert g[key].shape == w[key].shape and g[key].dtype == w[key].dtype
        _close(g[key], w[key], err_msg=str(key), **TOL_EXP)


def test_xlstm_server_matches_reference_server(model):
    """The continuous-batching server on the xLSTM pool (2 slots = 8 rows),
    stepped in lockstep with the reference's server: four requests through
    two slots, so slots are freed and refilled. Busy flags, slot maps,
    tokens, statuses and flags equal; rel-unc and every pooled state leaf
    (the freed rows' m reset to 0 as the reference resets it) after every
    step."""
    jcfg, tcfg, jp, tp = model
    kw = dict(max_slots=2, max_queue=8, max_prompt_len=8, max_new_tokens=4)
    jsrv = JServer(j_build_model(jcfg), jp, JServerConfig(**kw))
    tsrv = BayesianLMServer(t_model.build_model(tcfg), tp,
                            ServerConfig(**kw), device="cpu")
    rng = np.random.default_rng(11)
    rids = []
    for n, m in zip((6, 4, 7, 5), (4, 2, 4, 3)):
        p = rng.integers(0, tcfg.vocab_size, n)
        rids.append(tsrv.submit(p, max_new_tokens=m))
        assert jsrv.submit(p, max_new_tokens=m) == rids[-1]
    steps = freed = 0
    while True:
        before = list(tsrv._slots)
        busy = jsrv.step()
        assert tsrv.step() == busy
        steps += 1
        assert tsrv._slots == jsrv._slots
        _pool_close(tsrv._caches, jsrv._caches)
        for slot, (was, now) in enumerate(zip(before, tsrv._slots)):
            if was is not None and now is None:    # released this step
                rows = tsrv.schedule.rows_for_slot(slot)
                for seg in tsrv._caches:
                    for leaves in seg.values():
                        assert all((t[:, rows] == 0).all()
                                   for t in leaves.values())
                freed += 1
        if not busy:
            break
    assert steps > 1 and freed == len(rids)
    for r in rids:
        t_st, j_st = tsrv.result(r), jsrv.result(r)
        assert (t_st.status, t_st.flags, t_st.generated) == \
            (j_st.status, j_st.flags, j_st.generated)
        _close(t_st.uncertainty, j_st.uncertainty, **POST)
    assert tsrv.steps.fused_spec is None and jsrv.steps.fused_spec is None
