"""The three dense stacks of the registry that no other test serves at
their own head layouts — stablelm-12b, granite-20b and deepseek-coder-33b —
through the port's serving entry points against the JAX package, on the
CPU (the kernels' plain versions; the kernels are held to them on the card
by tests/test_torch_cuda.py and chip_smoke.py's ``[dense_*]`` phases).

Each model at 2 layers, fp32, the reference's weights from ``PRNGKey(0)``
carried over by ``transformer.params_from_jax``, narrow d_ff (128) and
vocabulary (256), with its published head layout kept:

* stablelm-12b: head width 160 with ``rope_pct`` 0.25 (a 40-wide rotary
  part), layernorm, gated SiLU, GQA group 4;
* granite-20b: 48 query heads on one KV head, layernorm, the plain GELU
  MLP with biases, QKV bias;
* deepseek-coder-33b: GQA group 7 (14 heads on 2 KV heads), RMSNorm,
  gated SiLU.

Tolerance: the fp32 LM legs' (``chip_smoke.py`` TOL_LM_UNC): generated
tokens equal, relative uncertainty within rtol 1e-3 / atol 1e-5 (sums in
another order in the two frameworks, over several greedy steps).

Also the two faults these stacks found in the port at full width (see
ROADMAP.md queue 3): ``transformer.init`` held every layer and their stack
at once (twice the weights: 133 GB for deepseek-coder-33b's 66.7), and the
fused decode runner kept the last parameter tree alive after its caller
dropped it.
"""

import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import registry as j_registry
from repro.core import plan as j_plan
from repro.models import build_model as j_build_model
from repro.serving import engine as j_engine
from repro_torch.configs import registry as t_registry
from repro_torch.core import plan as t_plan
from repro_torch.kernels.fused_decode import ops as t_dops
from repro_torch.kernels.fused_plan import ref as t_fref
from repro_torch.models import layers as t_layers
from repro_torch.models import model as t_model
from repro_torch.models import transformer as t_transformer
from repro_torch.serving import engine as t_engine
from repro_torch.serving import server as t_server

CPU = torch.device("cpu")
TOL_UNC = dict(rtol=1e-3, atol=1e-5)

# arch -> (smoke overrides keeping the published head layout, the layout's
# (heads, KV heads, head width, rotary width))
STACKS = {
    "stablelm-12b": (dict(n_heads=8, n_kv_heads=2, head_dim=160),
                     (8, 2, 160, 40)),
    "granite-20b": (dict(n_heads=48, n_kv_heads=1, head_dim=8),
                    (48, 1, 8, 8)),
    "deepseek-coder-33b": (dict(n_heads=14, n_kv_heads=2, head_dim=16),
                           (14, 2, 16, 16)),
}
LAYERS, BATCH, PROMPT, NEW = 2, 3, 6, 5


@pytest.fixture(scope="module", params=sorted(STACKS))
def stack(request):
    """(arch, jcfg, tcfg, jax params, port params) at 2 layers."""
    arch = request.param
    over = dict(STACKS[arch][0], n_layers=LAYERS)
    jcfg = j_registry.smoke_config(arch, **over)
    tcfg = t_registry.smoke_config(arch, **over)
    jp = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    tp = t_transformer.params_from_jax(tcfg, jax.tree.map(np.asarray, jp),
                                       device=CPU)
    return arch, jcfg, tcfg, jp, tp


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def _prompts(vocab, b=BATCH, plen=PROMPT, seed=5):
    return np.random.default_rng(seed).integers(
        0, vocab, size=(b, plen)).astype(np.int32)


def test_head_layout_is_the_published_one(stack):
    """The cut configs keep what the full ones give the kernels: the head
    layout of the lowering and the norm / MLP / bias choices."""
    arch, _, tcfg, _, _ = stack
    full = t_registry.get_config(arch)
    h, hkv, dh, rot = STACKS[arch][1]
    at = next(s for s in t_plan.lower_fused_decode(tcfg).steps
              if s.kind == "attn")
    assert (at.n_heads, at.n_kv_heads, at.head_dim, at.rot_dim) == \
        (h, hkv, dh, rot)
    assert h // hkv == full.n_heads // full.n_kv_heads
    assert (tcfg.norm, tcfg.activation, tcfg.qkv_bias, tcfg.rope_pct) == \
        (full.norm, full.activation, full.qkv_bias, full.rope_pct)
    if arch == "stablelm-12b":
        assert full.d_model // full.n_heads == dh


@pytest.mark.parametrize("fused", (None, False))
def test_serve_uncertain_matches_jax(stack, fused):
    """The port's ``serve_uncertain`` (the fused step's plain version, or
    per-op) against the reference's per-op ``serve_uncertain``."""
    _, jcfg, tcfg, jp, tp = stack
    toks = _prompts(tcfg.vocab_size)
    jg, ju, _ = j_engine.serve_uncertain(
        j_build_model(jcfg), jp, jnp.asarray(toks),
        j_engine.ServeConfig(max_new_tokens=NEW, fused=False))
    model = t_model.build_model(tcfg)
    fns = t_server.step_fns(model, fused=fused, device=CPU)
    before = dict(fns.counts)
    tg, tu, _ = t_engine.serve_uncertain(
        model, tp, torch.from_numpy(toks),
        t_engine.ServeConfig(max_new_tokens=NEW, fused=fused), device=CPU)
    steps = fns.counts["decode_fused" if fused is None else
                       "decode_per_op"] - before.get(
        "decode_fused" if fused is None else "decode_per_op", 0)
    assert steps == NEW and fns.fused_live() == (fused is None)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), **TOL_UNC)


def test_fused_step_matches_jax_fused_step(stack):
    """One fused step from the same prefilled pool in both packages: the
    port's ``compile_decode_step`` against the reference's
    ``compile_decode_step(backend="xla")``."""
    _, jcfg, tcfg, jp, tp = stack
    n = tcfg.mask_samples
    toks = np.tile(_prompts(tcfg.vocab_size, seed=6), (n, 1))
    tm, _, tc = t_server.step_fns(tcfg, fused=False, device=CPU).prefill(
        tp, torch.from_numpy(toks), max_seq=PROMPT + 2)
    from repro.serving import server as j_server
    jm, _, jc = j_server.step_fns(jcfg, fused=False).prefill(
        jp, jnp.asarray(toks), max_seq=PROMPT + 2)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-5,
                               atol=1e-5)
    tok = np.tile(np.asarray(jm).argmax(-1).astype(np.int32), n)[:, None]
    jmean, jrel, _ = j_plan.compile_decode_step(jcfg, backend="xla")(
        jp, jc, jnp.asarray(tok), jnp.int32(PROMPT))
    tmean, trel, _ = t_plan.compile_decode_step(tcfg, device=CPU)(
        tp, tc, torch.from_numpy(tok), PROMPT)
    np.testing.assert_allclose(tmean.numpy(), np.asarray(jmean), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(trel.numpy(), np.asarray(jrel), **TOL_UNC)


def test_port_fused_matches_port_per_op(stack):
    """Inside the port, on the same weights and prompts: the fused decode
    (one ``fused_decode`` call a step) and the per-op decode generate the
    same tokens, their uncertainties within TOL_UNC."""
    _, _, tcfg, _, tp = stack
    model = t_model.build_model(tcfg)
    toks = torch.from_numpy(_prompts(tcfg.vocab_size, seed=7))
    calls = []
    real = t_dops.fused_decode
    t_dops.fused_decode = lambda *a: calls.append(1) or real(*a)
    try:
        fg, fu, _ = t_engine.serve_uncertain(
            model, tp, toks, t_engine.ServeConfig(max_new_tokens=NEW),
            device=CPU)
    finally:
        t_dops.fused_decode = real
    pg, pu, _ = t_engine.serve_uncertain(
        model, tp, toks, t_engine.ServeConfig(max_new_tokens=NEW,
                                              fused=False), device=CPU)
    assert len(calls) == NEW
    assert torch.equal(fg, pg)
    torch.testing.assert_close(fu, pu, **TOL_UNC)


def test_server_wave_matches_one_shot(stack):
    """A ``BayesianLMServer`` wave (fused, prompts of different lengths,
    so rows sit at different positions) gives each request the tokens of
    its own one-shot ``serve_uncertain``."""
    _, _, tcfg, _, tp = stack
    model = t_model.build_model(tcfg)
    rng = np.random.default_rng(8)
    reqs = [(rng.integers(0, tcfg.vocab_size, n).astype(np.int32), m)
            for n, m in ((3, 4), (6, 2), (5, 4))]
    srv = t_server.BayesianLMServer(model, tp, t_server.ServerConfig(
        max_slots=2, max_prompt_len=PROMPT, max_new_tokens=4, fused=True),
        device=CPU)
    rids = [srv.submit(t, max_new_tokens=m) for t, m in reqs]
    srv.run()
    for rid, (t, m) in zip(rids, reqs):
        gen, unc, _ = t_engine.serve_uncertain(
            model, tp, torch.from_numpy(t[None]),
            t_engine.ServeConfig(max_new_tokens=m), device=CPU)
        st = srv.result(rid)
        assert st.status == "done" and st.generated == gen[0, len(t):]\
            .tolist()
        np.testing.assert_allclose(st.uncertainty, unc[0].numpy(),
                                   **TOL_UNC)


def test_fused_flattening_reads_weights_in_place(stack):
    """The fused step's flattened operands are the parameters' own memory:
    every weight, bias and norm leaf shares its storage with the tree; the
    per-row mask matrices are the only tensors it makes (these stacks do
    not tie the LM head)."""
    _, _, tcfg, _, tp = stack
    spec = t_plan.lower_fused_decode(tcfg)
    rows = tcfg.mask_samples * BATCH
    flat = t_plan._decode_flat_params(spec, tcfg, tp, rows, True)
    owned = {t.untyped_storage().data_ptr()
             for t in _leaves(tp)}
    made = [(i, name) for (i, name), t in zip(
        t_fref.decode_param_slots(spec), flat)
        if t.untyped_storage().data_ptr() not in owned]
    assert made and all(name == "mask" for _, name in made)
    assert len(made) == LAYERS


# ---------------------------------------------------------------------------
# the faults found at full width
# ---------------------------------------------------------------------------


class _LiveBytes(TorchDispatchMode):
    """The most bytes of tensor storage alive at once over the ops run
    under it (storages made by those ops)."""

    def __init__(self):
        super().__init__()
        self.live, self.peak = {}, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                if st.nbytes() and st.data_ptr() not in self.live:
                    self.live[st.data_ptr()] = (StorageWeakRef(st),
                                                st.nbytes())
        self.live = {k: v for k, v in self.live.items()
                     if not v[0].expired()}
        self.peak = max(self.peak, sum(n for _, n in self.live.values()))
        return out


def test_init_never_holds_the_stack_twice():
    """``transformer.init`` fills each segment's stacked leaves a layer at
    a time: at 8 bf16 layers its peak is the model plus about one layer
    and one fp32 draw, not the layers and their stack (2x the weights; at
    62 layers of deepseek-coder-33b 133 GB on an 80 GB card)."""
    cfg = t_registry.smoke_config("deepseek-coder-33b", n_layers=8,
                                  dtype=torch.bfloat16, vocab_size=64)
    with _LiveBytes() as mode:
        params = t_transformer.init(cfg, torch.Generator().manual_seed(0),
                                    device=CPU)
    total = sum(t.numel() * t.element_size()
                for t in _leaves(params))
    assert mode.peak < 1.25 * total, (mode.peak, total)


def test_init_equals_stacked_layer_draws():
    """The in-place fill draws the same numbers as stacking the layers:
    each block in order from the one generator, then the embeddings."""
    cfg = t_registry.smoke_config("deepseek-coder-33b", n_layers=3,
                                  dtype=torch.bfloat16)
    got = t_transformer.init(cfg, torch.Generator().manual_seed(3),
                             device=CPU)
    gen = torch.Generator().manual_seed(3)
    seg = cfg.segments()[0]
    want = t_transformer._stack([
        {f"b{i}": t_transformer._block_init(k, cfg, gen, cfg.dtype)
         for i, k in enumerate(seg.pattern)} for _ in range(seg.reps)])
    gl, wl = _leaves(got["segments"]), _leaves(want)
    assert len(cfg.segments()) == 1 and len(gl) == len(wl)
    assert all(torch.equal(g, w) for g, w in zip(gl, wl))
    emb = t_layers.embed_init(gen, cfg, cfg.dtype)
    assert torch.equal(got["embed"]["embed"], emb["embed"])


@pytest.mark.parametrize("arch", sorted(STACKS))
def test_fused_runner_lets_dropped_params_go(arch, monkeypatch):
    """The fused decode runner is cached per config and keeps its
    flattening across steps (one flattening for two steps), but not the
    tree: once the caller drops the parameters (and the pool), no leaf
    stays alive through it."""
    cfg = t_registry.smoke_config(arch, n_layers=LAYERS, **STACKS[arch][0])
    params = t_transformer.init(cfg, torch.Generator().manual_seed(0),
                                device=CPU)
    refs = [weakref.ref(t) for t in _leaves(params)]
    fns = t_server.step_fns(cfg, device=CPU)
    flattened = []
    real = t_plan._decode_flat_params
    monkeypatch.setattr(t_plan, "_decode_flat_params",
                        lambda *a: flattened.append(1) or real(*a))
    toks = torch.from_numpy(np.tile(_prompts(cfg.vocab_size), (4, 1)))
    mean, _, caches = fns.prefill(params, toks, max_seq=PROMPT + 2)
    for pos in (PROMPT, PROMPT + 1):        # the second step reuses it
        tok = mean.argmax(-1).to(torch.int32).repeat(4)[:, None]
        mean, _, caches = fns.decode(params, caches, tok, pos)
    assert fns.fused_live() and len(flattened) == 1
    del params, mean, caches
    gc.collect()
    assert not any(r() is not None for r in refs)
