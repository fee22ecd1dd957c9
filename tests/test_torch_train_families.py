"""Training the MoE, xLSTM, audio-encoder and M-RoPE families: the port's
train step against the reference's, the optimizer each family trains
with, and Adafactor's blocked update of a large slice. CPU, smoke widths,
fp32.

* Three steps of ``make_train_step`` for phi3.5-moe, arctic-480b,
  xlstm-350m, hubert-xlarge and qwen2-vl-72b against the reference's, from
  one state (``transformer.train_state_from_jax``) on ``lm_batch`` data,
  with the optimizer of each published config: Adafactor without the
  global clip for the three models above 40B parameters, AdamW for the
  other two; remat "full" and the MoE models at their published capacity
  factor (drops and all). Loss, ce and gnorm at every step within
  ``TOL_STEP`` relative (xLSTM ``TOL_XLSTM``: its exponential gates),
  ``moe_aux`` the same with an absolute floor of 1e-7 (0 off the MoE).
* The parameters after three steps within ``PARAM_LR_SHARE`` of lr,
  except the key bias (its gradient is zero in exact arithmetic: both
  optimizers turn each framework's rounding noise into full steps).
  Derived: both optimizers normalise the gradient, so a parameter's step
  is about lr whatever the gradient's size and its error is lr times the
  gradient's error over its own scale; AdamW divides by |g| itself and
  Adafactor by the row and column RMS, and where a gradient is 1e-3 of its
  leaf's largest, the leaf-relative error of 2e-5 (5e-4 for xLSTM) becomes
  2e-2 (0.5) of a step. 0.05 of lr (0.2 for xLSTM) over three steps is the
  bound, as in ``test_torch_train.py``'s AdamW steps; the gaps measured
  are in ``test_three_steps_match_jax``'s docstring.
* Adafactor's blocked update (slices above ``_CHUNK_ELEMS`` elements
  whose whole-slice update would not fit) against the whole-slice update:
  the moments and parameters within 2e-6 relative (sums in another order:
  the column means as sums over blocks, the RMS clip as a sum of block
  sums) and its peak of live temporaries within a few blocks, where the
  whole-slice form holds several copies of the slice; and which slices
  take it on the card.
"""

import os
import sys

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
from repro.train import TrainConfig as JTrainConfig
from repro.train import make_train_step as j_make_train_step
from repro.train import train_state_init as j_train_state_init
from repro_torch.configs import registry as t_registry
from repro_torch.core import tree as tree_lib
from repro_torch.data import LMDataConfig, lm_batch
from repro_torch.launch import dryrun
from repro_torch.models import model as t_model
from repro_torch.models import transformer as t_transformer
from repro_torch.optim import OptimizerConfig, build_optimizer
from repro_torch.optim import optimizers as t_optimizers
from repro_torch.train import TrainConfig, make_train_step
from test_torch_dense_stacks import _LiveBytes

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402  (its tables only; it imports no torch)

TOL_STEP = 1e-5
TOL_XLSTM = 1e-4
PARAM_LR_SHARE = {"ssm": 0.2, "other": 0.05}
TOL_BLOCKED = 2e-6
LR = 1e-2
STEPS = 3
B, S = 8, 32            # 256 tokens: four routing groups of 64

FAMILIES = ("phi3.5-moe-42b-a6.6b", "arctic-480b", "xlstm-350m",
            "hubert-xlarge", "qwen2-vl-72b")
#: the optimizer each family's published config trains with
PUBLISHED_PICK = {"phi3.5-moe-42b-a6.6b": "adafactor",
                  "arctic-480b": "adafactor", "xlstm-350m": "adamw",
                  "hubert-xlarge": "adamw", "qwen2-vl-72b": "adafactor"}
#: the depths the card's training phases cut them to
CARD_LAYERS = {arch: layers
               for _, arch, layers, _, _ in chip_smoke.FAMILY_TRAIN}


def _np(t):
    return t.detach().cpu().numpy()


def _cut(arch):
    """The smoke config at remat "full", the MoE at its published
    capacity factor."""
    pub = t_registry.get_config(arch)
    over = dict(remat="full")
    if pub.n_experts:
        over["capacity_factor"] = pub.capacity_factor
    return over


def _pair(arch, blocked_limit=None, monkeypatch=None):
    over = _cut(arch)
    jcfg = j_registry.smoke_config(arch, **over)
    tcfg = t_registry.smoke_config(arch, **over)
    pick = dryrun.pick_optimizer(t_registry.get_config(arch))
    assert pick.name == PUBLISHED_PICK[arch]
    oc = dict(name=pick.name, clip_norm=pick.clip_norm, lr=LR,
              warmup_steps=2, decay_steps=10)
    jm, jo = j_build_model(jcfg), j_build_optimizer(JOptConfig(**oc))
    js = j_train_state_init(jm, jo, jax.random.PRNGKey(0))
    ts = t_transformer.train_state_from_jax(
        tcfg, jax.tree.map(np.asarray, js), device="cpu")
    if blocked_limit is not None:
        monkeypatch.setattr(t_optimizers, "_CHUNK_ELEMS", blocked_limit)
    jstep = jax.jit(j_make_train_step(jm, jo, JTrainConfig()))
    tstep = make_train_step(t_model.build_model(tcfg),
                            build_optimizer(OptimizerConfig(**oc)),
                            TrainConfig())
    data = dict(vocab_size=tcfg.vocab_size, seq_len=S, global_batch=B,
                family="audio" if tcfg.family == "audio" else "dense",
                d_model=tcfg.d_model)
    return tcfg, js, ts, jstep, tstep, JDataConfig(**data), \
        LMDataConfig(**data)


def _run(arch, blocked_limit=None, monkeypatch=None):
    tcfg, js, ts, jstep, tstep, jd, td = _pair(arch, blocked_limit,
                                               monkeypatch)
    ssm = tcfg.family == "ssm"
    tol = TOL_XLSTM if ssm else TOL_STEP
    for step in range(STEPS):
        if ssm:         # each step from the reference's state (docstring)
            ts = t_transformer.train_state_from_jax(
                tcfg, jax.tree.map(np.asarray, js), device="cpu")
        js, jm = jstep(js, j_lm_batch(jd, step))
        ts, tm = tstep(ts, lm_batch(td, step, "cpu"))
        for key in ("loss", "ce", "gnorm"):
            np.testing.assert_allclose(_np(tm[key]), np.asarray(jm[key]),
                                       rtol=tol, err_msg=f"{key} {step}")
        np.testing.assert_allclose(_np(tm["moe_aux"]),
                                   np.asarray(jm["moe_aux"]), rtol=tol,
                                   atol=1e-7, err_msg=f"moe_aux {step}")
        if tcfg.n_experts:
            assert float(tm["moe_aux"]) > 0
        if PUBLISHED_PICK[arch] == "adafactor":     # no global clip
            assert float(tm["gnorm"]) == float(jm["gnorm"]) == 0.0
    assert int(ts["opt"]["step"]) == STEPS
    share = PARAM_LR_SHARE["ssm" if tcfg.family == "ssm" else "other"]
    worst = 0.0
    for (path, got), want in zip(tree_lib.flatten_with_path(ts["params"]),
                                 jax.tree.leaves(js["params"])):
        if path[-2:] == ("wk", "b"):
            continue
        gap = float(np.abs(_np(got) - np.asarray(want)).max())
        worst = max(worst, gap)
        assert gap <= share * LR, (path, gap / LR)
    return worst / LR


@pytest.mark.parametrize("arch", FAMILIES)
def test_three_steps_match_jax(arch):
    """Three train steps against the reference's, each family with its
    published config's optimizer. Measured parameter gaps over lr:
    phi3.5 2.5e-5, arctic 2.5e-5, hubert 7.3e-4, qwen2-vl 2.4e-5; xLSTM
    at most 0.145 (step 0), with gnorm 1.5e-5 and loss 1.6e-7 apart.

    xLSTM's steps each start from the reference's state: run free at lr
    1e-2, the two trajectories part (gnorm 0.3% apart at step 1, 5% at
    step 2, parameters 2.6 lr), as AdamW's first step moves elements
    whose gradient is rounding-sized up to 0.145 lr apart and the
    exponential gates carry the difference on; from one state, each step
    agrees within TOL_XLSTM."""
    _run(arch)


def test_three_steps_blocked_adafactor_match_jax(monkeypatch):
    """arctic's steps with every factored slice above 512 elements taking
    the blocked update (the experts' [8, 64, 128] slices in blocks of
    whole experts, the [256, 64] embedding in row blocks) against the
    reference's whole-slice update."""
    _run("arctic-480b", blocked_limit=512, monkeypatch=monkeypatch)


# ---------------------------------------------------------------------------
# the optimizer a cut model trains with
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", FAMILIES)
def test_cut_model_trains_with_the_published_pick(arch):
    """The training phases pick the optimizer of the published config
    (Adafactor, no global clip, above 40B parameters; AdamW below). The
    config cut to the card's depth would get AdamW for the big three, as
    the reference's ``pick_optimizer`` gives it too: the dry-run prices
    the config it traces, and its pick stays so."""
    pick = dryrun.pick_optimizer(t_registry.get_config(arch))
    assert pick.name == PUBLISHED_PICK[arch]
    assert pick.clip_norm == (0.0 if pick.name == "adafactor" else 1.0)
    cut = t_registry.get_config(arch, n_layers=CARD_LAYERS[arch])
    jcut = j_registry.get_config(arch, n_layers=CARD_LAYERS[arch])
    want = (OptimizerConfig(name="adafactor", clip_norm=0.0)
            if jcut.param_count() > 40e9 else OptimizerConfig(name="adamw"))
    assert dryrun.pick_optimizer(cut) == want
    assert want.name == "adamw"
    assert [a for _, a, _, _, _ in chip_smoke.FAMILY_TRAIN] == list(FAMILIES)


# ---------------------------------------------------------------------------
# Adafactor's blocked update
# ---------------------------------------------------------------------------


#: leaf shapes: a stack of expert slices ([layers, experts, rows, cols];
#: one layer, as arctic at the card's depth, so the slice is the leaf), a
#: stack of three layers, and a 2-D embedding; limits that split them into
#: whole-matrix blocks, row blocks of one matrix, and uneven blocks
BLOCK_CASES = {
    "experts_1_layer": ((1, 12, 40, 24), 2000),
    "experts_3_layers": ((3, 6, 40, 24), 3000),
    "row_blocks": ((1, 3, 64, 48), 700),
    "embedding": ((300, 40), 1000),
}


def _adafactor_steps(shape, limit, monkeypatch, steps=2, dtype=None):
    monkeypatch.setattr(t_optimizers, "_CHUNK_ELEMS", limit)
    gen = torch.Generator().manual_seed(7)
    p = torch.randn(shape, generator=gen, dtype=torch.float32)
    if dtype is not None:
        p = p.to(dtype)
    params = {"w": p}
    opt = build_optimizer(OptimizerConfig(name="adafactor", clip_norm=0.0,
                                          lr=1e-2, warmup_steps=0))
    state = opt.init(params)
    peak = 0
    for _ in range(steps):
        # gradients of uneven scale across rows and columns
        g = (torch.randn(shape, generator=gen)
             * torch.rand(shape[-2:], generator=gen) * 3).to(p.dtype)
        with _LiveBytes() as mode:
            params, state = opt.update({"w": g}, state, params)
        peak = max(peak, mode.peak)
    return params["w"], state["v"]["w"], peak


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_blocked_adafactor_matches_the_whole_slice(case, monkeypatch):
    """The blocked update against the whole-slice one on the same leaf and
    gradients (two steps): moments and parameters within TOL_BLOCKED
    relative; the RMS clip spans the whole layer slice (rms > 1 here, so a
    clip per block would move the result by far more)."""
    shape, limit = BLOCK_CASES[case]
    n_slice = int(np.prod(shape[-3:] if len(shape) == 4 else shape))
    assert limit < n_slice
    got_p, got_v, _ = _adafactor_steps(shape, limit, monkeypatch)
    want_p, want_v, _ = _adafactor_steps(shape, 1 << 40, monkeypatch)
    for k in ("vr", "vc"):
        torch.testing.assert_close(got_v[k], want_v[k], rtol=TOL_BLOCKED,
                                   atol=0)
    torch.testing.assert_close(got_p, want_p, rtol=TOL_BLOCKED,
                               atol=TOL_BLOCKED)


def test_blocked_adafactor_clips_over_the_whole_slice(monkeypatch):
    """The RMS clip spans the whole layer slice, not a block: two experts
    in blocks of one, the first's second gradient 100x its first (its
    update's RMS ~1.3, clipped) and the second's the same scale (RMS ~1).
    The blocked steps equal the whole-slice steps, and differ from each
    expert clipped alone (the update of two separate leaves)."""
    shape = (1, 2, 16, 8)
    gen = torch.Generator().manual_seed(3)
    grads = [torch.randn(shape, generator=gen) for _ in range(2)]
    grads[1][0, 0] *= 100.0
    opt = build_optimizer(OptimizerConfig(
        name="adafactor", clip_norm=0.0, lr=1.0, warmup_steps=0,
        weight_decay=0.0))

    def steps(params, grad_of):
        state = opt.init(params)
        for g in grads:
            params, state = opt.update(grad_of(g), state, params)
        return params

    out = {}
    for name, limit in (("blocked", 128), ("whole", 1 << 40)):
        monkeypatch.setattr(t_optimizers, "_CHUNK_ELEMS", limit)
        out[name] = steps({"w": torch.zeros(shape)},
                          lambda g: {"w": g})["w"]
    alone = steps({"e0": torch.zeros(16, 8), "e1": torch.zeros(16, 8)},
                  lambda g: {"e0": g[0, 0], "e1": g[0, 1]})
    torch.testing.assert_close(out["blocked"], out["whole"],
                               rtol=TOL_BLOCKED, atol=TOL_BLOCKED)
    gap = (out["whole"][0, 0] - alone["e0"]).abs().max()
    assert gap > 1e-2 * alone["e0"].abs().max(), gap


def test_blocked_adafactor_peak_is_a_few_blocks(monkeypatch):
    """Peak of the temporaries the update allocates: the whole-slice form
    holds about eight fp32 copies of the slice at once (at arctic's
    one-layer expert stack, 17.9 GB each); the blocked form as many
    blocks, and the moments' column sums. bf16 parameters and gradients,
    as on the card."""
    shape, limit = (1, 16, 64, 32), 4096
    slice_f32 = 4 * int(np.prod(shape))
    _, _, whole = _adafactor_steps(shape, 1 << 40, monkeypatch,
                                   dtype=torch.bfloat16)
    _, _, blocked = _adafactor_steps(shape, limit, monkeypatch,
                                     dtype=torch.bfloat16)
    # the in-place copies' outputs count too: the bf16 slice and the
    # moments, in both forms
    held = 2 * int(np.prod(shape)) + 4 * 16 * (64 + 32)
    assert whole - held >= 6 * slice_f32, whole
    assert blocked - held <= 10 * 4 * limit, (blocked, whole)


def test_row_blocks_cover_each_slice_once():
    for n, r, c, limit in ((5, 7, 3, 42), (5, 7, 3, 40), (2, 9, 4, 7),
                           (1, 10, 10, 1), (3, 4, 5, 10 ** 6)):
        seen = np.zeros((n, r), int)
        for n0, n1, r0, r1 in t_optimizers._row_blocks(n, r, c, limit):
            assert (n1 - n0) * (r1 - r0) * c <= max(limit, c)
            assert n1 - n0 == 1 or (r0, r1) == (0, r)
            seen[n0:n1, r0:r1] += 1
        assert (seen == 1).all()


def test_published_widths_take_the_blocked_update():
    """Which of the card's training leaves exceed ``_CHUNK_ELEMS``, the
    slices that take the blocked update where the whole-slice one would
    not fit: the expert stacks of arctic (one layer slice, 4.46G elements)
    and phi3.5-moe (a layer's 16 experts, 419M) and qwen2-vl's embedding
    and head (1.25G each); nothing of xlstm or hubert, which train with
    AdamW."""
    big = {}
    for arch, layers in CARD_LAYERS.items():
        cfg = t_registry.get_config(arch, n_layers=layers)
        specs = t_model.build_model(cfg).param_specs()
        for path, t in tree_lib.flatten_with_path(specs):
            per = t[0] if t.ndim >= 3 and t.shape[0] > 1 else t
            if (t_optimizers._factored(per.shape)
                    and per.numel() > t_optimizers._CHUNK_ELEMS):
                big.setdefault(arch, []).append(
                    path[-2] if path[-1] == "w" else path[-1])
    assert sorted(big) == ["arctic-480b", "phi3.5-moe-42b-a6.6b",
                           "qwen2-vl-72b"]
    assert sorted(big["arctic-480b"]) == ["wed", "weg", "weu"]
    assert sorted(big["phi3.5-moe-42b-a6.6b"]) == ["wed", "weg", "weu"]
    assert sorted(big["qwen2-vl-72b"]) == ["embed", "unembed"]


#: (elements of the slice, card bytes free, then held by the allocator's
#: free blocks, whole-slice update?): arctic's one-layer expert stack
#: beside its 56 GB of weights and gradients, qwen2-vl's embedding and a
#: phi3.5 layer's experts beside theirs, a slice at the limit, a slice
#: whose fit rests on the allocator's free blocks
WHOLE_FIT_CASES = (
    (128 * 7168 * 4864, 24 << 30, 1 << 30, False),
    (152064 * 8192, 44 << 30, 0, True),
    (16 * 4096 * 6400, 30 << 30, 2 << 30, True),
    (1 << 28, 0, 0, True),
    ((1 << 28) + 1, 6 << 30, 3 << 30, True),
    ((1 << 28) + 1, 6 << 30, 1 << 30, False),
)


@pytest.mark.parametrize("numel,free,cached,whole", WHOLE_FIT_CASES)
def test_whole_slice_update_where_it_fits(numel, free, cached, whole,
                                          monkeypatch):
    """A slice above ``_CHUNK_ELEMS`` takes the whole-slice update on the
    card where ``_WHOLE_BYTES`` a element fit in the free memory (the
    caching allocator's free blocks included), the blocked one where they
    do not, and always the blocked one on the host."""
    dev = torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda d: (free, 80 << 30))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda d: 10 << 30)
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda d: (10 << 30) - cached)
    assert t_optimizers._whole_fits(numel, dev) is whole
    assert t_optimizers._whole_fits(numel, torch.device("cpu")) is (
        numel <= t_optimizers._CHUNK_ELEMS)
