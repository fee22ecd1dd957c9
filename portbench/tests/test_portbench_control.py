"""The controls come out as not correct: the reference one precision step
below the configuration's, put in the program's place, fails the cell's
limits (fp8 e4m3 products for the bf16 LM, TF32 products for the fp32
IVIM chain; TF32 rounding is emulated here, as the CPU has none). The
limits are the cell files' own; the chip readings they were set from are
in PERF.md."""

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from portbench import inputs, run
from portbench.drivers import ivim_volume, lm_server
from portbench.reference import ivim as ivim_ref
from portbench.reference import qwen2
from portbench.tests import smoke


def _tf32(t):
    """Round fp32 to TF32's 10-bit mantissa, to nearest (ties away)."""
    if not isinstance(t, torch.Tensor) or t.dtype != torch.float32:
        return t
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _TF32Products(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        if getattr(func, "__name__", "") in ("matmul", "__matmul__"):
            args = tuple(_tf32(a) for a in args)
        return func(*args, **(kwargs or {}))


def _fp8_control_on_fixed_tokens(seed: int, length: int = 64) -> dict:
    """The control's numbers on one fixed request of ``length`` tokens
    whose served tokens are the reference's own best: how far the token
    fp8 products put first lies below the reference's best, and the
    relative uncertainty's error as ``drivers/lm_server.py`` measures it.
    (A short CPU window finishes few requests, and both numbers are maxima
    over the tokens compared.)"""
    d = lm_server.dims(smoke.lm_config())
    raw = inputs.lm_raw(d, seed, smoke.CPU)
    toks = torch.as_tensor(
        np.random.default_rng(seed).integers(0, d["vocab_size"], length))
    head = {"norm_w": raw["norm_w"].float(), "unembed": raw["unembed"].float()}

    def layer(li):
        return {k: raw[k][li].float() for k in qwen2.LAYER_KEYS}

    args = (d, layer, raw["embed"], head, raw["masks"], toks, length // 4)
    mean, std = qwen2.posterior(*args)
    cm, cs = qwen2.posterior(*args, quant="fp8")
    first = cm.argmax(-1, keepdim=True)
    gap = mean.max(-1).values - mean.gather(-1, first)[:, 0]
    served = mean.argmax(-1, keepdim=True)
    rel = std.gather(-1, served)[:, 0] / mean.gather(-1, served)[:, 0].abs()
    c_rel = cs.gather(-1, served)[:, 0] / cm.gather(-1, served)[:, 0].abs()
    err = (c_rel - rel).abs() / rel.clamp_min(rel.median())
    return {"gap_max_nats": float(gap.max()), "rel_unc_err": float(err.max())}


@pytest.mark.parametrize("name", ["lm-batch-decode", "lm-chat-open"])
def test_fp8_control_fails_the_lm_limits(name):
    limits = run.load("workloads", name)["limits"]
    _, numbers = smoke.run_small(name, seconds=2.5, control=True)
    assert all(numbers[k] <= limits[k] for k in limits)
    for seed in (1, 2, 3):
        control = _fp8_control_on_fixed_tokens(seed)
        assert any(control[k] > limits[k] for k in limits), control


@pytest.mark.parametrize("name", ["ivim-slab-stream"])
def test_tf32_control_fails_the_ivim_limits(name):
    limits = run.load("workloads", name)["limits"]
    cfg = smoke.configs()["uivim-dense104-m8"]
    raw = inputs.ivim_raw(cfg, 8, 77, smoke.CPU)
    x = inputs.ivim_slabs(cfg, [16, 16, 8], 1, 20.0, 78,
                          smoke.CPU)[0].reshape(-1, 104)
    rm, rs = ivim_ref.moments(raw, x, cfg["out_ranges"])
    with _TF32Products():
        cm, cs = ivim_ref.moments(raw, x, cfg["out_ranges"])
    errs = ivim_volume._errors(cfg, cm, cs, rm, rs)
    assert any(e > limits[k]
               for e, k in zip(errs, ("mean_err", "std_err")))
