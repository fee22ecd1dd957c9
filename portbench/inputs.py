"""Inputs the benchmark makes from ``--seed`` and hands to both sides:
weights, masks and IVIM slabs. Weights are drawn on the run's device with
one ``torch.Generator``, a whole stacked leaf per call, in the dtype the
configuration serves in. Masks come from the configuration's own mask seed
through the frozen generator (``reference/masks.py``): they are part of the
model, not of the run.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import masks as masks_ref

__all__ = ["DTYPES", "generator", "masks", "ivim_raw", "ivim_slabs",
           "lm_raw"]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def generator(device: torch.device, seed: int, stream: int) -> torch.Generator:
    """A generator on ``device`` for one input stream of the run: seeds of
    any size (above 32 bits too) and distinct streams map to
    distinct 64-bit seeds."""
    key = np.random.SeedSequence([seed, stream]).generate_state(2, np.uint32)
    return torch.Generator(device).manual_seed(
        (int(key[0]) << 31) ^ int(key[1]))


def masks(width: int, n: int, scale: float, seed: int,
          device: torch.device) -> torch.Tensor:
    """[n, width] 0/1 fp32 masks of the frozen Masksembles construction."""
    m = masks_ref.generate_masks(width, n, scale, seed)
    return torch.from_numpy(m.astype(np.float32)).to(device)


def ivim_raw(cfg: dict, n_masks: int, seed: int,
             device: torch.device) -> dict:
    """uIVIM-NET's raw fp32 parameters (before BN folding and packing):
    He-normal weights, small random biases, random BN affine and running
    statistics, and the config's masks."""
    g = generator(device, seed, 10 + n_masks)
    w, nsub = len(cfg["b_values"]), 4

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=device) * scale

    raw = {}
    for name, d_out in (("fc1", w), ("fc2", w), ("enc", 1)):
        raw[name] = {"w": randn(nsub, w, d_out, scale=math.sqrt(2.0 / w)),
                     "b": randn(nsub, d_out, scale=0.1)}
    for name in ("bn1", "bn2"):
        raw[name] = {"gamma": 1.0 + randn(nsub, w, scale=0.1),
                     "beta": randn(nsub, w, scale=0.1),
                     "mean": randn(nsub, w, scale=0.3),
                     "var": 0.5 + torch.rand((nsub, w), generator=g,
                                             device=device) * 1.5}
    for i, name in enumerate(("mask1", "mask2")):
        raw[name] = masks(w, n_masks, cfg["mask_scale"],
                          cfg["mask_seed"] + i, device)
    return raw


def ivim_slabs(cfg: dict, shape: list[int], count: int, snr: float,
               seed: int, device: torch.device) -> list[torch.Tensor]:
    """``count`` distinct slabs [X, Y, Z, Nb] fp32 of synthetic IVIM
    signal (paper Eq. 1) from parameters drawn uniformly over the config's
    ``param_ranges``, Gaussian noise of std S0 / ``snr``, divided by the
    measured S(b=0), as the IVIM-NET input convention has it."""
    g = generator(device, seed, 20)
    b = torch.tensor(cfg["b_values"], dtype=torch.float32, device=device)
    b0 = int(torch.argmin(b))
    r = cfg["param_ranges"]
    n = math.prod(shape)
    out = []
    for _ in range(count):
        def u(lo, hi):
            return lo + torch.rand(n, generator=g, device=device) * (hi - lo)
        d, ds = u(*r["D"]), u(*r["Dstar"])
        f, s0 = u(*r["f"]), u(*r["S0"])
        s = s0[:, None] * (f[:, None] * torch.exp(-b * ds[:, None])
                           + (1 - f[:, None]) * torch.exp(-b * d[:, None]))
        s = s + (s0 / snr)[:, None] * torch.randn(s.shape, generator=g,
                                                  device=device)
        s = s / s[:, b0:b0 + 1].clamp_min(1e-6)
        out.append(s.reshape(*shape, len(cfg["b_values"])))
    return out


def lm_raw(cfg: dict, seed: int, device: torch.device) -> dict:
    """A Qwen2 decoder's weights in the benchmark's own naming, stacked
    over layers, in the config's dtype: ln1_w, wq/bq, wk/bk, wv/bv, wo,
    ln2_w, wg, wu, wd ([L, ...] each), embed [V, D], unembed [D, V],
    norm_w, and the FFN masks [N, F]. Products' weights are N(0, 1/d_in),
    the q/k/v biases N(0, 0.02^2); RMSNorm scales N(1, 0.1^2); the
    embedding N(0, 0.02^2)."""
    g = generator(device, seed, 30)
    dt = DTYPES[cfg["dtype"]]
    nl, d, f, v = (cfg[k] for k in ("n_layers", "d_model", "d_ff",
                                    "vocab_size"))
    qd = cfg["n_heads"] * cfg["head_dim"]
    kvd = cfg["n_kv_heads"] * cfg["head_dim"]

    def randn(shape, scale, shift=0.0):
        t = torch.randn(shape, generator=g, device=device, dtype=dt)
        t.mul_(scale)
        return t.add_(shift) if shift else t

    raw = {}
    for name, shape in (("wq", (d, qd)), ("wk", (d, kvd)), ("wv", (d, kvd)),
                        ("wo", (qd, d)), ("wg", (d, f)), ("wu", (d, f)),
                        ("wd", (f, d))):
        raw[name] = randn((nl,) + shape, 1.0 / math.sqrt(shape[0]))
    for name, width in (("bq", qd), ("bk", kvd), ("bv", kvd)):
        raw[name] = randn((nl, width), 0.02)
    for name in ("ln1_w", "ln2_w"):
        raw[name] = randn((nl, d), 0.1, 1.0)
    raw["embed"] = randn((v, d), 0.02)
    raw["unembed"] = randn((d, v), 1.0 / math.sqrt(d))
    raw["norm_w"] = randn((d,), 0.1, 1.0)
    raw["masks"] = masks(f, cfg["mask_samples"], cfg["mask_scale"],
                         cfg["mask_seed"], device)
    return raw
