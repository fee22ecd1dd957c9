"""Driver of the IVIM cells: ``serving.engine.predict_volume`` on whole
slabs.

Set-up draws uIVIM-NET's raw weights on the device from the seed (BN
running statistics and affine included, the masks from the configuration's
mask seed), builds the program's ``IvimNet`` from them and compiles it with
``ivim.model.pack_for_serving`` (BN folded, mask-zero packing); it makes
the slabs on the device and keeps them in pinned host memory. A slab goes
to the card, through ``predict_volume`` with the entry's default chunking
and executor, and its (mean, std) maps come back to pinned host memory.

The check compares sampled voxels of every slab served (indices drawn from
the seed) with the plain fp32 uIVIM-NET run on the raw weights: the largest
difference of a mean and of a std, each over its parameter's output range.
"""

from __future__ import annotations

import gc
import math

import numpy as np
import torch

from portbench import harness, inputs
from portbench.reference import ivim as ivim_ref

__all__ = ["build_plan", "Session", "setup"]


def _ivim_config(config: dict, n_masks: int):
    from repro_torch.ivim import model as ivim_model
    return ivim_model.IvimConfig(
        b_values=tuple(float(b) for b in config["b_values"]),
        n_masks=n_masks, scale=config["mask_scale"], use_batchnorm=True,
        mask_seed=config["mask_seed"],
        out_ranges=tuple(tuple(r) for r in config["out_ranges"]))


def build_plan(config: dict, raw: dict, n_masks: int):
    """The program's packed plan of uIVIM-NET holding ``raw``."""
    from repro_torch.ivim import model as ivim_model
    params = {k: dict(raw[k]) for k in ("fc1", "fc2", "enc")}
    state = {}
    for k in ("bn1", "bn2"):
        params[k] = {"gamma": raw[k]["gamma"], "beta": raw[k]["beta"]}
        state[k] = {"mean": raw[k]["mean"], "var": raw[k]["var"]}
    params["mask1"], params["mask2"] = raw["mask1"], raw["mask2"]
    net = ivim_model.IvimNet(_ivim_config(config, n_masks), params, state)
    return ivim_model.pack_for_serving(net)


def plan_counts(config: dict, raw: dict) -> dict:
    """Widths of the packed chain the counts need."""
    return {"width": len(config["b_values"]), "groups": 4,
            "n_masks": int(raw["mask1"].shape[0]),
            "k1": int(raw["mask1"][0].sum()), "k2": int(raw["mask2"][0].sum())}


def _pinned(t: torch.Tensor) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype,
                       pin_memory=t.device.type == "cuda")
    host.copy_(t)
    return host


def _errors(config, got_mean, got_std, ref_mean, ref_std) -> tuple:
    span = torch.tensor([hi - lo for lo, hi in config["out_ranges"]],
                        device=ref_mean.device)
    return (float(((got_mean - ref_mean).abs() / span).max()),
            float(((got_std - ref_std).abs() / span).max()))


def _reference(config, raw, x, control: bool, block: int = 1 << 18):
    ctx = ivim_ref.tf32_products() if control else ivim_ref.fp32_products()
    means, stds = [], []
    with ctx:
        for lo in range(0, x.shape[0], block):
            m, s = ivim_ref.moments(raw, x[lo:lo + block],
                                    config["out_ranges"])
            means.append(m)
            stds.append(s)
    return torch.cat(means), torch.cat(stds)


def _check(config, raw, device, samples, control):
    """samples: (x [n, Nb] host, mean [n, 4], std [n, 4]) blocks."""
    if not samples:
        return {"voxels_checked": 0}
    x = torch.cat([s[0] for s in samples]).to(device)
    mean = torch.cat([s[1] for s in samples]).to(device)
    std = torch.cat([s[2] for s in samples]).to(device)
    rm, rs = _reference(config, raw, x, False)
    out = dict(zip(("mean_err", "std_err"),
                   _errors(config, mean, std, rm, rs)))
    out["voxels_checked"] = int(x.shape[0])
    if control:
        cm, cs = _reference(config, raw, x, True)
        out.update(zip(("control.mean_err", "control.std_err"),
                       _errors(config, cm, cs, rm, rs)))
    return out


class _Slabs:
    """The cell's distinct slabs, made on the device from the seed and kept
    in pinned host memory, and the seeded voxel sample of each served one."""

    def __init__(self, config: dict, spec: dict, seed: int,
                 device: torch.device):
        self.config, self.seed = config, seed
        made = inputs.ivim_slabs(config, spec["slab"], spec["distinct"],
                                 spec["snr"], seed, device)
        self.host = [_pinned(s) for s in made]
        del made
        self.nb = len(config["b_values"])
        self.voxels = math.prod(spec["slab"])
        self.per_slab = int(spec["check_voxels"])
        self.rng = np.random.default_rng([seed, 6])

    def flat(self, i: int) -> torch.Tensor:
        return self.host[i].view(-1, self.nb)

    def sample(self, i: int, mean: torch.Tensor, std: torch.Tensor,
               out: list) -> None:
        """Keep this served slab's sampled voxels: (x, mean, std) on the
        host. ``mean``/``std`` are its [voxels, 4] maps."""
        idx = torch.from_numpy(self.rng.integers(0, self.voxels,
                                                 self.per_slab))
        out.append((self.flat(i)[idx], mean[idx.to(mean.device)].cpu(),
                    std[idx.to(std.device)].cpu()))


class Session:
    """One run of an IVIM slab cell (see the module docstring)."""

    def __init__(self, cell: dict, config: dict, seed: int,
                 device: torch.device, trace: bool):
        from repro_torch.serving import engine
        self.engine = engine
        self.cell, self.config, self.seed = cell, config, seed
        self.device = device
        self.ranges = harness.HostRanges(trace)
        spec = cell["traffic"]
        self.setup_parts: dict[str, float] = {}
        mark = harness.Marks(self.setup_parts, device)
        self.raw = inputs.ivim_raw(config, config["n_masks"], seed, device)
        self.plan = build_plan(config, self.raw, config["n_masks"])
        mark("weights_plan")
        self.slabs = _Slabs(config, spec, seed, device)
        mark("slabs")
        shape = tuple(spec["slab"]) + (4,)
        self.out = [torch.empty(shape, pin_memory=device.type == "cuda")
                    for _ in range(2)]
        self.samples: list = []
        self._serve(0, keep=False)        # warm: kernels, chunk runner
        mark("warm")

    def _serve(self, i: int, keep: bool = True) -> None:
        with self.ranges.range("to_device"):
            x = self.slabs.host[i].to(self.device, non_blocking=True)
        with self.ranges.range("predict_volume"):
            mean, std = self.engine.predict_volume(self.plan, x,
                                                   device=self.device)
        with self.ranges.range("to_host"):
            self.out[0].copy_(mean, non_blocking=True)
            self.out[1].copy_(std, non_blocking=True)
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
        if keep:
            self.slabs.sample(i, self.out[0].view(-1, 4),
                              self.out[1].view(-1, 4), self.samples)

    def run(self, seconds: float) -> dict:
        n = len(self.slabs.host)
        t0 = harness.clock()
        done = 0
        with self.ranges.range("window"):
            t1 = t0
            while t1 < t0 + seconds:
                self._serve(done % n)
                done += 1
                t1 = harness.clock()
        self.t0, self.t1 = t0, t1
        self.window = {"window_s": t1 - t0, "slabs": done,
                       "voxels": done * self.slabs.voxels}
        return {"e2e": {"voxels_per_s": self.window["voxels"] / (t1 - t0)},
                "attempted": done, "failed": 0}

    def tally(self) -> dict:
        return {"kind": "ivim", "plan": plan_counts(self.config, self.raw),
                "chunk": 4096, "slab_voxels": self.slabs.voxels,
                **self.window}

    def release(self) -> None:
        self.plan = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, control: bool = False) -> dict:
        return _check(self.config, self.raw, self.device, self.samples,
                      control)


def setup(cell: dict, config: dict, seed: int, device: torch.device,
          trace: bool, run_seconds: float) -> Session:
    return Session(cell, config, seed, device, trace)
