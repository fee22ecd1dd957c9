#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one card and hold every kernel
of that path against its plain PyTorch version.

    python3 chip_smoke.py          # from the repository root; needs one card

The main path is the paper's workload, uIVIM-NET voxel uncertainty at the
dense 104-b-value protocol with 8 masks (4 sub-networks x 8 masks = 32 rows
on the kernels' sample axis): ``ivim.model.pack_for_serving`` compiles the
plan and ``serving.engine.predict_volume`` serves a synthetic 128x128x24
slab (393,216 voxels x 104 b-values) in 4,096-voxel chunks.

Phases, each on its own line; any failure raises and exits nonzero:
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA
     versions, and the kernels' build (nvcc, from csrc/) with its time;
  2. kernels vs plain: each kernel against its ref.py version on the card at
     the main shapes and at ragged shapes (B = 4,097, width 11, 1 mask):
     max abs error, kernel ms, plain ms and the bound from bytes and FLOPs;
  3. main path: the volume served fused and per-op, and through the plain
     fused_moments_ref, each held to the unpacked model at 2e-4, with the
     launch counts of each leg asserted and voxels/s printed;
  4. one JSON line with every kernel's numbers, then the device line.

Weights are random from ``torch.Generator`` seed 0 (with non-trivial BN
running statistics from seed 1); the volume comes from ``ivim.data`` at SNR
20, seed 0, made on the card. TF32 is off throughout: the reference's fp32
products are true fp32.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

#: NVIDIA H100 SXM data sheet: fp32 outside the tensor cores, HBM3 rate.
FP32_PEAK = 67e12
HBM_BW = 3.35e12
CHUNK = 4096
VOLUME = (128, 128, 24)
TOL_MOMENTS = 2e-4      # the reference's fused-vs-per-op tolerance
TOL_SAMPLES = 1e-4      # fp32 sums in another order than the batched GEMM


def _phase(phase: str, /, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: no port package under {src}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.core import plan as plan_lib
    from repro_torch.ivim import data as ivim_data
    from repro_torch.ivim import model as ivim_model
    from repro_torch.ivim import physics
    from repro_torch.kernels import _build
    from repro_torch.kernels.fused_plan import ops as fp_ops
    from repro_torch.kernels.fused_plan import ref as fp_ref
    from repro_torch.kernels.masked_ffn import ops as mffn_ops
    from repro_torch.kernels.masked_ffn import ref as mffn_ref
    from repro_torch.serving import engine

    dev = torch.device("cuda", torch.cuda.current_device())
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    t0 = time.perf_counter()
    logs = _build.build()
    build_s = time.perf_counter() - t0
    _phase("device", name=repr(torch.cuda.get_device_name(0)),
           torch=torch.__version__, cuda=torch.version.cuda,
           build_s=f"{build_s:.1f}", built=sorted(logs))
    for stem, log in sorted(logs.items()):
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                _phase("ptxas", source=stem, info=line.strip())

    def time_ms(fn, reps: int = 20) -> float:
        for _ in range(3):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / reps

    def nbytes(*tensors) -> int:
        return sum(t.numel() * t.element_size() for t in tensors)

    def bound(flops: int, moved: int) -> tuple[float, str]:
        t_ops, t_bytes = flops / FP32_PEAK, moved / HBM_BW
        return (1e3 * max(t_ops, t_bytes),
                "operations" if t_ops >= t_bytes else "bytes")

    def max_err(got, want, tol: float) -> float:
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=tol, atol=tol)
        return max(float((g - w).abs().max()) for g, w in zip(got, want))

    # ---- the dense model and its plan (shared by phases 2 and 3) ----------
    cfg = ivim_model.IvimConfig(b_values=physics.DENSE_B_VALUES, n_masks=8,
                                scale=2.0)
    model = ivim_model.init(cfg, torch.Generator().manual_seed(0),
                            device=dev)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for i in (1, 2):
            shape = getattr(model, f"bn{i}_mean").shape
            getattr(model, f"bn{i}_mean").copy_(
                0.2 * torch.randn(shape, generator=gen))
            getattr(model, f"bn{i}_var").copy_(
                0.5 + torch.rand(shape, generator=gen))
            getattr(model, f"bn{i}")["gamma"].copy_(
                0.5 + torch.rand(shape, generator=gen))
            getattr(model, f"bn{i}")["beta"].copy_(
                0.1 * torch.randn(shape, generator=gen))
    model.eval()
    plan = ivim_model.pack_for_serving(model)
    n_vox = VOLUME[0] * VOLUME[1] * VOLUME[2]
    volume = ivim_data.make_dataset(ivim_data.SyntheticConfig(
        n_voxels=n_vox, snr=20.0, b_values=physics.DENSE_B_VALUES, seed=0),
        device=dev)["signals"].reshape(*VOLUME, cfg.width)
    voxels = volume.reshape(n_vox, cfg.width)

    small_cfg = ivim_model.IvimConfig(n_masks=1, scale=2.0)
    small_plan = ivim_model.pack_for_serving(ivim_model.init(
        small_cfg, torch.Generator().manual_seed(2), device=dev))
    x_ragged = torch.rand((4097, small_cfg.width),
                          generator=torch.Generator(dev).manual_seed(3),
                          device=dev)

    # ---- phase 2: every kernel against its plain version ------------------
    kernels = {}

    def pair_case(p, x):
        body = p.params["body"]
        b2 = torch.zeros(body["w2p"].shape[-1], device=dev)
        return (x, body["w1p"], body["b1p"], body["w2p"], b2)

    for shape_name, p, x in (("main", plan, voxels[:CHUNK]),
                             ("ragged", small_plan, x_ragged)):
        args = pair_case(p, x)
        n, d, k = args[1].shape
        d2 = args[3].shape[-1]
        err = max_err([mffn_ops.masked_ffn(*args)],
                      [mffn_ref.masked_ffn_ref(*args)], TOL_SAMPLES)
        flops = 2 * n * x.shape[0] * (d * k + k * d2)
        moved = nbytes(*args) + 4 * n * x.shape[0] * d2
        rec = {"name": "masked_ffn", "route": "cuda",
               "source": "src/repro_torch/kernels/csrc/masked_ffn.cu",
               "replaces": "src/repro/kernels/masked_ffn/kernel.py:79",
               "shape": shape_name, "max_abs_err": err,
               "ms": time_ms(lambda: mffn_ops.masked_ffn(*args)),
               "plain_ms": time_ms(lambda: mffn_ref.masked_ffn_ref(*args))}
        rec["bound_ms"], rec["bound_by"] = bound(flops, moved)
        kernels.setdefault("masked_ffn", []).append(rec)

        spec, params = plan_lib.lower_fused(p)
        fp = fp_ops.pack(spec, params)
        b = x.shape[0]
        flops = p.traffic(b, 4, fused=True, moments=True).flops
        cases = (
            ("fused_plan_samples", "src/repro/kernels/fused_plan/kernel.py:106"
             " (pallas_call :165, moments=False)",
             lambda: (fp_ops.fused_samples(fp, x),),
             lambda: (fp_ref.fused_plan_ref(spec, x, params),),
             TOL_SAMPLES, 4 * spec.n_rows * b * spec.d_out),
            ("fused_plan_moments", "src/repro/kernels/fused_plan/kernel.py:106"
             " (pallas_call :222, moments=True)",
             lambda: fp_ops.fused_moments(fp, x),
             lambda: fp_ref.fused_moments_ref(spec, x, params),
             TOL_MOMENTS, 2 * 4 * b * spec.groups * spec.d_out))
        for name, replaces, run, plain, tol, out_bytes in cases:
            rec = {"name": name, "route": "cuda",
                   "source": "src/repro_torch/kernels/csrc/fused_plan.cu",
                   "replaces": replaces, "shape": shape_name,
                   "max_abs_err": max_err(run(), plain(), tol),
                   "ms": time_ms(run), "plain_ms": time_ms(plain)}
            rec["bound_ms"], rec["bound_by"] = bound(
                flops, nbytes(x, fp.flat) + out_bytes)
            kernels.setdefault(name, []).append(rec)
    for recs in kernels.values():
        for rec in recs:
            _phase("kernel", **{k: rec[k] for k in (
                "name", "shape", "max_abs_err", "ms", "plain_ms",
                "bound_ms", "bound_by")})

    # ---- phase 3: the main path --------------------------------------------
    ref_mean, ref_std = [], []
    for lo in range(0, n_vox, 8 * CHUNK):        # unpacked model, in slices
        m, s = ivim_model.predict(model, voxels[lo:lo + 8 * CHUNK])
        ref_mean.append(m)
        ref_std.append(s)
    want = (torch.cat(ref_mean).reshape(*VOLUME, 4),
            torch.cat(ref_std).reshape(*VOLUME, 4))
    counters = (mffn_ops.masked_ffn, fp_ops.fused_samples,
                fp_ops.fused_moments)

    def run_leg(fn):
        for c in counters:
            c.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        return out, secs, tuple(c.launches for c in counters)

    def plain_volume():
        spec, params = plan_lib.lower_fused(plan)
        lo_r = torch.tensor([r[0] for r in plan.out_ranges], device=dev)
        hi_r = torch.tensor([r[1] for r in plan.out_ranges], device=dev)
        means, stds = [], []
        for lo in range(0, n_vox, CHUNK):
            m, s = fp_ref.fused_moments_ref(spec, voxels[lo:lo + CHUNK],
                                            params)
            means.append(lo_r + m * (hi_r - lo_r))
            stds.append(s * (hi_r - lo_r).abs())
        return (torch.cat(means).reshape(*VOLUME, 4),
                torch.cat(stds).reshape(*VOLUME, 4))

    n_chunks = -(-n_vox // CHUNK)
    legs = {
        "fused": (lambda: engine.predict_volume(
            plan, volume, chunk=CHUNK, fused=True, device=dev),
            (0, 0, n_chunks)),
        "per_op": (lambda: engine.predict_volume(
            plan, volume, chunk=CHUNK, fused=False, device=dev),
            (n_chunks, 0, 0)),
        "plain": (plain_volume, (0, 0, 0)),
    }
    launches = {}
    for leg, (fn, expect) in legs.items():
        (mean, std), secs, counts = run_leg(fn)
        if counts != expect:
            raise AssertionError(f"{leg} leg launches (masked_ffn, samples, "
                                 f"moments) = {counts}, expected {expect}")
        if not (torch.isfinite(mean).all() and torch.isfinite(std).all()):
            raise AssertionError(f"{leg} leg: non-finite moments")
        err = max_err((mean, std), want, TOL_MOMENTS)
        _phase("main_path", leg=leg, voxels=n_vox, chunks=n_chunks,
               seconds=f"{secs:.4f}", voxels_per_s=f"{n_vox / secs:.0f}",
               max_abs_err=err, launches=counts)
        launches[leg] = counts

    chunk0 = voxels[:CHUNK]
    samples, _, counts = run_leg(lambda: ivim_model.packed_apply(
        plan, chunk0, fused=True, device=dev))
    if counts != (0, 1, 0):
        raise AssertionError(f"packed_apply(fused=True) launches {counts}")
    err = max_err([samples], [ivim_model.apply_all_samples(model, chunk0)],
                  TOL_MOMENTS)
    _phase("main_path", leg="packed_apply_fused", voxels=CHUNK,
           max_abs_err=err, launches=counts)

    # ---- phase 4: the kernels line, then the device line ------------------
    main_launches = {"masked_ffn": launches["per_op"][0],
                     "fused_plan_samples": counts[1],
                     "fused_plan_moments": launches["fused"][2]}
    line = []
    for name, recs in kernels.items():
        main = next(r for r in recs if r["shape"] == "main")
        line.append({
            "name": name, "route": "cuda", "source": main["source"],
            "replaces": main["replaces"], "launches": main_launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": main["ms"], "kernel_ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None,
            "ragged_ms": next(r["ms"] for r in recs
                              if r["shape"] == "ragged")})
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
