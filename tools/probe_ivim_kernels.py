"""Probe the IVIM main path's kernels on the card: voxel tile sizes, and
what their 3xTF32 products buy over plain TF32.

    python3 tools/probe_ivim_kernels.py --out DIR

``DIR`` (outside the checkout) receives variant copies of
``src/repro_torch/kernels/csrc`` and their libraries, all built together
(one ``nvcc`` a source). At the dense IVIM plan's 4,096-voxel chunk
(uIVIM-NET, 104 b-values, 8 masks, scale 2; random weights from seed 0,
BN statistics from seed 1, as ``chip_smoke.py`` makes them), fp32 and
int8, it prints one ``[probe]`` line a measurement:

- ``tile``: ``fused_moments`` and ``fused_samples`` at T = 32, 64 and 128
  voxels a block (their C entries take T), and ``masked_ffn`` in both grid
  orders built at kT = 32, 64 and 128 (a compile-time tile);
- ``tf32``: the three kernels' max abs error against their plain versions,
  and that error over the plain output's largest magnitude, built as
  committed (3xTF32) and with ``dense_tile::tc_fma`` cut to one product of
  round-to-nearest tf32 operands (plain TF32).

Times are CUDA events around back-to-back launches (20 after 3 warm-ups).
It needs one card, ``nvcc`` and the port; it imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TILES = (32, 64, 128)
CHUNK = 4096
# dense_tile.cuh edits giving plain TF32: operands rounded to nearest
# (ties away) instead of cut, and only the hi . hi product kept
PLAIN_TF32 = (
    ("hi = __float_as_uint(x) & 0xffffe000u;",
     "hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;"),
    ("if (j < nt) mma_tf32(acc[j], al, bh[j]);", ";"),
    ("if (j < nt) mma_tf32(acc[j], ah, bl[j]);", ";"),
)
MFFN_TILE = "constexpr int kT = 64;"


def _phase(**fields) -> None:
    print("[probe] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def build_variants(out: Path) -> dict[str, Path]:
    """Variant source trees under ``out``, each built into ``lib*.so``;
    returns {variant: directory}."""
    from repro_torch.kernels import _build
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    variants = {"committed": ({}, ("fused_plan", "masked_ffn")),
                "plain_tf32": ({"dense_tile.cuh": PLAIN_TF32},
                               ("fused_plan", "masked_ffn"))}
    for tile in TILES:
        if tile != 64:
            variants[f"kt{tile}"] = (
                {"masked_ffn.cu": ((MFFN_TILE,
                                    f"constexpr int kT = {tile};"),)},
                ("masked_ffn",))
    jobs, dirs = [], {}
    for name, (edits, stems) in variants.items():
        d = out / name
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(csrc, d)
        for fname, subs in edits.items():
            text = (d / fname).read_text()
            for old, new in subs:
                if text.count(old) != 1:
                    raise RuntimeError(f"{name}: {fname} has {old!r} "
                                       f"{text.count(old)} times")
                text = text.replace(old, new)
            (d / fname).write_text(text)
        for stem in stems:
            jobs.append((name, stem, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                 str(d / f"lib{stem}.so"), str(d / f"{stem}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        dirs[name] = d
    for name, stem, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name}/{stem}:\n{log}")
    return dirs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, required=True,
                    help="directory for the variant sources and libraries")
    out = ap.parse_args().out.resolve()
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False

    from repro_torch.core import plan as plan_lib
    from repro_torch.ivim import data as ivim_data
    from repro_torch.ivim import model as ivim_model
    from repro_torch.ivim import physics
    from repro_torch.kernels import _build
    from repro_torch.kernels.fused_plan import ops as fp_ops
    from repro_torch.kernels.fused_plan import ref as fp_ref
    from repro_torch.kernels.masked_ffn import ops as mffn_ops
    from repro_torch.kernels.masked_ffn import ref as mffn_ref

    dev = torch.device("cuda", torch.cuda.current_device())
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0],
          flush=True)
    out.mkdir(parents=True, exist_ok=True)
    dirs = build_variants(out)
    libs = {(name, stem): ctypes.CDLL(str(d / f"lib{stem}.so"))
            for name, d in dirs.items() for stem in ("fused_plan",
                                                     "masked_ffn")
            if (d / f"lib{stem}.so").exists()}

    def entry(variant, stem, fn, argtypes):
        f = getattr(libs[(variant, stem)], fn)
        f.argtypes, f.restype = argtypes, ctypes.c_int
        return f

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
    x = ivim_data.make_dataset(ivim_data.SyntheticConfig(
        n_voxels=CHUNK, snr=20.0, b_values=physics.DENSE_B_VALUES, seed=0),
        device=dev)["signals"]
    stream = _build.stream_of(dev)

    for quant in (False, True):
        pp = plan.with_precision(plan_lib.Precision("int8")) if quant \
            else plan
        spec, params = plan_lib.lower_fused(pp)
        fp = fp_ops.pack(spec, params)
        desc = fp_ops._layout(spec).desc.ctypes.data
        ptrs = fp_ops._param_ptrs(fp)
        cols = spec.groups * spec.d_out
        body = plan.params["body"]
        d2 = body["w2p"].shape[-1]
        if quant:
            q1, s1 = plan_lib._quantize_weight(body["w1p"])
            q2, s2 = plan_lib._quantize_weight(body["w2p"])
            args = (x, q1, plan_lib._low_bias(body["b1p"]), q2,
                    torch.zeros(d2, dtype=torch.bfloat16, device=dev), s1, s2)
        else:
            args = (x, body["w1p"], body["b1p"], body["w2p"],
                    torch.zeros(d2, device=dev))
        n, d, k = args[1].shape
        plain = {"fused_plan_moments": fp_ref.fused_moments_ref(spec, x,
                                                                params),
                 "fused_plan_samples": (fp_ref.fused_plan_ref(spec, x,
                                                              params),),
                 "masked_ffn": (mffn_ref.masked_ffn_ref(*args),)}

        def fused(variant, moments, T):
            smem = fp_ops.check_residency(spec, T)
            if moments:
                res = torch.empty((2, x.shape[0], cols), device=dev)
                fn = entry(variant, "fused_plan", "fused_moments_launch",
                           fp_ops._MOMENTS_ARGTYPES)
                ptr_out = (res[0].data_ptr(), res[1].data_ptr())
            else:
                res = torch.empty((spec.n_rows, x.shape[0], spec.d_out),
                                  device=dev)
                fn = entry(variant, "fused_plan", "fused_samples_launch",
                           fp_ops._SAMPLES_ARGTYPES)
                ptr_out = (res.data_ptr(),)

            def run():
                _build.check_launch("probe", fn(
                    desc, x.data_ptr(), x.shape[0], *ptrs, *ptr_out, T, smem,
                    stream))
                return tuple(res) if moments else (res,)
            return run

        def ffn(variant, sample_major):
            y = torch.empty((n, x.shape[0], d2), device=dev)
            if quant:
                fn = entry(variant, "masked_ffn", "masked_ffn_q_launch",
                           mffn_ops._Q_ARGTYPES)
                ptr_in = (args[0], args[1], args[5], args[2], args[3],
                          args[6], args[4])
            else:
                fn = entry(variant, "masked_ffn", "masked_ffn_launch",
                           mffn_ops._ARGTYPES)
                ptr_in = args

            def run():
                _build.check_launch("probe", fn(
                    *(t.data_ptr() for t in ptr_in), y.data_ptr(),
                    x.shape[0], d, k, d2, n, int(sample_major), stream))
                return (y,)
            return run

        for T in TILES:
            for name, moments in (("fused_plan_moments", True),
                                  ("fused_plan_samples", False)):
                run = fused("committed", moments, T)
                _phase(kind="tile", kernel=name, int8=quant, T=T,
                       ms=time_ms(run), max_abs_err=_err(run(), plain[name]))
            variant = "committed" if T == 64 else f"kt{T}"
            for major in (True, False):
                run = ffn(variant, major)
                _phase(kind="tile", kernel="masked_ffn", int8=quant, T=T,
                       order="batch_level" if major else "sampling_level",
                       ms=time_ms(run),
                       max_abs_err=_err(run(), plain["masked_ffn"]))
        for variant in ("committed", "plain_tf32"):
            for name, run in (
                    ("fused_plan_moments", fused(variant, True, 64)),
                    ("fused_plan_samples", fused(variant, False, 64)),
                    ("masked_ffn", ffn(variant, True))):
                got = run()
                _phase(kind="tf32", kernel=name, int8=quant,
                       products="3xTF32" if variant == "committed"
                       else "1xTF32", max_abs_err=_err(got, plain[name]),
                       rel_err=_rel(got, plain[name]))
    return 0


def _err(got, want) -> float:
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


def _rel(got, want) -> float:
    """Max abs error over the plain output's largest magnitude, the worst
    of the outputs."""
    return max(float((g - w).abs().max() / w.abs().max())
               for g, w in zip(got, want))


if __name__ == "__main__":
    os.environ.setdefault("PYTHONUNBUFFERED", "1")
    sys.exit(main())
