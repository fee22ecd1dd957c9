#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one card and hold every
kernel of those paths against its plain PyTorch version.

    python3 chip_smoke.py          # from the repository root; needs one card

Two main paths, each driven with the launch counts set to 0 just before it
and read just after:

* uIVIM-NET voxel uncertainty at the dense 104-b-value protocol with 8
  masks (4 sub-networks x 8 masks = 32 rows on the kernels' sample axis):
  ``ivim.model.pack_for_serving`` compiles the plan and
  ``serving.engine.predict_volume`` serves a synthetic 128x128x24 slab
  (393,216 voxels x 104 b-values) in 4,096-voxel chunks.
* Bayesian LM serving: ``qwen2-1.5b`` at its published widths and full
  depth (28 layers, bf16, random weights) with 4 Masksembles masks;
  ``serving.engine.serve_uncertain`` serves 8 requests x 128-token prompts
  and generates 32 tokens (a 32-row mask-major pool), fused and per-op,
  then the same in fp32.

Phases, each on its own line; any failure raises and exits nonzero:
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA
     versions, and the kernels' build (nvcc, from csrc/) with its time;
  2. kernels vs plain: each kernel against its ref.py version on the card at
     the main shapes and at ragged shapes: max abs error, kernel ms, plain
     ms and the bound from bytes and FLOPs;
  3. IVIM main path: the volume served fused and per-op, and through the
     plain fused_moments_ref, each held to the unpacked model at 2e-4, with
     the launch counts of each leg asserted and voxels/s printed;
  4. LM kernel vs plain at full width (masked and packed FFN, bf16, and
     the fp32 copy) and at a ragged smoke shape, with the per-op step's
     time and the kernel's per-stage times beside it;
  5. LM main path: ``serve_uncertain`` fused and per-op in bf16 and fp32,
     launch counts asserted (one fused_decode launch per emitted token on
     the fused legs, none on the per-op legs), fp32 legs held together;
  6. one JSON line with every kernel's numbers, then the device line.

Weights are random from ``torch.Generator`` seeds (IVIM: seed 0 with
non-trivial BN running statistics from seed 1; LM: seed 0); the data is
made on the card. TF32 is off throughout: the reference's fp32 products
are true fp32.
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
LM_ARCH, LM_MASKS, LM_BATCH, LM_PROMPT, LM_NEW = "qwen2-1.5b", 4, 8, 128, 32
# fused_decode vs its plain version: fp32 sums in another order (split
# reductions meet in atomics) over 28 layers of 1,536- to 8,960-long
# products; measured at most 3.8e-6 on mean_logp, 2.6e-7 on rel_unc.
TOL_DECODE = 1e-4
# k/v outputs are rounded to bf16 from fp32 values that differ by that
# noise: within one bf16 ulp of the plain value, plus the fp32 noise at the
# tensor's scale (the fp32 k/v differ by at most 1.4e-6 x max |k|), which
# decides the rounding of elements near zero.
TOL_KV_SCALE = 1e-5
# fp32 serve_uncertain, fused vs per-op, after 32 greedy steps: the
# reference's posterior bar (rtol 1e-4 at smoke size) widened for depth.
TOL_LM_UNC = 1e-3


def _phase(phase: str, /, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def _tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree(fn, v) for v in tree]
    return fn(tree)


def _within_bf16_ulp(got, want) -> float:
    """Max abs error of bf16 ``got`` against ``want``; raises beyond one
    bf16 ulp of ``want`` plus TOL_KV_SCALE x max |want|."""
    got, want = got.float(), want.float()
    ulp = (want.abs().clamp_min(1e-30).log2().floor() - 7).exp2()
    err = (got - want).abs()
    if not bool((err <= ulp + TOL_KV_SCALE * want.abs().max()).all()):
        raise AssertionError(f"k/v beyond one bf16 ulp: {float(err.max())}")
    return float(err.max())


def lm_phases(dev, time_ms, bound, nbytes, counters) -> dict:
    """Phases 4 and 5: the LM decode kernel against its plain version at
    full width, then ``serve_uncertain`` fused and per-op. Returns the
    fused_decode record of the kernels line."""
    import dataclasses

    import torch
    from repro_torch.configs import registry
    from repro_torch.core import plan as plan_lib
    from repro_torch.kernels.fused_decode import ops as fd_ops
    from repro_torch.models import layers, model as lm_model, transformer
    from repro_torch.serving import engine, server

    cfg = registry.get_config(LM_ARCH, mask_samples=LM_MASKS)
    model = lm_model.build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    _phase("lm_model", arch=LM_ARCH, params=cfg.param_count(),
           layers=cfg.n_layers, d_model=cfg.d_model, d_ff=cfg.d_ff,
           vocab=cfg.vocab_size, masks=LM_MASKS, dtype=cfg.dtype,
           init_s=f"{time.perf_counter() - t0:.1f}")
    prompts = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                            generator=torch.Generator(dev).manual_seed(1),
                            device=dev, dtype=torch.int32)
    max_seq = LM_PROMPT + LM_NEW

    def pool(c, p, n, toks, cap=max_seq):
        """Prefill a mask-major pool; returns (caches, next tokens)."""
        mean, _, caches = server.step_fns(c, fused=False, device=dev) \
            .prefill(p, toks.repeat(n, 1), max_seq=cap)
        return caches, mean.argmax(-1).to(torch.int32).repeat(n)[:, None]

    def operands(c, p, caches, tok, plen):
        rows = tok.shape[0]
        spec = plan_lib.lower_fused_decode(c)
        flat = plan_lib._decode_flat_params(spec, c, p, rows, True)
        fc = plan_lib._decode_flat_caches(c, caches)
        pos = torch.full((rows,), plen, dtype=torch.int32, device=dev)
        rot = next(s.rot_dim for s in spec.steps if s.kind == "attn")
        x = layers.embed_tokens(p["embed"], tok[:, 0])
        cos, sin = layers.rope_cos_sin(pos, rot, c.rope_theta)
        return spec, (x, flat, fc, pos, cos, sin)

    recs = {}

    def kernel_case(name, c, p, caches, tok, plen, step_legs=False):
        spec, args = operands(c, p, caches, tok, plen)
        got = fd_ops.fused_decode(spec, *args)
        want = fd_ops.fused_decode_ref(spec, *args)
        torch.cuda.synchronize()
        for g, w in zip(got[:2], want[:2]):
            torch.testing.assert_close(g, w, rtol=TOL_DECODE,
                                       atol=TOL_DECODE)
        err = max(float((g - w).abs().max())
                  for g, w in zip(got[:2], want[:2]))
        kv_err = max(_within_bf16_ulp(g, w) if g.dtype == torch.bfloat16
                     else float((g - w).abs().max())
                     for g, w in zip(got[2:], want[2:]))
        # k/v error at the tensor's scale, and the kernel against itself
        # (its split sums meet in atomics, in another order each launch)
        kv_scale_err = max(float((g.float() - w.float()).abs().max()
                                 / w.float().abs().max())
                           for g, w in zip(got[2:], want[2:]))
        again = fd_ops.fused_decode(spec, *args)
        kv_self = sum(int(((g.float() - a.float()).abs() > (
            g.float().abs().clamp_min(1e-30).log2().floor() - 7).exp2())
            .sum()) for g, a in zip(got[2:], again[2:])) \
            if got[2].dtype == torch.bfloat16 else 0
        x, flat, fc, pos, cos, sin = args
        rows, smax = x.shape[0], fc[0].shape[2]
        # what this step's data needs: attention reads and scores only the
        # cache slots that are valid for the row (kpos in [0, pos], not the
        # slot being overwritten), plus the fresh key
        attn = [s for s in spec.steps if s.kind == "attn"]
        p64 = pos.long()
        seen = 0
        for st, k, kpos in zip(attn, fc[0::3], fc[2::3]):
            slot = ((p64 % st.window) if st.window else p64) % smax
            seen += int(((kpos >= 0) & (kpos <= p64[:, None])
                         & (torch.arange(smax, device=dev)[None, :]
                            != slot[:, None])).sum())
        at = attn[0]
        per_key = 4 * at.n_heads * at.head_dim // at.n_kv_heads
        flops = plan_lib.decode_traffic(spec, rows, smax).flops \
            - len(attn) * rows * at.n_kv_heads * per_key * (smax + 1) \
            + at.n_kv_heads * per_key * (seen + len(attn) * rows)
        kv_bytes = 2 * seen * at.n_kv_heads * at.head_dim \
            * fc[0].element_size() + nbytes(*fc[2::3])
        moved = nbytes(x, pos, cos, sin, *got, *flat) + kv_bytes
        rec = {"shape": name, "max_abs_err": err, "kv_max_abs_err": kv_err,
               "kv_err_over_max": kv_scale_err,
               "kv_beyond_1ulp_of_itself": kv_self,
               "ms": time_ms(lambda: fd_ops.fused_decode(spec, *args), 10),
               "plain_ms": time_ms(lambda: fd_ops.fused_decode_ref(
                   spec, *args), 3),
               "blocks": fd_ops.last_grid["blocks"], "rows": rows,
               "gflop": flops / 1e9, "mbytes": moved / 1e6}
        # the last timed launch, per stage (block 0's barrier timestamps)
        rec["stage_ms"] = {k: round(v, 4) for k, v in
                           fd_ops.stage_ms(spec, rows, dev).items()}
        rec["bound_ms"], rec["bound_by"] = bound(flops, moved)
        if step_legs:                   # whole serving steps, same operands
            # and the fused step's parts outside the kernel
            rot = next(st.rot_dim for st in spec.steps if st.kind == "attn")
            rec["embed_rope_ms"] = time_ms(lambda: (
                layers.embed_tokens(p["embed"], tok[:, 0]),
                layers.rope_cos_sin(pos, rot, c.rope_theta)), 10)
            rec["cache_commit_ms"] = time_ms(
                lambda: plan_lib._decode_commit_caches(c, caches, got[2],
                                                       got[3], pos), 3)
            mk = lm_model.build_model(c)
            for leg, fused in (("fused_step_ms", None),
                               ("per_op_step_ms", False)):
                fns = server.step_fns(mk, fused=fused, device=dev)
                rec[leg] = time_ms(lambda: fns.decode(p, caches, tok, plen),
                                   3)
        _phase("lm_kernel", name="fused_decode", **rec)
        recs[name] = rec

    caches, tok = pool(cfg, params, LM_MASKS, prompts)
    kernel_case("main", cfg, params, caches, tok, LM_PROMPT, step_legs=True)
    pcfg = dataclasses.replace(cfg, packed_ffn_serving=True)
    pparams = transformer.pack_ffn_params(cfg, params)
    kernel_case("packed", pcfg, pparams, caches, tok, LM_PROMPT)
    del pparams
    scfg = registry.smoke_config(LM_ARCH, n_layers=2, d_model=40,
                                 head_dim=10, d_ff=72, vocab_size=100)
    sparams = transformer.init(scfg, torch.Generator(dev).manual_seed(2),
                               device=dev)
    stoks = torch.randint(0, 100, (3, 6), device=dev, dtype=torch.int32,
                          generator=torch.Generator(dev).manual_seed(3))
    scaches, stok = pool(scfg, sparams, 4, stoks, cap=7)
    kernel_case("ragged", scfg, sparams, scaches, stok, 6)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = _tree(lambda t: t.float(), params)
    caches32, tok32 = pool(cfg32, params32, LM_MASKS, prompts)
    kernel_case("fp32", cfg32, params32, caches32, tok32, LM_PROMPT)
    del caches32

    # ---- phase 5: the LM main path ----------------------------------------
    def leg(c, p, fused):
        mk = lm_model.build_model(c)
        fns = server.step_fns(mk, fused=fused, device=dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        fns.prefill(p, prompts.repeat(LM_MASKS, 1), max_seq=max_seq)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t
        for ctr in counters:
            ctr.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = engine.serve_uncertain(
            mk, p, prompts, engine.ServeConfig(max_new_tokens=LM_NEW,
                                               fused=fused), device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        counts = tuple(ctr.launches for ctr in counters)
        expect = (0, 0, 0, LM_NEW if fused is None else 0)
        if counts != expect:
            raise AssertionError(f"LM {c.dtype} fused={fused} launches "
                                 f"(masked_ffn, samples, moments, decode) = "
                                 f"{counts}, expected {expect}")
        if fused is None and not fns.fused_live():
            raise AssertionError("fused leg fell back to the per-op path")
        gen, unc, _ = out
        if gen.shape != (LM_BATCH, LM_PROMPT + LM_NEW) or \
                not bool(torch.isfinite(unc).all()):
            raise AssertionError(f"LM output {tuple(gen.shape)}, finite "
                                 f"{bool(torch.isfinite(unc).all())}")
        step_ms = 1e3 * (secs - prefill_s) / LM_NEW
        _phase("lm_main_path", dtype=c.dtype,
               leg="fused" if fused is None else "per_op",
               seconds=f"{secs:.4f}", prefill_s=f"{prefill_s:.4f}",
               decode_ms_per_step=f"{step_ms:.3f}",
               tokens_per_s=f"{LM_BATCH * LM_NEW / secs:.1f}",
               decode_tokens_per_s=f"{1e3 * LM_BATCH / step_ms:.1f}",
               launches=counts)
        return out, counts

    legs = {}
    for fused in (None, False):
        legs[("bf16", fused)] = leg(cfg, params, fused)
    same = float((legs[("bf16", None)][0][0] == legs[("bf16", False)][0][0])
                 .float().mean())
    _phase("lm_agreement", dtype="bf16", tokens_equal_share=same,
           note="bf16 fused vs per-op is reported, not gated")
    del params
    for fused in (None, False):
        legs[("fp32", fused)] = leg(cfg32, params32, fused)
    (fg, fu, _), _ = legs[("fp32", None)]
    (pg, pu, _), _ = legs[("fp32", False)]
    if not torch.equal(fg, pg):
        raise AssertionError("fp32 fused and per-op legs generated "
                             "different tokens")
    torch.testing.assert_close(fu, pu, rtol=TOL_LM_UNC, atol=1e-5)
    _phase("lm_agreement", dtype="fp32", tokens_equal=True,
           rel_unc_max_abs_err=float((fu - pu).abs().max()),
           rel_unc_mean=float(fu.mean()))
    main = recs["main"]
    return {
        "name": "fused_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_decode.cu",
        "replaces": "src/repro/kernels/fused_plan/kernel.py:260"
                    " (pallas_call :324)",
        "launches": legs[("bf16", None)][1][3],
        "max_abs_err": max(r["max_abs_err"] for r in recs.values()),
        "ms": main["ms"], "kernel_ms": main["ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": None,
        "packed_ms": recs["packed"]["ms"],
        "packed_bound_ms": recs["packed"]["bound_ms"],
        "ragged_ms": recs["ragged"]["ms"], "fp32_ms": recs["fp32"]["ms"],
        "per_op_step_ms": main["per_op_step_ms"],
        "fused_step_ms": main["fused_step_ms"]}


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

    # ---- phases 4 and 5: the LM kernel and the LM main path ---------------
    from repro_torch.kernels.fused_decode import ops as fd_ops
    decode_rec = lm_phases(dev, time_ms, bound, nbytes,
                           counters + (fd_ops.fused_decode,))

    # ---- phase 6: the kernels line, then the device line ------------------
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
    line.append(decode_rec)
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
