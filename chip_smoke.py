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
* int8 serving: the same IVIM slab at ``Precision("int8")`` (int8 weights,
  bf16 scales, dequantized in the kernels), fused and per-op; and the same
  LM traffic with an int8 KV cache (``kv_dtype="int8"``), which has no
  fused lowering and runs the per-op decode step.

Phases, each on its own line; any failure raises and exits nonzero:
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA
     versions, and the kernels' build (nvcc, from csrc/) with its time;
  2. the int8 quantizer on the card bit-equal to the CPU (the dense plan's
     int8 weights and bf16 scales); then kernels vs plain: each kernel, fp32
     and int8 body, against its ref.py version on the card at the main
     shapes and at ragged shapes: max abs error, kernel ms, plain ms, the
     bound from bytes and FLOPs, and the parameter bytes the kernel reads;
  3. IVIM main path: the volume served fused and per-op, and through the
     plain fused_moments_ref, each held to the unpacked model at 2e-4, with
     the launch counts of each leg asserted and voxels/s printed; then at
     int8: fused (one int8 moments launch a chunk) and per-op (one int8
     masked_ffn launch a chunk) within 2e-4 of each other and 2e-2 of the
     fp32 model, the int8 parameter bytes at most 0.35x the fp32 ones;
  4. LM kernel vs plain at full width (masked and packed FFN, bf16, and
     the fp32 copy) and at a ragged smoke shape, with the per-op step's
     time and the kernel's per-stage times beside it;
  5. LM main path: ``serve_uncertain`` fused and per-op in bf16 and fp32,
     launch counts asserted (one fused_decode launch per emitted token on
     the fused legs, none on the per-op legs), fp32 legs held together;
     then bf16 with the int8 KV cache: ``quantize_kv`` bit-equal to the
     CPU, every cached vector within half an int8 step of its value, no
     fused_decode launch, tokens compared with the bf16-KV per-op leg
     (reported, not gated);
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
# int8 bodies vs plain, and int8 fused vs per-op: the reference's int8 bar
# (tests/test_quantized.py); the dequantized weights are exact in fp32, so
# only the order of the sums differs
TOL_INT8 = 2e-4
# int8 vs the fp32 model: the reference's FP32_TOL["ivim"]
TOL_INT8_VS_FP32 = 2e-2
# int8 parameter bytes over fp32 ones: the reference's weight-bytes gate
INT8_BYTES_GATE = 0.35
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
    def leg(c, p, fused, fused_steps=LM_NEW):
        """One serve_uncertain leg; ``fused_steps`` fused_decode launches
        expected when ``fused`` is None (auto)."""
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
        expect = (0, 0, 0, fused_steps if fused is None else 0)
        if counts != expect:
            raise AssertionError(f"LM {c.dtype} fused={fused} launches "
                                 f"(masked_ffn, samples, moments, decode) = "
                                 f"{counts}, expected {expect}")
        if fused is None and fused_steps and not fns.fused_live():
            raise AssertionError("fused leg fell back to the per-op path")
        gen, unc, _ = out
        if gen.shape != (LM_BATCH, LM_PROMPT + LM_NEW) or \
                not bool(torch.isfinite(unc).all()):
            raise AssertionError(f"LM output {tuple(gen.shape)}, finite "
                                 f"{bool(torch.isfinite(unc).all())}")
        step_ms = 1e3 * (secs - prefill_s) / LM_NEW
        _phase("lm_main_path", dtype=c.dtype, kv_dtype=c.kv_dtype or "model",
               leg="fused" if fused is None and fused_steps else "per_op",
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

    # ---- phase 5 with the int8 KV cache -----------------------------------
    cfg8 = dataclasses.replace(cfg, kv_dtype="int8")
    caches_bf, _ = pool(cfg, params, LM_MASKS, prompts)
    caches_q, _ = pool(cfg8, params, LM_MASKS, prompts)
    x = caches_bf[0]["b0"]["k"][0]                    # one layer's k, bf16
    for got, want in zip(layers.quantize_kv(x), layers.quantize_kv(x.cpu())):
        if not torch.equal(got.cpu(), want):
            raise AssertionError("quantize_kv on the card differs from the "
                                 "CPU's")
    worst = 0.0
    for seg_bf, seg_q in zip(caches_bf, caches_q):
        for b, c_bf in seg_bf.items():
            for name in ("k", "v"):
                val = c_bf[name].float()
                sc = seg_q[b][name + "scale"][..., None]
                err = (seg_q[b][name].float() * sc - val).abs()
                # half a step, plus the fp32 rounding of x / s and q * s
                slack = 0.5 * sc + 1e-6 * val.abs()
                if not bool((err <= slack).all()):
                    raise AssertionError(f"int8 {name} cache beyond half a "
                                         f"step: {float(err.max())}")
                worst = max(worst, float((err / sc.clamp_min(1e-30))
                                         .max()))
    _phase("lm_int8_kv", quantize_kv_bit_equal_to_cpu=True,
           max_err_in_steps=f"{worst:.4f}", cache_mbytes=sum(
               nbytes(*c.values()) for seg in caches_q
               for c in seg.values()) / 1e6)
    del caches_bf, caches_q
    try:
        plan_lib.lower_fused_decode(cfg8)
    except plan_lib.FusedPlanUnsupported:
        pass
    else:
        raise AssertionError("int8 KV lowered to the fused decode step")
    legs[("int8kv", None)] = leg(cfg8, params, None, fused_steps=0)
    same8 = float((legs[("int8kv", None)][0][0]
                   == legs[("bf16", False)][0][0]).float().mean())
    _phase("lm_agreement", kv_dtype="int8", tokens_equal_share_vs_bf16_kv=same8,
           note="int8 KV vs bf16 KV (both per-op) is reported, not gated")
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

    # ---- phase 2: the int8 quantizer, then every kernel against its plain
    # version ----------------------------------------------------------------
    int8 = plan_lib.Precision("int8")
    _, on_card = plan_lib.lower_fused(plan.with_precision(int8))
    _, on_cpu = plan_lib.lower_fused(plan.to("cpu").with_precision(int8))
    for got, want in zip(on_card, on_cpu):
        if got.dtype != want.dtype or not torch.equal(got.cpu(), want):
            raise AssertionError(f"int8 lowering on the card differs from "
                                 f"the CPU's ({got.dtype}, {want.dtype})")
    _phase("quantizer", plan="dense", tensors=len(on_card),
           int8_values=sum(t.numel() for t in on_card
                           if t.dtype == torch.int8),
           bit_equal_to_cpu=True)
    kernels = {}

    def pair_case(p, x, quant):
        body = p.params["body"]
        d2 = body["w2p"].shape[-1]
        if not quant:
            return (x, body["w1p"], body["b1p"], body["w2p"],
                    torch.zeros(d2, device=dev))
        q1, s1 = plan_lib._quantize_weight(body["w1p"])
        q2, s2 = plan_lib._quantize_weight(body["w2p"])
        return (x, q1, plan_lib._low_bias(body["b1p"]), q2,
                torch.zeros(d2, dtype=torch.bfloat16, device=dev), s1, s2)

    for quant, shape_name, p, x in (
            (q, name, p, x) for q in (False, True)
            for name, p, x in (("main", plan, voxels[:CHUNK]),
                               ("ragged", small_plan, x_ragged))):
        sfx = "_int8" if quant else ""
        args = pair_case(p, x, quant)
        n, d, k = args[1].shape
        d2 = args[3].shape[-1]
        err = max_err([mffn_ops.masked_ffn(*args)],
                      [mffn_ref.masked_ffn_ref(*args)],
                      TOL_INT8 if quant else TOL_SAMPLES)
        flops = 2 * n * x.shape[0] * (d * k + k * d2)
        w_bytes = nbytes(*args[1:])
        moved = nbytes(x) + w_bytes + 4 * n * x.shape[0] * d2
        rec = {"name": "masked_ffn" + sfx, "route": "cuda",
               "source": "src/repro_torch/kernels/csrc/masked_ffn.cu",
               "replaces": "src/repro/kernels/masked_ffn/kernel.py:60"
                           " (_ffn_kernel_q, pallas_call :140)" if quant
                           else "src/repro/kernels/masked_ffn/kernel.py:79",
               "shape": shape_name, "max_abs_err": err,
               "ms": time_ms(lambda: mffn_ops.masked_ffn(*args)),
               "plain_ms": time_ms(lambda: mffn_ref.masked_ffn_ref(*args)),
               "weight_bytes": w_bytes}
        rec["bound_ms"], rec["bound_by"] = bound(flops, moved)
        kernels.setdefault(rec["name"], []).append(rec)

        pp = p.with_precision(int8) if quant else p
        spec, params = plan_lib.lower_fused(pp)
        fp = fp_ops.pack(spec, params)
        b = x.shape[0]
        flops = p.traffic(b, 4, fused=True, moments=True).flops
        at = ("src/repro/kernels/fused_plan/kernel.py:52 (_dense ws "
              "dequant; " if quant else
              "src/repro/kernels/fused_plan/kernel.py:106 (")
        cases = (
            ("fused_plan_samples", at + "pallas_call :165, moments=False)",
             lambda: (fp_ops.fused_samples(fp, x),),
             lambda: (fp_ref.fused_plan_ref(spec, x, params),),
             TOL_INT8 if quant else TOL_SAMPLES,
             4 * spec.n_rows * b * spec.d_out),
            ("fused_plan_moments", at + "pallas_call :222, moments=True)",
             lambda: fp_ops.fused_moments(fp, x),
             lambda: fp_ref.fused_moments_ref(spec, x, params),
             TOL_INT8 if quant else TOL_MOMENTS,
             2 * 4 * b * spec.groups * spec.d_out))
        for name, replaces, run, plain, tol, out_bytes in cases:
            rec = {"name": name + sfx, "route": "cuda",
                   "source": "src/repro_torch/kernels/csrc/fused_plan.cu",
                   "replaces": replaces, "shape": shape_name,
                   "max_abs_err": max_err(run(), plain(), tol),
                   "ms": time_ms(run), "plain_ms": time_ms(plain),
                   "weight_bytes": fp.nbytes}
            rec["bound_ms"], rec["bound_by"] = bound(
                flops, nbytes(x) + fp.nbytes + out_bytes)
            kernels.setdefault(rec["name"], []).append(rec)
    for recs in kernels.values():
        for rec in recs:
            _phase("kernel", **{k: rec[k] for k in (
                "name", "shape", "max_abs_err", "ms", "plain_ms",
                "bound_ms", "bound_by", "weight_bytes")})

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
            c.launches = c.int8_launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        return out, secs, tuple(c.launches for c in counters)

    def int8_counts():
        return tuple(c.int8_launches for c in counters)

    def plain_volume(plan=plan):
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
    samples_launches = counts[1]
    err = max_err([samples], [ivim_model.apply_all_samples(model, chunk0)],
                  TOL_MOMENTS)
    _phase("main_path", leg="packed_apply_fused", voxels=CHUNK,
           max_abs_err=err, launches=counts)

    # ---- phase 3 at int8: the same slab at Precision("int8") --------------
    qplan = plan.with_precision(int8)
    q_legs = {
        "fused": (lambda: engine.predict_volume(
            qplan, volume, chunk=CHUNK, fused=True, device=dev),
            (0, 0, n_chunks)),
        "per_op": (lambda: engine.predict_volume(
            qplan, volume, chunk=CHUNK, fused=False, device=dev),
            (n_chunks, 0, 0)),
        "plain": (lambda: plain_volume(qplan), (0, 0, 0)),
    }
    q_out, q_launches = {}, {}
    for leg, (fn, expect) in q_legs.items():
        (mean, std), secs, counts = run_leg(fn)
        if counts != expect or int8_counts() != expect:
            raise AssertionError(
                f"int8 {leg} leg launches (masked_ffn, samples, moments) = "
                f"{counts}, of them int8 {int8_counts()}; expected {expect}")
        if not (torch.isfinite(mean).all() and torch.isfinite(std).all()):
            raise AssertionError(f"int8 {leg} leg: non-finite moments")
        err = max_err((mean, std), want, TOL_INT8_VS_FP32)
        _phase("main_path_int8", leg=leg, voxels=n_vox, chunks=n_chunks,
               seconds=f"{secs:.4f}", voxels_per_s=f"{n_vox / secs:.0f}",
               max_abs_err_vs_fp32=err, launches=counts,
               int8_launches=int8_counts())
        q_out[leg], q_launches[leg] = (mean, std), counts
    fused_vs_per_op = max_err(q_out["fused"], q_out["per_op"], TOL_INT8)
    fused_vs_plain = max_err(q_out["fused"], q_out["plain"], TOL_INT8)
    fp32_bytes = fp_ops.pack(*plan_lib.lower_fused(plan)).flat.numel() * 4
    int8_bytes = fp_ops.pack(*plan_lib.lower_fused(qplan)).nbytes
    if int8_bytes > INT8_BYTES_GATE * fp32_bytes:
        raise AssertionError(f"int8 parameters {int8_bytes} bytes > "
                             f"{INT8_BYTES_GATE} x fp32 {fp32_bytes}")
    _phase("int8_agreement", fused_vs_per_op=fused_vs_per_op,
           fused_vs_plain=fused_vs_plain, param_bytes_int8=int8_bytes,
           param_bytes_fp32=fp32_bytes,
           ratio=f"{int8_bytes / fp32_bytes:.4f}")
    q_samples, _, counts = run_leg(lambda: ivim_model.packed_apply(
        qplan, chunk0, fused=True, device=dev))
    if counts != (0, 1, 0) or int8_counts() != (0, 1, 0):
        raise AssertionError(f"int8 packed_apply(fused=True) launches "
                             f"{counts}, int8 {int8_counts()}")
    err = max_err([q_samples], [ivim_model.apply_all_samples(model, chunk0)],
                  TOL_INT8_VS_FP32)
    _phase("main_path_int8", leg="packed_apply_fused", voxels=CHUNK,
           max_abs_err_vs_fp32=err, launches=counts)
    q_launches["packed_apply"] = counts

    # ---- phases 4 and 5: the LM kernel and the LM main path ---------------
    from repro_torch.kernels.fused_decode import ops as fd_ops
    decode_rec = lm_phases(dev, time_ms, bound, nbytes,
                           counters + (fd_ops.fused_decode,))

    # ---- phase 6: the kernels line, then the device line ------------------
    main_launches = {"masked_ffn": launches["per_op"][0],
                     "fused_plan_samples": samples_launches,
                     "fused_plan_moments": launches["fused"][2],
                     "masked_ffn_int8": q_launches["per_op"][0],
                     "fused_plan_samples_int8": q_launches["packed_apply"][1],
                     "fused_plan_moments_int8": q_launches["fused"][2]}
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
            "weight_bytes": main["weight_bytes"],
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
