"""Probe the fused decode kernel on the card: what its three-way bf16 split
buys over one or two parts, what a grid barrier costs, and its tuning
knobs.

    python3 tools/probe_fused_decode.py --out DIR [--variants a,b,...]
                                        [--shape main|packed]

``DIR`` (outside the checkout) receives variant copies of
``src/repro_torch/kernels/csrc`` and their ``libfused_decode.so``, all
built together (one ``nvcc`` a variant). At ``chip_smoke.py``'s main LM
shape (``qwen2-1.5b`` at full width and depth in bf16, random weights from
seed 0, 4 masks, 8 requests x 128-token prompts: a 32-row pool and a
160-slot cache) it prints one ``[probe]`` line a variant, with the
kernel's ms (CUDA events around back-to-back launches, 10 after 3
warm-ups), its per-stage ms (block 0's barrier stamps) and the error of
``mean_logp`` against the plain version (max abs, and over the plain
version's largest magnitude; ``--shape packed`` takes the same pool with
packed FFN serving, ``chip_smoke.py``'s "packed" case):

- ``committed``: as committed;
- ``split1`` / ``split2``: one or two bf16 parts of each activation in
  the products (plain bf16 activations; bf16 hi + mid), setting the bars
  ``chip_smoke.py``'s ``TOL_DECODE_REL`` and ``TOL_DECODE_SPLIT`` hold the
  committed build to;
- ``barriers``: 64 empty stages first, read through the stamps (ms a grid
  barrier), and through the kernel's time against ``committed``;
- ``slots3`` / ``slots4``: the ring of weight chunks 3 or 4 deep instead
  of 2 (4 leaves room for one block an SM), and ``blocks1``: one block an
  SM;
- ``noproducts`` / ``nocopies``: the GEMV loop without its tensor-core
  products, or without moving its weight bytes (results wrong): where a
  GEMV stage's time goes;
- ``tmawarps``: the weights' TMA issued by warp 2 instead of warp 0;
- ``elements`` / ``group4`` / ``group16``: a weight without a tensor map
  (at ``--shape packed`` the gate/up rows: 4,779 kept units, off 16
  bytes) copied element by element, each load waited for, or with 4 or 16
  of a thread's loads in flight before their stores instead of 8;
- ``clocks`` / ``clocks1``: built with ``-DFUSED_DECODE_CLOCKS``: block
  0's SM cycles a launch in each phase of the GEMV loop and of an
  attention task (``clocks1``: one block an SM).

Errors are also read with each row of ``mean_logp`` centred (its mean
over the vocabulary removed on both sides): a per-row log-sum-exp offset,
the same for every token, then drops out and the logits' own error shows.
For ``committed``, ``split1`` and ``split2`` the error is also read at
``chip_smoke.py``'s "split" case (bf16 ``qwen2-1.5b`` at the smoke
widths, tied embeddings times ``SPLIT_EMBED_SCALE``, 4 masks x 3 requests
at position 6), with weights from seeds 0-7 (seed 4 is chip_smoke's):
``split_rel_err``, where ``TOL_DECODE_SPLIT`` is set.

It needs one card, ``nvcc`` and the port; it imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = "fused_decode.cu"
EMPTY_STAGES = 64
# extra nvcc flags per variant
FLAGS = {"clocks": ("-DFUSED_DECODE_CLOCKS",), "clocks1": ("-DFUSED_DECODE_CLOCKS",)}
# the phases fused_decode.cu's clock marks close (CLK(0) .. CLK(12))
PHASES = ("gemv_cursor", "gemv_wait_weights", "gemv_products", "gemv_sync",
          "gemv_flush", "gemv_issue", "gemv_convert",
          "attn_stage_rows", "attn_rope", "attn_scores", "attn_softmax",
          "attn_pv", "attn_combine")
# variants whose error is also read at chip_smoke.py's "split" case
SPLIT_VARIANTS = ("committed", "split1", "split2")
SPLIT_SEEDS = range(8)
SPLIT_EMBED_SCALE = 16.0            # chip_smoke.py's
# a weight without a tensor map: the committed copy (COPY_GROUP loads in
# flight, then their stores), and the "elements" variant's loop (each
# element loaded and stored in turn)
GROUP_COPY = """  for (int p0 = 0; p0 < KC * TN / THREADS; p0 += COPY_GROUP) {
    TW v[COPY_GROUP];
#pragma unroll
    for (int p = 0; p < COPY_GROUP; ++p) {
      const int e = threadIdx.x + (p0 + p) * THREADS, i = e / TN, n = e % TN;
      v[p] = i < ch.kv && ch.col + n < j.N ? __ldcg(w + (long long)(ch.k0 + i) * j.N + ch.col + n)
                                           : zero_of<TW>();
    }
#pragma unroll
    for (int p = 0; p < COPY_GROUP; ++p) {
      const int e = threadIdx.x + (p0 + p) * THREADS;
      *(TW*)(W + w_off<TW>(e / TN, e % TN)) = v[p];
    }
  }
"""
ELEMENT_COPY = """  for (int e = threadIdx.x; e < KC * TN; e += THREADS) {
    const int i = e / TN, n = e % TN;
    *(TW*)(W + w_off<TW>(i, n)) = (i < ch.kv && ch.col + n < j.N)
                                      ? w[(long long)(ch.k0 + i) * j.N + ch.col + n]
                                      : zero_of<TW>();
  }
"""
# edits of fused_decode.cu per variant: (old, new), each old found once
VARIANTS = {
    "committed": (),
    "split1": (("for (int p = 2; p >= 0; --p)", "for (int p = 0; p >= 0; --p)"),),
    "split2": (("for (int p = 2; p >= 0; --p)", "for (int p = 1; p >= 0; --p)"),),
    "barriers": (("  mark();\n  const long long qkv_n",
                  f"  mark();\n  for (int i = 0; i < {EMPTY_STAGES}; ++i) "
                  f"sync();\n  const long long qkv_n"),),
    "slots3": (("kPlanes = 3, kXLD = KC + 8, kSlots = 2;",
                "kPlanes = 3, kXLD = KC + 8, kSlots = 3;"),),
    "slots4": (("kPlanes = 3, kXLD = KC + 8, kSlots = 2;",
                "kPlanes = 3, kXLD = KC + 8, kSlots = 4;"),
               ("constexpr int MIN_BLOCKS = 2;", "constexpr int MIN_BLOCKS = 1;")),
    "blocks1": (("constexpr int MIN_BLOCKS = 2;", "constexpr int MIN_BLOCKS = 1;"),),
    # where a GEMV stage's time goes (wrong results): no products; no
    # weight bytes moved (each slot's phase completes on its arrival)
    "noproducts": (("    products<TW>(acc, slot_of(c), planes_of(c), nt, frag);\n", ""),),
    # the weights' TMA issue from warp 2 (the row boxes' is warp 1's)
    "tmawarps": (("    if (threadIdx.x == 0) {\n      mbar_arrive_tx(bar, w_bytes<TW>());",
                  "    if (threadIdx.x == 64) {\n      mbar_arrive_tx(bar, w_bytes<TW>());"),),
    "clocks": (),
    "clocks1": (("constexpr int MIN_BLOCKS = 2;", "constexpr int MIN_BLOCKS = 1;"),),
    "nocopies": (("      mbar_arrive_tx(bar, w_bytes<TW>());\n      for (int b = 0; b < boxes; ++b)",
                  "      mbar_arrive_tx(bar, 0);\n      for (int b = 0; b < 0; ++b)"),),
    # weights without a tensor map (--shape packed: the gate/up rows, 4,779
    # wide, are off 16 bytes): copied element by element, each load waited
    # for, or with 4 or 16 loads in flight instead of 8
    "elements": ((GROUP_COPY, ELEMENT_COPY),),
    "group4": (("constexpr int COPY_GROUP = 8;", "constexpr int COPY_GROUP = 4;"),),
    "group16": (("constexpr int COPY_GROUP = 8;", "constexpr int COPY_GROUP = 16;"),),
}


def _phase(**fields) -> None:
    print("[probe] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def build_variants(out: Path, names) -> dict[str, Path]:
    """Each named variant's source tree under ``out``, built; {name:
    library}."""
    from repro_torch.kernels import _build
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    source = (csrc / SOURCE).read_text()
    texts = {}
    for name in names:              # every edit checked before any build
        text = source
        for old, new in VARIANTS[name]:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {SOURCE} has {old!r} "
                                   f"{text.count(old)} times")
            text = text.replace(old, new)
        texts[name] = text
    jobs, libs = [], {}
    for name in names:
        d = out / name
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(csrc, d)
        (d / SOURCE).write_text(texts[name])
        lib = d / "libfused_decode.so"
        jobs.append((name, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *FLAGS.get(name, ()), "-o",
             str(lib),
             str(d / SOURCE)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
        libs[name] = lib
    for name, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode:         # a variant that does not build is left out
            _phase(variant=name, build="failed", log=log.strip()[-600:])
            libs.pop(name)
            continue
        lines = log.splitlines()
        for prev, line in zip([""] + lines, lines):
            if "Used" in line or "spill" in line:   # with the function named
                _phase(variant=name, ptxas=(prev.strip() if "spill" in line
                                            else "") + " " + line.strip())
    return libs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, required=True,
                    help="directory for the variant sources and libraries")
    ap.add_argument("--shape", choices=("main", "packed"), default="main",
                    help="the main LM shape, or the same with packed FFN")
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated variants (default: all; "
                         "'committed' first)")
    args_ns = ap.parse_args()
    out = args_ns.out.resolve()
    names = args_ns.variants.split(",")
    if names[0] != "committed" or any(n not in VARIANTS for n in names):
        ap.error(f"variants: 'committed' first, then any of {list(VARIANTS)}")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False

    from repro_torch.configs import registry
    from repro_torch.core import plan as plan_lib
    from repro_torch.kernels import _build
    from repro_torch.kernels.fused_decode import ops as fd_ops
    from repro_torch.models import layers, model as lm_model, transformer
    from repro_torch.serving import server

    dev = torch.device("cuda", torch.cuda.current_device())
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0],
          flush=True)
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    libs = build_variants(out, names)
    _phase(build_s=f"{time.perf_counter() - t0:.1f}", variants=len(libs))

    cfg = registry.get_config("qwen2-1.5b", mask_samples=4)
    params = lm_model.build_model(cfg).init(
        torch.Generator(dev).manual_seed(0), device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (8, 128), device=dev,
                            dtype=torch.int32,
                            generator=torch.Generator(dev).manual_seed(1))
    mean, _, caches = server.step_fns(cfg, fused=False, device=dev).prefill(
        params, prompts.repeat(4, 1), max_seq=160)
    tok = mean.argmax(-1).to(torch.int32).repeat(4)[:, None]
    rows = tok.shape[0]
    if args_ns.shape == "packed":
        params = transformer.pack_ffn_params(cfg, params)
        cfg = dataclasses.replace(cfg, packed_ffn_serving=True)
    spec = plan_lib.lower_fused_decode(cfg)
    flat = plan_lib._decode_flat_params(spec, cfg, params, rows, True)
    fc = plan_lib._decode_flat_caches(cfg, caches)
    pos = torch.full((rows,), 128, dtype=torch.int32, device=dev)
    rot = next(s.rot_dim for s in spec.steps if s.kind == "attn")
    x = layers.embed_tokens(params["embed"], tok[:, 0])
    cos, sin = layers.rope_cos_sin(pos, rot, cfg.rope_theta)
    args = (x, flat, fc, pos, cos, sin)
    want = fd_ops.fused_decode_ref(spec, *args)[0]
    want_c = want - want.mean(-1, keepdim=True)

    def split_case(seed):
        """chip_smoke.py's "split" case with weights from ``seed``: its
        spec, operands and the plain version's mean_logp."""
        c = registry.smoke_config("qwen2-1.5b", dtype=torch.bfloat16)
        p = transformer.init(c, torch.Generator(dev).manual_seed(seed),
                             device=dev)
        p["embed"]["embed"] *= SPLIT_EMBED_SCALE
        toks = torch.randint(0, c.vocab_size, (3, 6), device=dev,
                             dtype=torch.int32,
                             generator=torch.Generator(dev).manual_seed(seed + 1))
        n = c.mask_samples
        m, _, cc = server.step_fns(c, fused=False, device=dev).prefill(
            p, toks.repeat(n, 1), max_seq=9)
        t = m.argmax(-1).to(torch.int32).repeat(n)
        sp = plan_lib.lower_fused_decode(c)
        ps = torch.full((t.shape[0],), 6, dtype=torch.int32, device=dev)
        r = next(st.rot_dim for st in sp.steps if st.kind == "attn")
        cs, sn = layers.rope_cos_sin(ps, r, c.rope_theta)
        a = (layers.embed_tokens(p["embed"], t),
             plan_lib._decode_flat_params(sp, c, p, t.shape[0], True),
             plan_lib._decode_flat_caches(c, cc), ps, cs, sn)
        return sp, a, fd_ops.fused_decode_ref(sp, *a)[0]

    splits = [split_case(seed) for seed in SPLIT_SEEDS]

    def time_ms(fn, reps: int = 10) -> float:
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

    base = fd_ops.stage_names(spec)
    stage_names = fd_ops.stage_names
    times = {}
    for name, lib in libs.items():
        fn = getattr(ctypes.CDLL(str(lib)), "fused_decode_launch")
        fn.argtypes, fn.restype = fd_ops._ARGTYPES, ctypes.c_int
        _build._BOUND[("fused_decode", "fused_decode_launch")] = fn
        # the variant's stages, so the workspace holds a stamp for each
        names = {"barriers": ("barrier",) * EMPTY_STAGES + base}.get(name, base)
        fd_ops.stage_names = lambda _spec, names=names: names
        fd_ops._workspace.cache_clear()
        got = fd_ops.fused_decode(spec, *args)[0]
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        rel = err / float(want.abs().max())
        got_c = got - got.mean(-1, keepdim=True)
        rel_c = float((got_c - want_c).abs().max() / want_c.abs().max())
        times[name] = time_ms(lambda: fd_ops.fused_decode(spec, *args))
        stamps = fd_ops._workspace(spec, rows, dev)[2].cpu().tolist()
        per = {}
        for n, a, b in zip(names, stamps, stamps[1:]):
            per[n] = per.get(n, 0.0) + (b - a) / 1e6
        rec = {"variant": name, "ms": f"{times[name]:.4f}",
               "max_abs_err": f"{err:.3g}", "rel_err": f"{rel:.3g}",
               "rel_err_centred": f"{rel_c:.3g}",
               "blocks": fd_ops.last_grid["blocks"]}
        if name == "barriers":
            gaps = [b - a for a, b in zip(stamps, stamps[1:EMPTY_STAGES + 1])]
            rec["barrier_us_stamps"] = f"{sum(gaps) / len(gaps) / 1e3:.3f}"
            rec["barrier_us_min_max"] = (f"{min(gaps) / 1e3:.3f}/"
                                         f"{max(gaps) / 1e3:.3f}")
            rec["barrier_us_events"] = (
                f"{1e3 * (times[name] - times['committed']) / EMPTY_STAGES:.3f}")
        rec["stage_ms"] = {k: round(v, 4) for k, v in per.items()}
        if name in SPLIT_VARIANTS:
            errs = []
            for sp, a, w in splits:
                g = fd_ops.fused_decode(sp, *a)[0]
                errs.append(float((g - w).abs().max() / w.abs().max()))
            rec["split_rel_err"] = [f"{e:.3g}" for e in errs]
            rec["split_rel_err_min_max"] = f"{min(errs):.3g}/{max(errs):.3g}"
        if name in FLAGS:           # 1 + 3 + 10 launches so far
            out16 = (ctypes.c_ulonglong * 16)()
            clk = getattr(ctypes.CDLL(str(lib)), "fused_decode_clocks")
            clk.argtypes, clk.restype = [ctypes.c_void_p], ctypes.c_int
            if clk(ctypes.addressof(out16)):
                raise RuntimeError("fused_decode_clocks failed")
            rec["kcycles_a_launch"] = {
                ph: round(out16[i] / 14 / 1e3, 1) for i, ph in enumerate(PHASES)}
        _phase(**rec)
    fd_ops.stage_names = stage_names
    fd_ops._workspace.cache_clear()
    _build._BOUND.pop(("fused_decode", "fused_decode_launch"), None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
