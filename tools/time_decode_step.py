"""Time the fused serving decode step of ``qwen2-1.5b``, masked and packed.

    python3 tools/time_decode_step.py [--src DIR] [--reps N]

At ``chip_smoke.py``'s LM shape (``qwen2-1.5b`` at full width and depth in
bf16, random weights from seed 0, 4 masks, 8 requests x 128-token prompts,
32 new tokens) it runs ``serving.engine.serve_uncertain`` with the fused
step twice: with the masked FFN (the default) and with packed FFN serving
(``packed_ffn_serving=True``, the FFN weights packed per mask: the
paper's mask-zero skipping). For each it prints ``N`` (default 2)
``[step]`` lines, each one timed run: ms a decode step (host clock around
the call, the prefill timed apart and taken out, as ``chip_smoke.py``'s
``[lm_main_path]``), decode tokens/s, and the fused kernel alone (CUDA
events around 10 launches on the first step's operands). One
``fused_decode`` launch a step is asserted.

``--src`` picks the package it imports (default: this checkout's
``src``), so one call can time two trees, for example a parent unpacked
by ``git archive`` beside the change; each tree's kernels are built from
its own sources. It needs one card and ``nvcc``; it imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARCH, MASKS, BATCH, PROMPT, NEW = "qwen2-1.5b", 4, 8, 128, 32


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("time_decode_step: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src",
                    help="directory holding the repro_torch package")
    ap.add_argument("--reps", type=int, default=2,
                    help="timed serve_uncertain runs a form")
    ns = ap.parse_args()
    sys.path.insert(0, str(ns.src.resolve()))
    torch.backends.cuda.matmul.allow_tf32 = False

    from repro_torch.configs import registry
    from repro_torch.core import plan as plan_lib
    from repro_torch.kernels.fused_decode import ops as fd_ops
    from repro_torch.models import layers, model as lm_model, transformer
    from repro_torch.serving import engine, server

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0],
          flush=True)
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = registry.get_config(ARCH, mask_samples=MASKS)
    params = lm_model.build_model(cfg).init(
        torch.Generator(dev).manual_seed(0), device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), device=dev,
                            dtype=torch.int32,
                            generator=torch.Generator(dev).manual_seed(1))
    pcfg = dataclasses.replace(cfg, packed_ffn_serving=True)
    forms = (("masked", cfg, params),
             ("packed", pcfg, transformer.pack_ffn_params(cfg, params)))
    for form, c, p in forms:
        mk = lm_model.build_model(c)
        fns = server.step_fns(mk, fused=None, device=dev)
        # the kernel alone, on the first decode step's operands
        mean, _, caches = fns.prefill(p, prompts.repeat(MASKS, 1),
                                      max_seq=PROMPT + NEW)
        tok = mean.argmax(-1).to(torch.int32).repeat(MASKS)
        spec = plan_lib.lower_fused_decode(c)
        pos = torch.full((tok.shape[0],), PROMPT, dtype=torch.int32,
                         device=dev)
        rot = next(s.rot_dim for s in spec.steps if s.kind == "attn")
        args = (layers.embed_tokens(p["embed"], tok),
                plan_lib._decode_flat_params(spec, c, p, tok.shape[0], True),
                plan_lib._decode_flat_caches(c, caches), pos,
                *layers.rope_cos_sin(pos, rot, c.rope_theta))
        for _ in range(3):
            fd_ops.fused_decode(spec, *args)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            fd_ops.fused_decode(spec, *args)
        stop.record()
        stop.synchronize()
        kernel_ms = start.elapsed_time(stop) / 10
        del args, caches
        cfg_run = engine.ServeConfig(max_new_tokens=NEW, fused=None)
        engine.serve_uncertain(mk, p, prompts, engine.ServeConfig(
            max_new_tokens=2, fused=None), device=dev)          # warm-up
        for _ in range(ns.reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fns.prefill(p, prompts.repeat(MASKS, 1), max_seq=PROMPT + NEW)
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t
            fd_ops.fused_decode.launches = 0
            t = time.perf_counter()
            engine.serve_uncertain(mk, p, prompts, cfg_run, device=dev)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
            if fd_ops.fused_decode.launches != NEW:
                raise AssertionError(f"{form}: {fd_ops.fused_decode.launches} "
                                     f"fused_decode launches, expected {NEW}")
            step_ms = 1e3 * (secs - prefill_s) / NEW
            print(f"[step] src={ns.src} form={form} "
                  f"decode_ms_per_step={step_ms:.3f} "
                  f"decode_tokens_per_s={1e3 * BATCH / step_ms:.1f} "
                  f"kernel_ms={kernel_ms:.4f} prefill_s={prefill_s:.4f}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
