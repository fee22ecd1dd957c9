"""Probe the fp32 flash kernels (3xTF32) on the card: where their time goes,
what the 3xTF32 products buy over plain TF32, and the designs around the
committed one.

    python3 tools/probe_flash_f32.py --out DIR [--variants a,b,...] [--peak]

``DIR`` (outside the checkout, or a directory it ignores) receives variant
copies of ``src/repro_torch/kernels/csrc`` with ``flash_attention.cu``
edited as ``VARIANTS`` says, each built into its own library (one
``nvcc`` a variant, all started together). At ``chip_smoke.py``'s fp32
flash cases (``qwen_fp32``, ``rg_fp32``, ``wide_320_fp32``) and a full
attention over 2,048 keys (``long_fp32``: the longest sums), inputs from
``torch.randn`` with seed 4 as in ``tools/time_flash.py``, it prints one
``[probe]`` line a (variant, case): CUDA-event ms a launch (20 after 3
warm-ups), the max abs error against the plain version and whether it is
inside ``TOL_FLASH_F32`` (rtol = atol = 1e-5), and each variant's
``ptxas`` registers and spill bytes a kernel. The diagnostic variants take
work away and are wrong on purpose:

- ``plain_tf32``: only the hi.hi product of each 3xTF32 triple (plain TF32
  of rounded operands): the bar must refuse it;
- ``free_split``: the hi/lo split of every operand replaced by a move: the
  cost of the splits;
- ``one_mma``: both: loads, softmax and one product, the floor of this
  loop structure.

The others are right and measure a design choice: two blocks an SM below
dh 256 (``narrow_2blk``), the QK^T loop unrolled or rolled further
(``s_unrolled``, ``h_rolled``), 16-key tiles at dh 128 (``bk16_128``), and
the wide kernel's slice at 256 or 384 columns against the committed 320
(``wide_dv256``, ``wide_dv384``). ``--peak`` also times back-to-back ``mma.sync`` (tf32
m16n8k8, bf16 m16n8k16) at 4 and 16 warps an SM: the rate this design can
reach. It needs one card, ``nvcc`` and the port; it imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (its tables and bar only; it imports no torch)

CASES = ("qwen_fp32", "rg_fp32", "wide_320_fp32", "long_fp32")
# beside chip_smoke.py's: full attention over 2,048 keys (the longest sums)
EXTRA_CASES = (("long_fp32", 2, 8, 2, 256, 2048, 128, "float32", False),)
_LO_QK = ("        dense_tile::mma_tf32(blk[j], al[u], bh[u]);\n"
          "        dense_tile::mma_tf32(blk[j], ah[u], bl[u]);\n")
_LO_PV = ("      dense_tile::mma_tf32(blk[u], pl, bh);\n"
          "      dense_tile::mma_tf32(blk[u], ph, bl);\n")
_SPLIT = ("  hi = tf32_rna(x);\n  lo = tf32_rna(x - __uint_as_float(hi));\n",
          "  hi = __float_as_uint(x);\n  lo = hi;\n")
VARIANTS = {
    "committed": (),
    "plain_tf32": ((_LO_QK, ""), (_LO_PV, "")),
    "free_split": (_SPLIT,),
    "one_mma": ((_LO_QK, ""), (_LO_PV, ""), _SPLIT),
    # the narrow kernel at two blocks an SM below dh 256 (128 registers a
    # thread at most)
    "narrow_2blk": (("__launch_bounds__(kF32Threads, 1)\nflash_f32_kernel(",
                     "__launch_bounds__(kF32Threads, DH >= 256 ? 1 : 2)\nflash_f32_kernel("),),
    # its QK^T blocks unrolled; a block's two float4 column halves rolled
    "s_unrolled": (("#pragma unroll 1\n    for (int d0 = 0; d0 < DH; d0 += 32)",
                    "#pragma unroll\n    for (int d0 = 0; d0 < DH; d0 += 32)"),),
    "h_rolled": (("#pragma unroll\n  for (int h = 0; h < 2; ++h) {",
                  "#pragma unroll 1\n  for (int h = 0; h < 2; ++h) {"),),
    # 16-key tiles at dh 128 (one n-tile a half)
    "bk16_128": (("BK = DH >= 128 ? 32 : 64;", "BK = DH >= 256 ? 32 : DH >= 128 ? 16 : 64;"),),
    "narrow_2blk_h_rolled": (("__launch_bounds__(kF32Threads, 1)\nflash_f32_kernel(",
                              "__launch_bounds__(kF32Threads, DH >= 256 ? 1 : 2)\nflash_f32_kernel("),
                             ("#pragma unroll\n  for (int h = 0; h < 2; ++h) {",
                              "#pragma unroll 1\n  for (int h = 0; h < 2; ++h) {")),
    "narrow_2blk_bk16": (("__launch_bounds__(kF32Threads, 1)\nflash_f32_kernel(",
                          "__launch_bounds__(kF32Threads, DH >= 256 ? 1 : 2)\nflash_f32_kernel("),
                         ("BK = DH >= 128 ? 32 : 64;", "BK = DH >= 256 ? 32 : DH >= 128 ? 16 : 64;")),
    # the wide kernel's output slice at 256 and 384 columns (128 and 192 a
    # warp) against the committed 320
    "wide_dv256": (("constexpr int kWideDVH = 160;", "constexpr int kWideDVH = 128;"),),
    "wide_dv384": (("constexpr int kWideDVH = 160;", "constexpr int kWideDVH = 192;"),),
}


def _phase(**fields) -> None:
    print("[probe] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def build_variants(out: Path, names) -> dict[str, tuple[Path, str]]:
    """{variant: (library, ptxas output)}, every ``nvcc`` started first."""
    from repro_torch.kernels import _build
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    jobs = {}
    for name in names:
        vdir = out / name
        if vdir.exists():
            shutil.rmtree(vdir)
        shutil.copytree(csrc, vdir)
        path = vdir / "flash_attention.cu"
        text = path.read_text()
        for old, new in VARIANTS[name]:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} not in the source")
            text = text.replace(old, new)
        path.write_text(text)
        lib = vdir / "libflash_attention.so"
        jobs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name}:\n{log}")
        built[name] = (lib, log)
    return built


def _ptxas(log: str) -> list[str]:
    """'<kernel>: <registers>, <spill bytes>' for each fp32 kernel."""
    rows, kernel = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            kernel = next((k for k in ("flash_f32_wide_kernel",
                                       "flash_f32_kernel") if k in line),
                          None)
            if kernel and "ILi" in line:
                kernel += "<" + line.split("ILi")[1].split("E")[0] + ">"
        elif kernel and "spill stores" in line:
            spill = line.split(",")[1].strip().split()[0]
        elif kernel and "Used" in line:
            rows.append(f"{kernel}:{line.split('Used')[1].split()[0]}"
                        f"regs/{spill}B")
            kernel = None
    return rows


# mma.sync rate on this card: 8 independent accumulator chains a warp,
# `warps` warps an SM (4 a block), operands fixed, results summed out
PEAK_SRC = r"""
#include <cuda_runtime.h>
#define TF32 "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
#define BF16 "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
template <bool kTf32>
__global__ void __launch_bounds__(128) peak(float* out, int iters) {
  unsigned a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1.f + 1e-3f * (threadIdx.x + i)) & 0xffffe000u;
  for (int i = 0; i < 2; ++i) b[i] = __float_as_uint(1e-3f * (i + 1)) & 0xffffe000u;
  float d[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if (kTf32)
        asm volatile(TF32 "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      else
        asm volatile(BF16 "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
    }
  }
  float s = 0.f;
  for (int c = 0; c < 8; ++c)
    for (int e = 0; e < 4; ++e) s += d[c][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int peak_launch(int tf32, float* out, int blocks, int iters, void* stream) {
  if (tf32)
    peak<true><<<blocks, 128, 0, (cudaStream_t)stream>>>(out, iters);
  else
    peak<false><<<blocks, 128, 0, (cudaStream_t)stream>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def peak_phase(out: Path) -> None:
    """``[probe] peak``: TFLOP/s of back-to-back mma.sync (m16n8k8 tf32 and
    m16n8k16 bf16) at 4 and 16 warps an SM."""
    import torch
    from repro_torch.kernels import _build
    src = out / "mma_peak.cu"
    src.write_text(PEAK_SRC)
    lib = out / "libmma_peak.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).peak_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    iters = 4096
    for tf32, k in ((1, 8), (0, 16)):
        for warps in (4, 16):
            blocks = sms * warps // 4
            buf = torch.empty(blocks * 128, device=dev)

            def run():
                _build.check_launch("peak", fn(tf32, buf.data_ptr(), blocks,
                                               iters, _build.stream_of(dev)))

            run()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            stop.record()
            stop.synchronize()
            ms = start.elapsed_time(stop)
            flop = blocks * 4 * iters * 8 * 2 * 16 * 8 * k
            _phase(peak="tf32_m16n8k8" if tf32 else "bf16_m16n8k16",
                   warps_per_sm=warps, chains_per_warp=8, ms=ms,
                   tflops=flop / ms / 1e9)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True, type=Path)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--peak", action="store_true",
                    help="also time back-to-back mma.sync on the card")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("probe_flash_f32: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ref as fa_ref
    names = args.variants.split(",")
    args.out.mkdir(parents=True, exist_ok=True)
    if args.peak:
        peak_phase(args.out)
    built = build_variants(args.out, names)
    dev = torch.device("cuda", 0)
    argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    table = {c[0]: c for c in chip_smoke.HY_FLASH_CASES + EXTRA_CASES}
    for name in names:
        lib, log = built[name]
        _phase(variant=name, ptxas=",".join(_ptxas(log)))
        fn = ctypes.CDLL(str(lib)).flash_attention_f32_launch
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        for case in CASES:
            _, b, h, hkv, sq, skv, dh, _, causal = table[case]
            skv = sq if skv is None else skv
            gen = torch.Generator(dev).manual_seed(4)
            q, k, v = (torch.randn((b, n, s, dh), generator=gen, device=dev)
                       for n, s in ((h, sq), (hkv, skv), (hkv, skv)))
            o = torch.empty_like(q)

            def run():
                _build.check_launch("probe", fn(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    b, h, hkv, sq, skv, dh, math.sqrt(dh), int(causal),
                    _build.stream_of(dev)))

            run()
            want = fa_ref.flash_attention_ref(q, k, v, causal=causal)
            err = float((o - want).abs().max())
            tol = chip_smoke.TOL_FLASH_F32
            inside = bool(((o - want).abs() <= tol * (1 + want.abs())).all())
            for _ in range(3):
                run()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                run()
            stop.record()
            stop.synchronize()
            _phase(variant=name, case=case, ms=start.elapsed_time(stop) / 20,
                   max_abs_err=err, inside_bar=inside)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    _phase(card=card.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
