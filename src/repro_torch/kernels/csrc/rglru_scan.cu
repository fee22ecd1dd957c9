// Diagonal linear recurrence (the RG-LRU's inner loop) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/rglru_scan/kernel.py · rglru_scan_pallas
// (_rglru_kernel, pallas_call :66). For every channel (b, w) of
// a, b [B, S, W] (fp32, contiguous) it computes, from h_{-1} = 0,
//
//     h[b, t, w] = a[b, t, w] * h[b, t-1, w] + b[b, t, w]
//
// and writes every h [B, S, W] (fp32).
//
// What bounds it: bytes. Each element of a and b is read once and each h
// written once, 12 bytes for one FMA: at the served shape [32, 128, 2560]
// that is 126 MB, 37.6 us at 3.35 TB/s.
//
// Design: the TPU kernel's "one HBM pass" schedule. Its sequential grid
// with time innermost and the carry in a VMEM scratch tile becomes a loop
// over S inside one thread per channel, the fp32 carry in a register.
// Neighbouring threads own neighbouring w, so every load and store of a
// warp is one coalesced 128-byte row segment. The loop reads kUnroll steps
// of a and b before it computes them, so that many loads of a thread are
// in flight at once (the carry chain is only the FMA). Ragged B and W are
// masked; any S >= 1 is taken (time is never padded: a padded step would
// corrupt the carry). The carry is one fmaf per step: a*h + b rounded once,
// where the plain version rounds the product and the sum apart.
//
// Occupancy: one thread per channel gives B*W threads, 81,920 at the
// served shape but 10,240 at one long request's [4, 4096, 2560] — a few
// warps an SM. A chunked two-pass scan (carries of chunks, then a fix-up)
// would fill the card; that is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;    // small blocks spread few channels over many SMs
constexpr int kUnroll = 8;

__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ h, int B, int S, int W) {
  const long long ch = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (ch >= (long long)B * W) return;
  const int bi = (int)(ch / W), w = (int)(ch % W);
  const size_t base = (size_t)bi * S * W + w;
  const float* ap = a + base;
  const float* bp = b + base;
  float* hp = h + base;
  float carry = 0.f;
  int t = 0;
  for (; t + kUnroll <= S; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      av[i] = ap[(size_t)(t + i) * W];
      bv[i] = bp[(size_t)(t + i) * W];
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      carry = fmaf(av[i], carry, bv[i]);
      hp[(size_t)(t + i) * W] = carry;
    }
  }
  for (; t < S; ++t) {
    carry = fmaf(ap[(size_t)t * W], carry, bp[(size_t)t * W]);
    hp[(size_t)t * W] = carry;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int rglru_scan_launch(const float* a, const float* b, float* h, int B, int S, int W,
                                 void* stream) {
  if (B < 1 || S < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const long long channels = (long long)B * W;
  const long long blocks = (channels + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  rglru_scan_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, h, B, S, W);
  return (int)cudaGetLastError();
}
