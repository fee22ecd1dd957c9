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
//
// Backward (training; the reference differentiates its associative scan
// with XLA's autodiff and has no kernel for it): given h and the gradient
// g = dL/dh, the same recurrence runs in reverse time over one channel,
//
//     dh[t] = g[t] + a[t+1] * dh[t+1],   dh[S] = 0
//     db[t] = dh[t],   da[t] = dh[t] * h[t-1],   h[-1] = 0
//
// in one pass that reads a, g and h once and writes da and db once (20
// bytes an element): a[t+1] is carried from the step before, so neither
// the shift nor the time flip needs a copy.

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

__global__ void __launch_bounds__(kThreads)
rglru_scan_bwd_kernel(const float* __restrict__ a, const float* __restrict__ h,
                      const float* __restrict__ g, float* __restrict__ da,
                      float* __restrict__ db, int B, int S, int W) {
  const long long ch = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (ch >= (long long)B * W) return;
  const int bi = (int)(ch / W), w = (int)(ch % W);
  const size_t base = (size_t)bi * S * W + w;
  const float* ap = a + base;
  const float* hp = h + base;
  const float* gp = g + base;
  float* dap = da + base;
  float* dbp = db + base;
  float carry = 0.f;     // dh[t+1]
  float a_next = 0.f;    // a[t+1]
  int t = S - 1;
  // steps t, t-1, ..., t-kUnroll+1; h[t-i-1] is 0 before the first step
  for (; t + 1 >= kUnroll; t -= kUnroll) {
    float av[kUnroll], gv[kUnroll], hv[kUnroll];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      av[i] = ap[(size_t)(t - i) * W];
      gv[i] = gp[(size_t)(t - i) * W];
      hv[i] = t - i >= 1 ? hp[(size_t)(t - i - 1) * W] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      carry = fmaf(a_next, carry, gv[i]);
      dbp[(size_t)(t - i) * W] = carry;
      dap[(size_t)(t - i) * W] = carry * hv[i];
      a_next = av[i];
    }
  }
  for (; t >= 0; --t) {
    carry = fmaf(a_next, carry, gp[(size_t)t * W]);
    dbp[(size_t)t * W] = carry;
    dap[(size_t)t * W] = t >= 1 ? carry * hp[(size_t)(t - 1) * W] : 0.f;
    a_next = ap[(size_t)t * W];
  }
}

unsigned blocks_for(int B, int W) {
  const long long channels = (long long)B * W;
  const long long blocks = (channels + kThreads - 1) / kThreads;
  return blocks > 0x7fffffffLL ? 0u : (unsigned)blocks;
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int rglru_scan_launch(const float* a, const float* b, float* h, int B, int S, int W,
                                 void* stream) {
  if (B < 1 || S < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const unsigned blocks = blocks_for(B, W);
  if (blocks == 0) return (int)cudaErrorInvalidValue;
  rglru_scan_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, h, B, S, W);
  return (int)cudaGetLastError();
}

// The backward: a, h (the forward's output) and g = dL/dh [B, S, W] fp32 ->
// da, db [B, S, W] fp32. Launches on `stream`; returns cudaGetLastError().
extern "C" int rglru_scan_bwd_launch(const float* a, const float* h, const float* g, float* da,
                                     float* db, int B, int S, int W, void* stream) {
  if (B < 1 || S < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const unsigned blocks = blocks_for(B, W);
  if (blocks == 0) return (int)cudaErrorInvalidValue;
  rglru_scan_bwd_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, h, g, da, db, B, S, W);
  return (int)cudaGetLastError();
}
