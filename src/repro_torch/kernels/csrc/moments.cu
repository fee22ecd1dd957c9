// Predictive moments over the mask-sample axis for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/moments/kernel.py · moments_pallas
// (_moments_kernel, pallas_call :46). For samples x [N, B, P] (fp32 or bf16,
// contiguous) it writes, for every element (b, p),
//
//     mean = (sum_n x[n, b, p]) / N
//     std  = sqrt((sum_n (x[n, b, p] - mean)^2) / N)        (ddof = 0)
//
// in the input's type, accumulated in fp32. The variance is centered and
// two-pass, as in the TPU kernel: the E[x^2] - E[x]^2 form cancels when the
// samples nearly agree, the low-uncertainty case the paper cares about.
//
// What bounds it: bytes. Each sample is read once and each output written
// once, (N + 2) elements for about 3N flops an element: at the largest
// served shape, the posterior [4, 8, 256000] fp32, 49 MB, 14.7 us at
// 3.35 TB/s.
//
// Design: the TPU kernel holds the whole sample axis of a batch tile in VMEM
// for its two passes. Here one thread owns one (b, p) element and walks N
// twice; neighbouring threads own neighbouring elements, so every load of a
// warp is one coalesced segment of one [B, P] slice. The kernel is a
// template on C, the samples a thread holds in registers (8, 16, 32 or 64;
// the wrapper picks the smallest C >= N, and 64 beyond that). A thread
// issues all its min(N, C) loads before its first add, so up to 64 loads
// of a thread are in flight at once, and for N <= 64 each sample is read
// from device memory exactly once: both passes run from registers. Past 64
// samples the rest is read again in the second pass, from L1/L2 where it
// still is. Sums run in sample order n = 0 .. N-1 and the squares are
// accumulated with fmaf, whatever C: every bucket gives the same bits. No
// block divisibility and no lane padding (the reference's ops.py needs
// both): the ragged tail of B*P is masked, and any N >= 1 is taken.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
moments_kernel(const T* __restrict__ x, T* __restrict__ mean_out, T* __restrict__ std_out, int N,
               long long M) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= M) return;
  const T* xp = x + e;
  T raw[C];                                   // every load issued before the first add
#pragma unroll
  for (int i = 0; i < C; ++i)
    if (i < N) raw[i] = xp[(size_t)i * M];
  float v[C];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < C; ++i)
    if (i < N) {
      v[i] = to_f(raw[i]);
      sum += v[i];
    }
  for (int n = C; n < N; ++n) sum += to_f(xp[(size_t)n * M]);
  const float mean = sum / (float)N;
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < C; ++i)
    if (i < N) {
      const float d = v[i] - mean;
      ss = fmaf(d, d, ss);
    }
  for (int n = C; n < N; ++n) {
    const float d = to_f(xp[(size_t)n * M]) - mean;
    ss = fmaf(d, d, ss);
  }
  store(mean_out + e, mean);
  store(std_out + e, sqrtf(ss / (float)N));
}

template <typename T>
int launch(const T* x, T* mean, T* std, int N, long long M, int C, void* stream) {
  if (N < 1 || M < 1) return (int)cudaErrorInvalidValue;
  const long long blocks = (M + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = (unsigned)blocks;
  switch (C) {
    case 8: moments_kernel<T, 8><<<grid, kThreads, 0, s>>>(x, mean, std, N, M); break;
    case 16: moments_kernel<T, 16><<<grid, kThreads, 0, s>>>(x, mean, std, N, M); break;
    case 32: moments_kernel<T, 32><<<grid, kThreads, 0, s>>>(x, mean, std, N, M); break;
    case 64: moments_kernel<T, 64><<<grid, kThreads, 0, s>>>(x, mean, std, N, M); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x [N, M] (M = B*P) -> mean, std [M], with C samples a thread in registers
// (8, 16, 32 or 64). Launches on `stream`; returns cudaGetLastError() (0 on
// success).
extern "C" int moments_f32_launch(const float* x, float* mean, float* std, int N, long long M,
                                  int C, void* stream) {
  return launch<float>(x, mean, std, N, M, C, stream);
}

extern "C" int moments_bf16_launch(const __nv_bfloat16* x, __nv_bfloat16* mean,
                                   __nv_bfloat16* std, int N, long long M, int C,
                                   void* stream) {
  return launch<__nv_bfloat16>(x, mean, std, N, M, C, stream);
}
