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
// warp is one coalesced segment of one [B, P] slice. The first kCache samples
// of a thread stay in registers between the passes (all of them at the
// served N = 4 and 8), and their loads are issued together; later samples are
// read again in the second pass, from L1/L2 where they still are. Sums run in
// sample order n = 0 .. N-1; the squares are accumulated with fmaf. No block
// divisibility and no lane padding (the reference's ops.py needs both): the
// ragged tail of B*P is masked, and any N >= 1 is taken.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCache = 8;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
moments_kernel(const T* __restrict__ x, T* __restrict__ mean_out, T* __restrict__ std_out, int N,
               long long M) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= M) return;
  const T* xp = x + e;
  float v[kCache];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kCache; ++i) v[i] = i < N ? to_f(xp[(size_t)i * M]) : 0.f;
#pragma unroll
  for (int i = 0; i < kCache; ++i)
    if (i < N) sum += v[i];
  for (int n = kCache; n < N; ++n) sum += to_f(xp[(size_t)n * M]);
  const float mean = sum / (float)N;
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kCache; ++i)
    if (i < N) {
      const float d = v[i] - mean;
      ss = fmaf(d, d, ss);
    }
  for (int n = kCache; n < N; ++n) {
    const float d = to_f(xp[(size_t)n * M]) - mean;
    ss = fmaf(d, d, ss);
  }
  store(mean_out + e, mean);
  store(std_out + e, sqrtf(ss / (float)N));
}

template <typename T>
int launch(const T* x, T* mean, T* std, int N, long long M, void* stream) {
  if (N < 1 || M < 1) return (int)cudaErrorInvalidValue;
  const long long blocks = (M + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  moments_kernel<T><<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, mean, std, N, M);
  return (int)cudaGetLastError();
}

}  // namespace

// x [N, M] (M = B*P) -> mean, std [M]. Launches on `stream`; returns
// cudaGetLastError() (0 on success).
extern "C" int moments_f32_launch(const float* x, float* mean, float* std, int N, long long M,
                                  void* stream) {
  return launch<float>(x, mean, std, N, M, stream);
}

extern "C" int moments_bf16_launch(const __nv_bfloat16* x, __nv_bfloat16* mean,
                                   __nv_bfloat16* std, int N, long long M, void* stream) {
  return launch<__nv_bfloat16>(x, mean, std, N, M, stream);
}
