// Packed N-sample masked FFN for Hopper (sm_90a), fp32 on the CUDA cores.
//
// Replaces: src/repro/kernels/masked_ffn/kernel.py · masked_ffn_pallas,
// both bodies: _ffn_kernel (fp32) and _ffn_kernel_q (int8, :60). For every
// mask-sample n and voxel b it computes
//
//     y[n, b, :] = relu(x[b] @ w1p[n] + b1p[n]) @ w2p[n] + b2
//
// x [B, D], w1p [N, D, K], b1p [N, K], w2p [N, K, D2], b2 [D2] -> y [N, B, D2],
// all contiguous; x and y fp32. The fp32 body takes fp32 weights and
// biases. The int8 body reads int8 w1p/w2p with per-output-channel bf16
// scales s1 [N, 1, K] / s2 [N, 1, D2] and bf16 biases as stored, and
// dequantizes each weight next to its FMA: float(q) * float(s) is exact in
// fp32 (8 bits times an 8-bit mantissa), so the int8 body computes with
// the same values as its plain version. The IVIM plan passes b2 = 0 and
// adds its per-sample output bias after the launch.
//
// What bounds it: operations. At the dense IVIM shape (B = 4096 voxels,
// D = 104, K = D2 = 52, N = 32 rows) one launch does 2.13 GFLOP against
// 30 MB of traffic (27.3 MB of it the [N, B, D2] output), ~71 FLOP per
// byte, above the card's fp32 ridge of 67 TFLOP/s / 3.35 TB/s = 20.
//
// Design:
//  * Grid (ceil(B / 32), N): one block per (32-voxel tile, sample). The
//    tile index varies fastest, so the blocks of one sample run together
//    and its packed weights are read from L2 by every tile while hot — the
//    paper's batch-level schedule (sample-major grid of the TPU kernel).
//  * The x tile is staged in shared memory in 128-column chunks, and the
//    hidden tile [32, 64] lives in shared memory only — it never reaches
//    device memory (the TPU kernel's "intermediate layer cache").
//  * Any K and D are taken: K is walked in 64-unit chunks (each chunk's
//    contribution is added into y by the thread that owns that output
//    element), D in 128-column chunks. No padding: ragged B, D, K and D2
//    are masked here.
//  * Each thread owns one hidden unit (then one output column) for 8
//    voxels, so every weight it loads feeds 8 FMAs. Tensor cores, TMA and
//    a deeper register tile are later work.
//  * int8: the two bodies are one template over the weight and bias types;
//    a thread loads its column's scale once per pass. The weights are a
//    quarter of the fp32 bytes, but at the dense shape the launch is bound
//    by operations and its traffic by the fp32 output, so int8 cannot
//    lower the bound (see PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBB = 32;                        // voxels per block
constexpr int kRT = 8;                         // voxels per thread
constexpr int kTK = 64;                        // hidden units (and output columns) per pass
constexpr int kTD = 128;                       // input columns per staged x chunk
constexpr int kThreads = (kBB / kRT) * kTK;    // 256

__device__ __forceinline__ float val(float v) { return v; }
__device__ __forceinline__ float val(__nv_bfloat16 v) { return __bfloat162float(v); }

// A weight as the body multiplies by it: fp32 as stored, or int8 times its
// column's scale (`sc`, 1 for fp32 and unused).
__device__ __forceinline__ float weight(float w, float) { return w; }
__device__ __forceinline__ float weight(int8_t q, float sc) { return (float)q * sc; }

// A column's dequant scale; fp32 weights have none.
__device__ __forceinline__ float col_scale(const __nv_bfloat16* s, size_t i) {
  return s ? __bfloat162float(s[i]) : 1.f;
}

template <typename W, typename Bv>
__global__ void __launch_bounds__(kThreads)
masked_ffn_kernel(const float* __restrict__ x, const W* __restrict__ w1p,
                  const __nv_bfloat16* __restrict__ s1, const Bv* __restrict__ b1p,
                  const W* __restrict__ w2p, const __nv_bfloat16* __restrict__ s2,
                  const Bv* __restrict__ b2, float* __restrict__ y,
                  int B, int D, int K, int D2) {
  __shared__ float xs[kBB][kTD + 1];
  __shared__ float hs[kBB][kTK + 1];
  const int n = blockIdx.y;
  const int b0 = blockIdx.x * kBB;
  const int c = threadIdx.x % kTK;             // unit / column within a pass
  const int r0 = (threadIdx.x / kTK) * kRT;    // first of this thread's voxels
  const W* w1 = w1p + (size_t)n * D * K;
  const W* w2 = w2p + (size_t)n * K * D2;
  float* yn = y + (size_t)n * B * D2;

  for (int kc = 0; kc < K; kc += kTK) {
    const int k = kc + c;
    const float sc1 = k < K ? col_scale(s1, (size_t)n * K + k) : 0.f;
    float acc[kRT];
#pragma unroll
    for (int i = 0; i < kRT; ++i) acc[i] = 0.f;
    for (int dc = 0; dc < D; dc += kTD) {
      const int td = min(kTD, D - dc);
      __syncthreads();                         // xs and hs are free again
      for (int e = threadIdx.x; e < kBB * kTD; e += kThreads) {
        const int r = e / kTD, d = e % kTD;
        xs[r][d] = (b0 + r < B && d < td) ? x[(size_t)(b0 + r) * D + dc + d] : 0.f;
      }
      __syncthreads();
      if (k < K) {
        for (int d = 0; d < td; ++d) {
          const float w = weight(w1[(size_t)(dc + d) * K + k], sc1);
#pragma unroll
          for (int i = 0; i < kRT; ++i) acc[i] = fmaf(xs[r0 + i][d], w, acc[i]);
        }
      }
    }
    const float bias = k < K ? val(b1p[(size_t)n * K + k]) : 0.f;
#pragma unroll
    for (int i = 0; i < kRT; ++i) hs[r0 + i][c] = k < K ? fmaxf(acc[i] + bias, 0.f) : 0.f;
    __syncthreads();

    const int tk = min(kTK, K - kc);
    for (int jc = 0; jc < D2; jc += kTK) {
      const int j = jc + c;
      if (j >= D2) break;
      const float sc2 = col_scale(s2, (size_t)n * D2 + j);
      float out[kRT];
#pragma unroll
      for (int i = 0; i < kRT; ++i) out[i] = 0.f;
      for (int kk = 0; kk < tk; ++kk) {
        const float w = weight(w2[(size_t)(kc + kk) * D2 + j], sc2);
#pragma unroll
        for (int i = 0; i < kRT; ++i) out[i] = fmaf(hs[r0 + i][kk], w, out[i]);
      }
#pragma unroll
      for (int i = 0; i < kRT; ++i) {
        const int b = b0 + r0 + i;
        if (b < B) {
          float* dst = yn + (size_t)b * D2 + j;
          *dst = out[i] + (kc == 0 ? val(b2[j]) : *dst);
        }
      }
    }
  }
}

template <typename W, typename Bv>
int launch(const float* x, const W* w1p, const __nv_bfloat16* s1, const Bv* b1p,
           const W* w2p, const __nv_bfloat16* s2, const Bv* b2, float* y,
           int B, int D, int K, int D2, int N, void* stream) {
  if (B < 1 || D < 1 || K < 1 || D2 < 1 || N < 1 || N > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((B + kBB - 1) / kBB, N);
  masked_ffn_kernel<W, Bv><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w1p, s1, b1p, w2p, s2, b2, y, B, D, K, D2);
  return (int)cudaGetLastError();
}

}  // namespace

// Both entries launch on `stream` and return cudaGetLastError() (0 on
// success). The fp32 body:
extern "C" int masked_ffn_launch(const float* x, const float* w1p, const float* b1p,
                                 const float* w2p, const float* b2, float* y,
                                 int B, int D, int K, int D2, int N, void* stream) {
  return launch<float, float>(x, w1p, nullptr, b1p, w2p, nullptr, b2, y, B, D, K, D2, N,
                              stream);
}

// The int8 body: int8 weights, bf16 scales and bf16 biases.
extern "C" int masked_ffn_q_launch(const float* x, const int8_t* w1p, const __nv_bfloat16* s1,
                                   const __nv_bfloat16* b1p, const int8_t* w2p,
                                   const __nv_bfloat16* s2, const __nv_bfloat16* b2, float* y,
                                   int B, int D, int K, int D2, int N, void* stream) {
  if (!s1 || !s2) return (int)cudaErrorInvalidValue;
  return launch<int8_t, __nv_bfloat16>(x, w1p, s1, b1p, w2p, s2, b2, y, B, D, K, D2, N,
                                       stream);
}
