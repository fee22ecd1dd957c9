// Packed N-sample masked FFN for Hopper (sm_90a), fp32 on the CUDA cores.
//
// Replaces: src/repro/kernels/masked_ffn/kernel.py · masked_ffn_pallas
// (fp32 body _ffn_kernel; the int8 body _ffn_kernel_q waits for the port's
// int8 slice). For every mask-sample n and voxel b it computes
//
//     y[n, b, :] = relu(x[b] @ w1p[n] + b1p[n]) @ w2p[n] + b2
//
// x [B, D], w1p [N, D, K], b1p [N, K], w2p [N, K, D2], b2 [D2] -> y [N, B, D2],
// all contiguous fp32. The IVIM plan passes b2 = 0 and adds its per-sample
// output bias after the launch.
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

#include <cuda_runtime.h>

namespace {

constexpr int kBB = 32;                        // voxels per block
constexpr int kRT = 8;                         // voxels per thread
constexpr int kTK = 64;                        // hidden units (and output columns) per pass
constexpr int kTD = 128;                       // input columns per staged x chunk
constexpr int kThreads = (kBB / kRT) * kTK;    // 256

__global__ void __launch_bounds__(kThreads)
masked_ffn_kernel(const float* __restrict__ x, const float* __restrict__ w1p,
                  const float* __restrict__ b1p, const float* __restrict__ w2p,
                  const float* __restrict__ b2, float* __restrict__ y,
                  int B, int D, int K, int D2) {
  __shared__ float xs[kBB][kTD + 1];
  __shared__ float hs[kBB][kTK + 1];
  const int n = blockIdx.y;
  const int b0 = blockIdx.x * kBB;
  const int c = threadIdx.x % kTK;             // unit / column within a pass
  const int r0 = (threadIdx.x / kTK) * kRT;    // first of this thread's voxels
  const float* w1 = w1p + (size_t)n * D * K;
  const float* w2 = w2p + (size_t)n * K * D2;
  float* yn = y + (size_t)n * B * D2;

  for (int kc = 0; kc < K; kc += kTK) {
    const int k = kc + c;
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
          const float w = w1[(size_t)(dc + d) * K + k];
#pragma unroll
          for (int i = 0; i < kRT; ++i) acc[i] = fmaf(xs[r0 + i][d], w, acc[i]);
        }
      }
    }
    const float bias = k < K ? b1p[(size_t)n * K + k] : 0.f;
#pragma unroll
    for (int i = 0; i < kRT; ++i) hs[r0 + i][c] = k < K ? fmaxf(acc[i] + bias, 0.f) : 0.f;
    __syncthreads();

    const int tk = min(kTK, K - kc);
    for (int jc = 0; jc < D2; jc += kTK) {
      const int j = jc + c;
      if (j >= D2) break;
      float out[kRT];
#pragma unroll
      for (int i = 0; i < kRT; ++i) out[i] = 0.f;
      for (int kk = 0; kk < tk; ++kk) {
        const float w = w2[(size_t)(kc + kk) * D2 + j];
#pragma unroll
        for (int i = 0; i < kRT; ++i) out[i] = fmaf(hs[r0 + i][kk], w, out[i]);
      }
#pragma unroll
      for (int i = 0; i < kRT; ++i) {
        const int b = b0 + r0 + i;
        if (b < B) {
          float* dst = yn + (size_t)b * D2 + j;
          *dst = out[i] + (kc == 0 ? b2[j] : *dst);
        }
      }
    }
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int masked_ffn_launch(const float* x, const float* w1p, const float* b1p,
                                 const float* w2p, const float* b2, float* y,
                                 int B, int D, int K, int D2, int N, void* stream) {
  if (B < 1 || D < 1 || K < 1 || D2 < 1 || N < 1 || N > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((B + kBB - 1) / kBB, N);
  masked_ffn_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w1p, b1p, w2p, b2, y, B, D, K, D2);
  return (int)cudaGetLastError();
}
