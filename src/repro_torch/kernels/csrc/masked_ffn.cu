// Packed N-sample masked FFN for Hopper (sm_90a): fp32 values, products in
// 3xTF32 on the tensor cores (dense_tile.cuh).
//
// Replaces: src/repro/kernels/masked_ffn/kernel.py · masked_ffn_pallas,
// both bodies — _ffn_kernel (fp32) and _ffn_kernel_q (int8, :60) — and both
// grid orders (sample_major, :105-110). For every mask-sample n and voxel b
// it computes
//
//     y[n, b, :] = relu(x[b] @ w1p[n] + b1p[n]) @ w2p[n] + b2
//
// x [B, D], w1p [N, D, K], b1p [N, K], w2p [N, K, D2], b2 [D2] -> y [N, B, D2],
// all contiguous; x and y fp32. The fp32 body takes fp32 weights and
// biases. The int8 body reads int8 w1p/w2p with per-output-channel bf16
// scales s1 [N, 1, K] / s2 [N, 1, D2] and bf16 biases as stored; it stages
// a sample's int8 weights as int8 and widens them once a block,
// float(q) * float(s), exact in fp32, so it computes with the values of its
// plain version. The IVIM plan passes b2 = 0 and adds its per-sample output
// bias after the launch.
//
// What bounds it: operations. At the dense IVIM shape (B = 4096 voxels,
// D = 104, K = D2 = 52, N = 32 rows) one launch does 2.13 GFLOP against
// 30 MB of traffic (27.3 MB of it the [N, B, D2] output written once),
// ~71 FLOP per byte: the three tf32 products of 3xTF32 at 495 TFLOP/s
// (165 TFLOP/s of fp32 products) need 0.013 ms, above the 0.009 ms the
// bytes take (0.032 ms at the CUDA cores' 67 TFLOP/s).
//
// The earlier design ran 32-voxel blocks (4,096 at the IVIM shape) whose
// threads read their weight columns straight from L2 for every tile (~134
// MB a launch) and fed 1 FMA per shared load. This design:
//  * one 1-D grid of (tile, sample) blocks, kT = 64 voxels a tile (32 and
//    128 were slower on the card, PERF.md). sample_major = 1 is the paper's batch-level schedule (the
//    tile index varies fastest, so the blocks of one sample run together
//    while its weights are hot in L2); sample_major = 0 the sampling-level
//    order (the sample index varies fastest). One block body serves both,
//    so the two orders give bit-equal results;
//  * a block stages its x tile and sample n's w1p / w2p (32 KB at the IVIM
//    widths) in shared memory by bulk copies (dense_tile::stage_bulk; the
//    x rows land as stored and are transposed in shared memory), w2p
//    landing while the first product runs, and keeps the hidden tile [K][T] in
//    shared memory only — it never reaches device memory (the TPU kernel's
//    "intermediate layer cache");
//  * both products run 3xTF32 on the tensor cores (dense_tile.cuh), one
//    warp job of 16 voxels x 32 columns a warp;
//  * y is written from the registers that hold it: a lane's two adjacent
//    columns of a voxel as one float2 where D2 is even (the four lanes of a
//    quad fill a 32-byte sector of the row), masked scalars otherwise;
//  * any D, K and D2 are taken: K and D2 are walked in chunks that keep one
//    warp job a warp (64 columns at kT = 64), K's contributions added into y
//    by the lane that owns that output, and D in chunks of 128. Ragged B,
//    D, K and D2 are masked; padding up to a multiple of 8 is zero.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "dense_tile.cuh"
#include "smem_limit.cuh"

namespace {

using namespace dense_tile;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kT = 64;                         // voxels a block: four 16-row tensor-core tiles
constexpr int kDC = 128;                       // input columns a staged x chunk
constexpr int kBarFloats = 8;                  // two mbarriers at the head of shared memory

// Chunk sizes and shared-memory layout (floats) of one launch, the same on
// the host and in the kernel. Hidden (KC) and output (JC) chunks keep one
// tensor-core warp job a warp: (kT / 16) x ceil(cols / 32) <= 8.
struct Plan {
  int ldt, KC, DC, JC;                         // tile stride; hidden, input, output chunks
  int xr, xs, w1s, hs, w2s, q1, q2, floats;    // offsets, total
  __host__ __device__ Plan(int D, int K, int D2, bool quant) {
    ldt = kT + kPad;
    const int cap = kNT * 8 * (kWarps / (kT / 16));
    KC = K < cap ? K : cap;
    JC = D2 < cap ? D2 : cap;
    DC = D < kDC ? D : kDC;
    xr = kBarFloats;                           // the x chunk as it lands, [kT][DC]
    xs = xr + round4(kT * DC);                 // k-major, only where D % 8 != 0
    w1s = xs + (D % 8 ? round8(DC) * ldt : 0);
    hs = w1s + round4(round8(DC) * KC);
    w2s = hs + round8(KC) * ldt;
    q1 = w2s + round4(round8(KC) * JC) + 8;    // 8: the last row's padded columns
    q2 = q1 + (quant ? round4((DC * KC + 3) / 4) : 0);     // int8 staging, in floats
    floats = q2 + (quant ? round4((KC * JC + 3) / 4) : 0);
  }
};

// Stage w[r0 : r0 + rows, c0 : c0 + cols] of one sample's [R, C] weight
// into an fp32 [round8(rows)][cols] tile, padding rows zero: fp32
// directly; int8 into `q` contiguously, widened later by dequant_rows.
// Returns the bytes sent through `bar` (stage_bulk).
__device__ __forceinline__ unsigned stage_w(float* dst, void*, const float* w, int C, int r0,
                                            int c0, int rows, int cols, uint64_t* bar) {
  zero_rows(dst, cols, rows, round8(rows));
  return stage_bulk(dst, cols, w + (size_t)r0 * C + c0, C, rows, cols, 4, bar);
}
__device__ __forceinline__ unsigned stage_w(float*, void* q, const int8_t* w, int C, int r0,
                                            int c0, int rows, int cols, uint64_t* bar) {
  return stage_bulk(q, cols, w + (size_t)r0 * C + c0, C, rows, cols, 1, bar);
}

template <typename W, typename Bv>
__global__ void __launch_bounds__(kThreads)
masked_ffn_kernel(const float* __restrict__ x, const W* __restrict__ w1p,
                  const __nv_bfloat16* __restrict__ s1, const Bv* __restrict__ b1p,
                  const W* __restrict__ w2p, const __nv_bfloat16* __restrict__ s2,
                  const Bv* __restrict__ b2, float* __restrict__ y, int B, int D, int K, int D2,
                  int N, int n_tiles, int sample_major) {
  constexpr bool kQuant = sizeof(W) == 1;
  constexpr int T = kT;
  extern __shared__ __align__(16) float smem[];
  const Plan pl(D, K, D2, kQuant);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);   // [0]: x and w1, [1]: w2
  float* xr = smem + pl.xr;
  float *xs = smem + pl.xs, *w1s = smem + pl.w1s, *hs = smem + pl.hs, *w2s = smem + pl.w2s;
  int8_t* q1 = reinterpret_cast<int8_t*>(smem + pl.q1);
  int8_t* q2 = reinterpret_cast<int8_t*>(smem + pl.q2);
  const int bid = blockIdx.x;
  const int n = sample_major ? bid / n_tiles : bid % N;
  const int b0 = (sample_major ? bid % n_tiles : bid / N) * T;
  const W* w1 = w1p + (size_t)n * D * K;
  const W* w2 = w2p + (size_t)n * K * D2;
  float* yn = y + (size_t)n * B * D2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const int valid = min(T, B - b0);
  if (threadIdx.x == 0) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
  }
  unsigned ph0 = 0, ph1 = 0;                   // the phase each mbarrier waits for next

  for (int kc = 0; kc < K; kc += pl.KC) {
    const int tk = min(pl.KC, K - kc);
    const bool live1 = warp < tc_jobs(T, tk);  // this warp's hidden job
    const TcJob j1 = tc_job(warp, T, tk);
    float acc[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
    for (int dc = 0; dc < D; dc += pl.DC) {
      const int td = min(pl.DC, D - dc);
      __syncthreads();                         // xr, xs, w1s (and at dc = 0 w2s, hs) are free
      unsigned bytes = stage_bulk(xr, td, x + (size_t)b0 * D + dc, D, valid, td, 4, &bars[0]);
      bytes += stage_w(w1s, q1, w1, K, dc, kc, td, tk, &bars[0]);
      cp_async_commit();
      if (threadIdx.x == 0) mbar_arrive_tx(&bars[0], bytes);
      if (dc == 0) {                           // w2's first chunk lands during product 1
        bytes = stage_w(w2s, q2, w2, D2, kc, 0, tk, min(pl.JC, D2), &bars[1]);
        cp_async_commit();
        if (threadIdx.x == 0) mbar_arrive_tx(&bars[1], bytes);
      }
      if (dc == 0)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      mbar_wait(&bars[0], ph0);
      ph0 ^= 1;
      __syncthreads();
      // the first product reads the x rows as they landed (A fragments from
      // row-major rows) where a chunk's width is a multiple of 8 (every
      // chunk when D is); otherwise from a k-major tile with zero rows up to it
      const bool rows_ok = td % 8 == 0;
      if (!rows_ok) transpose_x(xr, td, valid, xs, pl.ldt, T);
      if constexpr (kQuant) dequant_rows(w1s, tk, q1, td, tk, s1 + (size_t)n * K + kc);
      if (!rows_ok || kQuant) __syncthreads();
      if (live1) {
        if (rows_ok)
          tc_fma(acc, xr, td, 1, j1.m0, w1s, tk, j1.n0, j1.nt, td);
        else
          tc_fma(acc, xs, 1, pl.ldt, j1.m0, w1s, tk, j1.n0, j1.nt, round8(td));
      }
    }
    if (live1)
      tc_store(hs, pl.ldt, j1, tk, acc, b1p + (size_t)n * K + kc, nullptr, kRelu);

    for (int jc = 0; jc < D2; jc += pl.JC) {
      const int tj = min(pl.JC, D2 - jc);
      if (jc > 0) {
        __syncthreads();                       // w2s is free
        const unsigned bytes = stage_w(w2s, q2, w2, D2, kc, jc, tk, tj, &bars[1]);
        cp_async_commit();
        if (threadIdx.x == 0) mbar_arrive_tx(&bars[1], bytes);
      }
      cp_async_wait<0>();
      mbar_wait(&bars[1], ph1);
      ph1 ^= 1;
      __syncthreads();                         // hs and w2s complete
      if constexpr (kQuant) {
        dequant_rows(w2s, tj, q2, tk, tj, s2 + (size_t)n * D2 + jc);
        __syncthreads();
      }
      if (warp >= tc_jobs(T, tj)) continue;
      const TcJob j2 = tc_job(warp, T, tj);
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
      tc_fma(acc, hs, 1, pl.ldt, j2.m0, w2s, tj, j2.n0, j2.nt, round8(tk));
      // a lane holds columns 2c, 2c + 1 of an n-tile for voxels g and g + 8:
      // one float2 each where D2 is even (a quad of lanes covers 32 bytes)
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        if (j >= j2.nt) break;
        const int col = j2.n0 + 8 * j + 2 * c;           // within the chunk
        if (col >= tj) continue;
        const float bias0 = to_float(b2[jc + col]);
        const float bias1 = col + 1 < tj ? to_float(b2[jc + col + 1]) : 0.f;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int b = b0 + j2.m0 + g + 8 * r;
          if (b >= B) continue;
          float* dst = yn + (size_t)b * D2 + jc + col;
          const float v0 = acc[j][2 * r], v1 = acc[j][2 * r + 1];
          if (D2 % 2 == 0) {                   // tj is even: col + 1 < tj
            const float2 prev = kc == 0 ? make_float2(bias0, bias1)
                                        : *reinterpret_cast<const float2*>(dst);
            *reinterpret_cast<float2*>(dst) = make_float2(v0 + prev.x, v1 + prev.y);
          } else {
            dst[0] = v0 + (kc == 0 ? bias0 : dst[0]);
            if (col + 1 < tj) dst[1] = v1 + (kc == 0 ? bias1 : dst[1]);
          }
        }
      }
    }
    __syncthreads();                           // hs and w2s are free for the next K chunk
  }
}

template <typename W, typename Bv>
int launch(const float* x, const W* w1p, const __nv_bfloat16* s1, const Bv* b1p, const W* w2p,
           const __nv_bfloat16* s2, const Bv* b2, float* y, int B, int D, int K, int D2, int N,
           int sample_major, void* stream) {
  // N is held to the 65,535 of a grid's y dimension, as in the earlier
  // (tile, sample) grid, in both orders.
  if (B < 1 || D < 1 || K < 1 || D2 < 1 || N < 1 || N > 65535 ||
      (long long)((B + kT - 1) / kT) * N > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const Plan pl(D, K, D2, sizeof(W) == 1);
  const int smem = 4 * pl.floats;
  static SmemLimit limit;                      // one a template instance
  const int err = (int)limit.raise((const void*)masked_ffn_kernel<W, Bv>, smem);
  if (err) return err;
  const int n_tiles = (B + kT - 1) / kT;
  masked_ffn_kernel<W, Bv><<<(unsigned)n_tiles * N, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      x, w1p, s1, b1p, w2p, s2, b2, y, B, D, K, D2, N, n_tiles, sample_major);
  return (int)cudaGetLastError();
}

}  // namespace

// Both entries launch on `stream` and return cudaGetLastError() (0 on
// success). sample_major picks the grid order (1: batch-level, 0:
// sampling-level). The fp32 body:
extern "C" int masked_ffn_launch(const float* x, const float* w1p, const float* b1p,
                                 const float* w2p, const float* b2, float* y, int B, int D, int K,
                                 int D2, int N, int sample_major, void* stream) {
  return launch<float, float>(x, w1p, nullptr, b1p, w2p, nullptr, b2, y, B, D, K, D2, N,
                              sample_major, stream);
}

// The int8 body: int8 weights, bf16 scales and bf16 biases.
extern "C" int masked_ffn_q_launch(const float* x, const int8_t* w1p, const __nv_bfloat16* s1,
                                   const __nv_bfloat16* b1p, const int8_t* w2p,
                                   const __nv_bfloat16* s2, const __nv_bfloat16* b2, float* y,
                                   int B, int D, int K, int D2, int N, int sample_major,
                                   void* stream) {
  if (!s1 || !s2) return (int)cudaErrorInvalidValue;
  return launch<int8_t, __nv_bfloat16>(x, w1p, s1, b1p, w2p, s2, b2, y, B, D, K, D2, N,
                                       sample_major, stream);
}
