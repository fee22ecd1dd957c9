// Fused whole-plan chain for Hopper (sm_90a), fp32 on the CUDA cores.
//
// Replaces: src/repro/kernels/fused_plan/kernel.py · fused_plan_pallas, both
// modes (moments=False: samples; moments=True: in-kernel Welford moments),
// with the int8 dequant of its _dense (:52-60). The chain is a lowered
// FusedSpec (repro_torch/kernels/fused_plan/ref.py): dense steps (weights
// shared or per sample row, shared and/or per-row bias, fused activation)
// and bare activation steps, run on a batch tile whose activations
// ping-pong between two shared-memory tiles and never reach device memory.
//
// Weights are fp32, or int8 with one bf16 scale per output channel
// (Precision("int8")). The wrapper hands over three buffers as stored: fp32
// (fp32 weights, and every bias — bf16 biases widened once, exactly), int8
// weights, and their bf16 scales. An int8 weight is dequantized in the
// kernel, float(q) * float(s), exact in fp32 (8 bits times an 8-bit
// mantissa): where a body row is staged in shared memory (stage_row), and
// next to the FMA where a shared-prefix step reads device memory.
//
//  * fused_samples_kernel — grid (ceil(B / bB), n_rows): one block runs the
//    whole chain for one row over one batch tile; out [n_rows, B, d_out].
//  * fused_moments_kernel — grid (ceil(B / bB)): one block per batch tile.
//    The shared prefix (steps before the first per-row step) runs once;
//    then for each group g and mask k the block stages row g * n_masks + k's
//    parameters in shared memory, runs the chain and updates a running
//    Welford mean/M2 per (voxel, output). At the group's end it writes mean
//    and sqrt(M2 / n_masks) to columns [g * d_out, (g + 1) * d_out) of
//    mean/std [B, groups * d_out]; the [n_rows, B, d_out] sample tensor is
//    never materialized.
//
// What bounds it: operations. At the dense IVIM plan (width 104, 32 rows,
// K = 52) a 4,096-voxel chunk is 2.14 GFLOP against 2.9 MB of traffic
// (moments mode), ~740 FLOP per byte, far above the fp32 ridge of 20.
// int8 weights cut the 1.06 MB of parameters to 0.28 MB but leave the
// FLOPs, so they cannot move the bound; they cut the bytes each row's
// staging pulls from L2 (33 KB -> 8.5 KB of weights).
//
// Design against that, and against Hopper's 227 KB of shared memory a block
// (the TPU kernel kept every row's weights resident in 96 MiB of VMEM; here
// the dense plan's weights alone are 1.06 MB):
//  * residency is per row: a block stages one row's chain parameters at a
//    time (33 KB at width 104) and the wrapper's guard refuses a spec whose
//    widest row plus the three activation tiles exceeds 227 KB;
//  * all blocks walk the rows in the same order, so a row's parameters are
//    read from L2, not device memory, by every tile after the first;
//  * each thread computes one output column for 4 voxels of the tile, so a
//    staged weight feeds 4 FMAs. Tensor cores, TMA staging overlapped with
//    compute, and wider register tiles are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "smem_limit.cuh"

namespace {

constexpr int kMaxSteps = 32;
constexpr int kThreads = 256;
constexpr int kRT = 4;              // voxels per thread in a dense step; bB % kRT == 0

enum { kDense = 0, kAct = 1 };
enum { kIdentity = 0, kRelu = 1, kGelu = 2, kSilu = 3, kSigmoid = 4, kTanh = 5 };

// One step. Offsets in elements: b/bp into the fp32 parameter buffer, w
// into the fp32 buffer or, for an int8 weight (w_int8), into the int8
// buffer with its scales at ws in the bf16 one (per-row tensors start at
// row 0); sw/sb/sbp into the staged row buffer, in floats (steps of the
// body only). An act step has d_in == d_out == the width.
struct Step {
  int kind, act, per_sample, has_b, has_bp, d_in, d_out;
  long long w, b, bp;
  int sw, sb, sbp;
  int w_int8;
  long long ws;
};

struct Chain {
  int n_steps, cut;                 // steps [0, cut) are the shared prefix
  int n_rows, n_masks, groups;
  int d_in, d_out;
  int ld;                           // row stride of every activation tile (floats)
  int row_floats;                   // staged parameter floats of one row
  Step steps[kMaxSteps];
};

constexpr int kHeader = 9;          // layout of the int64 descriptor the wrapper builds
constexpr int kStepFields = 15;

int parse_chain(const long long* d, Chain* ch) {
  ch->n_steps = (int)d[0];
  ch->cut = (int)d[1];
  ch->n_rows = (int)d[2];
  ch->n_masks = (int)d[3];
  ch->groups = (int)d[4];
  ch->d_in = (int)d[5];
  ch->d_out = (int)d[6];
  ch->ld = (int)d[7];
  ch->row_floats = (int)d[8];
  if (ch->n_steps < 1 || ch->n_steps > kMaxSteps || ch->cut < 0 || ch->cut > ch->n_steps)
    return (int)cudaErrorInvalidValue;
  for (int s = 0; s < ch->n_steps; ++s) {
    const long long* f = d + kHeader + s * kStepFields;
    Step& st = ch->steps[s];
    st.kind = (int)f[0];
    st.act = (int)f[1];
    st.per_sample = (int)f[2];
    st.has_b = (int)f[3];
    st.has_bp = (int)f[4];
    st.d_in = (int)f[5];
    st.d_out = (int)f[6];
    st.w = f[7];
    st.b = f[8];
    st.bp = f[9];
    st.sw = (int)f[10];
    st.sb = (int)f[11];
    st.sbp = (int)f[12];
    st.w_int8 = (int)f[13];
    st.ws = f[14];
  }
  return 0;
}

// An int8 chain needs both of its buffers.
bool missing_int8_buffers(const Chain& ch, const int8_t* qparams, const __nv_bfloat16* scales) {
  for (int s = 0; s < ch.n_steps; ++s)
    if (ch.steps[s].kind == kDense && ch.steps[s].w_int8 && (!qparams || !scales)) return true;
  return false;
}

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case kRelu: return fmaxf(v, 0.f);
    case kGelu: {                   // tanh form, as jax.nn.gelu's default
      const float k0 = 0.7978845608028654f;   // sqrt(2 / pi)
      return 0.5f * v * (1.f + tanhf(k0 * (v + 0.044715f * v * v * v)));
    }
    case kSilu: return v / (1.f + expf(-v));
    case kSigmoid: return 1.f / (1.f + expf(-v));
    case kTanh: return tanhf(v);
    default: return v;
  }
}

__device__ void copy_floats(float* dst, const float* src, size_t n) {
  for (size_t e = threadIdx.x; e < n; e += blockDim.x) dst[e] = src[e];
}

// x rows [b0, b0 + bB) into a tile; rows past B are zeros.
__device__ void load_tile(const float* x, int B, int b0, int d_in, float* tile, int ld, int bB) {
  for (int e = threadIdx.x; e < bB * d_in; e += blockDim.x) {
    const int r = e / d_in, c = e % d_in;
    tile[r * ld + c] = b0 + r < B ? x[(size_t)(b0 + r) * d_in + c] : 0.f;
  }
}

// Stage row `row`'s parameters of every body step into shared memory, an
// int8 weight dequantized on the way.
__device__ void stage_row(const Chain& ch, const float* params, const int8_t* qparams,
                          const __nv_bfloat16* scales, float* staged, int row) {
  for (int s = ch.cut; s < ch.n_steps; ++s) {
    const Step& st = ch.steps[s];
    if (st.kind != kDense) continue;
    const size_t nw = (size_t)st.d_in * st.d_out;
    if (st.w_int8) {
      const int8_t* q = qparams + st.w + (st.per_sample ? row * nw : 0);
      const __nv_bfloat16* sc = scales + st.ws + (st.per_sample ? (size_t)row * st.d_out : 0);
      for (size_t e = threadIdx.x; e < nw; e += blockDim.x)
        staged[st.sw + e] = (float)q[e] * __bfloat162float(sc[e % st.d_out]);
    } else {
      copy_floats(staged + st.sw, params + st.w + (st.per_sample ? row * nw : 0), nw);
    }
    if (st.has_b) copy_floats(staged + st.sb, params + st.b, st.d_out);
    if (st.has_bp) copy_floats(staged + st.sbp, params + st.bp + (size_t)row * st.d_out, st.d_out);
  }
}

// The weights of a dense step as it multiplies by them: fp32 as stored
// (device memory or the staged row), or int8 times column c's bf16 scale.
struct F32Weights {
  const float* w;
  __device__ float scale(int) const { return 1.f; }
  __device__ float at(size_t i, float) const { return w[i]; }
};
struct Int8Weights {
  const int8_t* q;
  const __nv_bfloat16* s;
  __device__ float scale(int c) const { return __bfloat162float(s[c]); }
  __device__ float at(size_t i, float sc) const { return (float)q[i] * sc; }
};

// out[r][c] = act(in[r] . w[:, c] (+ b[c]) (+ bp[c])) over all bB rows.
template <typename Weights>
__device__ void dense(const float* in, float* out, int ld, int bB, Weights w,
                      const float* b, const float* bp, int d_in, int d_out, int act) {
  const int items = (bB / kRT) * d_out;
  for (int p = threadIdx.x; p < items; p += blockDim.x) {
    const int c = p % d_out, r0 = (p / d_out) * kRT;
    const float sc = w.scale(c);
    float acc[kRT];
#pragma unroll
    for (int i = 0; i < kRT; ++i) acc[i] = 0.f;
    for (int k = 0; k < d_in; ++k) {
      const float wk = w.at((size_t)k * d_out + c, sc);
#pragma unroll
      for (int i = 0; i < kRT; ++i) acc[i] = fmaf(in[(r0 + i) * ld + k], wk, acc[i]);
    }
#pragma unroll
    for (int i = 0; i < kRT; ++i) {
      float v = acc[i];
      if (b) v += b[c];
      if (bp) v += bp[c];
      out[(r0 + i) * ld + c] = activate(v, act);
    }
  }
}

// Steps [s0, s1) on tile `in`, ping-ponging between buf0 and buf1; returns
// the tile that holds the result (`in` itself when the range is empty).
// Prefix steps read their parameters from device memory, body steps from
// the staged row. Every step ends at a barrier.
__device__ const float* run_steps(const Chain& ch, int s0, int s1, const float* in,
                                  float* buf0, float* buf1, int bB,
                                  const float* params, const int8_t* qparams,
                                  const __nv_bfloat16* scales, const float* staged) {
  const float* cur = in;
  float* next = buf0;
  for (int s = s0; s < s1; ++s) {
    const Step& st = ch.steps[s];
    if (st.kind == kAct) {
      for (int e = threadIdx.x; e < bB * st.d_out; e += blockDim.x) {
        const int r = e / st.d_out, c = e % st.d_out;
        next[r * ch.ld + c] = activate(cur[r * ch.ld + c], st.act);
      }
    } else {
      const bool body = s >= ch.cut;
      const float* b = st.has_b ? (body ? staged + st.sb : params + st.b) : nullptr;
      const float* bp = st.has_bp ? staged + st.sbp : nullptr;   // never in the prefix
      if (body)
        dense(cur, next, ch.ld, bB, F32Weights{staged + st.sw}, b, bp, st.d_in, st.d_out,
              st.act);
      else if (st.w_int8)
        dense(cur, next, ch.ld, bB, Int8Weights{qparams + st.w, scales + st.ws}, b, bp,
              st.d_in, st.d_out, st.act);
      else
        dense(cur, next, ch.ld, bB, F32Weights{params + st.w}, b, bp, st.d_in, st.d_out,
              st.act);
    }
    __syncthreads();
    cur = next;
    next = next == buf0 ? buf1 : buf0;
  }
  return cur;
}

// Runs the shared prefix on the x tile held in `pfx` and parks its result
// back in `pfx`, which the per-row body reads for every row.
__device__ void run_prefix(const Chain& ch, float* pfx, float* buf0, float* buf1, int bB,
                           const float* params, const int8_t* qparams,
                           const __nv_bfloat16* scales) {
  const float* h = run_steps(ch, 0, ch.cut, pfx, buf0, buf1, bB, params, qparams, scales,
                             nullptr);
  if (h == pfx) return;
  const int w0 = ch.steps[ch.cut - 1].d_out;
  for (int e = threadIdx.x; e < bB * w0; e += blockDim.x) {
    const int r = e / w0, c = e % w0;
    pfx[r * ch.ld + c] = h[r * ch.ld + c];
  }
  __syncthreads();
}

// Shared memory: staged row | pfx tile | buf0 | buf1 (| mean | m2).
__global__ void __launch_bounds__(kThreads)
fused_samples_kernel(const __grid_constant__ Chain ch, const float* __restrict__ x, int B,
                     const float* __restrict__ params, const int8_t* __restrict__ qparams,
                     const __nv_bfloat16* __restrict__ scales, float* __restrict__ out,
                     int bB) {
  extern __shared__ float smem[];
  float* staged = smem;
  float* pfx = staged + ch.row_floats;
  float* buf0 = pfx + bB * ch.ld;
  float* buf1 = buf0 + bB * ch.ld;
  const int row = blockIdx.y, b0 = blockIdx.x * bB;
  load_tile(x, B, b0, ch.d_in, pfx, ch.ld, bB);
  stage_row(ch, params, qparams, scales, staged, row);
  __syncthreads();
  run_prefix(ch, pfx, buf0, buf1, bB, params, qparams, scales);
  const float* y = run_steps(ch, ch.cut, ch.n_steps, pfx, buf0, buf1, bB, params, qparams,
                             scales, staged);
  float* o = out + (size_t)row * B * ch.d_out;
  for (int e = threadIdx.x; e < bB * ch.d_out; e += blockDim.x) {
    const int r = e / ch.d_out, c = e % ch.d_out;
    if (b0 + r < B) o[(size_t)(b0 + r) * ch.d_out + c] = y[r * ch.ld + c];
  }
}

__global__ void __launch_bounds__(kThreads)
fused_moments_kernel(const __grid_constant__ Chain ch, const float* __restrict__ x, int B,
                     const float* __restrict__ params, const int8_t* __restrict__ qparams,
                     const __nv_bfloat16* __restrict__ scales, float* __restrict__ mean_out,
                     float* __restrict__ std_out, int bB) {
  extern __shared__ float smem[];
  float* staged = smem;
  float* pfx = staged + ch.row_floats;
  float* buf0 = pfx + bB * ch.ld;
  float* buf1 = buf0 + bB * ch.ld;
  float* mean = buf1 + bB * ch.ld;
  float* m2 = mean + bB * ch.d_out;
  const int b0 = blockIdx.x * bB, d_out = ch.d_out, cols = ch.groups * d_out;
  load_tile(x, B, b0, ch.d_in, pfx, ch.ld, bB);
  __syncthreads();
  run_prefix(ch, pfx, buf0, buf1, bB, params, qparams, scales);
  for (int g = 0; g < ch.groups; ++g) {
    for (int k = 0; k < ch.n_masks; ++k) {
      __syncthreads();              // the last row's chain and Welford are done
      stage_row(ch, params, qparams, scales, staged, g * ch.n_masks + k);
      __syncthreads();
      const float* y = run_steps(ch, ch.cut, ch.n_steps, pfx, buf0, buf1, bB, params, qparams,
                                 scales, staged);
      // Running Welford over the group's masks; element e stays with one
      // thread for the whole group, so mean/m2 need no barrier.
      for (int e = threadIdx.x; e < bB * d_out; e += blockDim.x) {
        const int r = e / d_out, c = e % d_out;
        const float v = y[r * ch.ld + c];
        if (k == 0) {
          mean[e] = v;
          m2[e] = 0.f;
        } else {
          const float delta = v - mean[e];
          mean[e] += delta / (float)(k + 1);
          m2[e] += delta * (v - mean[e]);
        }
        if (k == ch.n_masks - 1 && b0 + r < B) {
          const size_t at = (size_t)(b0 + r) * cols + g * d_out + c;
          mean_out[at] = mean[e];
          std_out[at] = sqrtf(m2[e] / (float)ch.n_masks);
        }
      }
    }
  }
}

}  // namespace

// Both entries: desc is the host int64 chain descriptor, smem the dynamic
// shared-memory bytes the wrapper computed (its residency guard has already
// held them to the 227 KB a block may opt into); qparams and scales are the
// int8 weights and their bf16 scales (null for an fp32 chain). Each
// launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int fused_samples_launch(const long long* desc, const float* x, int B,
                                    const float* params, const int8_t* qparams,
                                    const __nv_bfloat16* scales, float* out, int bB,
                                    long long smem, void* stream) {
  Chain ch;
  int err = parse_chain(desc, &ch);
  if (err) return err;
  if (B < 1 || bB < kRT || bB % kRT || ch.n_rows < 1 || ch.n_rows > 65535 ||
      missing_int8_buffers(ch, qparams, scales))
    return (int)cudaErrorInvalidValue;
  static SmemLimit limit;                  // the attribute is set once a device
  err = (int)limit.raise((const void*)fused_samples_kernel, (int)smem);
  if (err) return err;
  const dim3 grid((B + bB - 1) / bB, ch.n_rows);
  fused_samples_kernel<<<grid, kThreads, (size_t)smem, static_cast<cudaStream_t>(stream)>>>(
      ch, x, B, params, qparams, scales, out, bB);
  return (int)cudaGetLastError();
}

extern "C" int fused_moments_launch(const long long* desc, const float* x, int B,
                                    const float* params, const int8_t* qparams,
                                    const __nv_bfloat16* scales, float* mean, float* std,
                                    int bB, long long smem, void* stream) {
  Chain ch;
  int err = parse_chain(desc, &ch);
  if (err) return err;
  if (B < 1 || bB < kRT || bB % kRT || missing_int8_buffers(ch, qparams, scales))
    return (int)cudaErrorInvalidValue;
  static SmemLimit limit;                  // the attribute is set once a device
  err = (int)limit.raise((const void*)fused_moments_kernel, (int)smem);
  if (err) return err;
  const dim3 grid((B + bB - 1) / bB);
  fused_moments_kernel<<<grid, kThreads, (size_t)smem, static_cast<cudaStream_t>(stream)>>>(
      ch, x, B, params, qparams, scales, mean, std, bB);
  return (int)cudaGetLastError();
}
