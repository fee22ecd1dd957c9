// Fused whole-plan chain for Hopper (sm_90a): fp32 values, products in
// 3xTF32 on the tensor cores (dense_tile.cuh).
//
// Replaces: src/repro/kernels/fused_plan/kernel.py · fused_plan_pallas, both
// modes (moments=False: samples; moments=True: in-kernel Welford moments),
// with the int8 dequant of its _dense (:52-60). The chain is a lowered
// FusedSpec (repro_torch/kernels/fused_plan/ref.py): dense steps (weights
// shared or per sample row, shared and/or per-row bias, fused activation)
// and bare activation steps, run on a T-voxel tile whose activations
// ping-pong between two shared-memory tiles and never reach device memory.
//
// Weights are fp32, or int8 with one bf16 scale per output channel
// (Precision("int8")). The wrapper hands over three buffers as stored: fp32
// (fp32 weights, and every bias — bf16 biases widened once, exactly), int8
// weights, and their bf16 scales.
//
//  * fused_samples_kernel — grid (ceil(B / T), n_rows): one block runs the
//    whole chain for one row over one tile; out [n_rows, B, d_out].
//  * fused_moments_kernel — grid (ceil(B / T), groups): one block runs its
//    group's n_masks rows over one tile. The shared prefix (steps before the
//    first per-row step) runs once a block; then each row's chain updates a
//    running Welford mean/M2 per (voxel, output), held in the registers of
//    the thread that owns that element. At the group's end the block writes
//    mean and sqrt(M2 / n_masks) to columns [g * d_out, (g + 1) * d_out) of
//    mean/std [B, groups * d_out]; the [n_rows, B, d_out] sample tensor is
//    never materialized.
//
// What bounds it: operations. At the dense IVIM plan (width 104, 32 rows =
// 4 groups x 8 masks, K = 52) a 4,096-voxel chunk is 2.14 GFLOP against
// 2.9 MB of traffic (moments mode), ~740 FLOP per byte; the products run
// 3xTF32 (three tf32 products each at 495 TFLOP/s, 165 TFLOP/s of fp32
// products), so the bound is 0.013 ms (0.032 ms at the CUDA cores' 67
// TFLOP/s). int8 weights cut the parameter bytes (1.06 MB -> 0.28 MB) but
// not the FLOPs.
//
// The earlier design (one block per 16-voxel tile walking all 32 rows)
// restaged each row's 33 KB for every 16 voxels (~271 MB of L2 -> shared
// traffic a chunk), ran 256 blocks of one voxel column each with more than
// 128 barriers a block, and gave each thread 4 voxels x 1 column (5 shared
// loads for 4 FMAs) with the 52 -> 1 head on 4 threads. This design:
//  * grid (tile, group): T voxels a block (64 by default: 256 blocks at the
//    chunk), each row's parameters staged once per T voxels (~68 MB a
//    chunk at T = 64, a quarter);
//  * the x tile and each row's parameters land by bulk copies on an
//    mbarrier (dense_tile::stage_bulk; per-thread cp.async where a tensor
//    is not 16-byte aligned), x row-major and then transposed in shared
//    memory; one barrier when a row lands and one after each dense step;
//  * one row slot: the first row lands while the x tile is transposed and
//    the shared prefix runs; a later row lands behind the last barrier of
//    the one before. Two slots (row k + 1 landing while row k computes)
//    cost the dense fp32 block its second residency on an SM and were
//    slower or tied on the card (PERF.md); a second resident block hides
//    the staging instead;
//  * an int8 row is staged as int8 (8.5 KB instead of 33 at the IVIM
//    widths) and widened once a row into a dequant buffer;
//  * every dense step of the body runs on dense_tile.cuh: 3xTF32 on the
//    tensor cores (warp jobs of 16 voxels x 32 columns, k-major activation
//    tiles), and the narrow head as a split-K dot over all threads; the
//    shared prefix, whose weights stay in device memory, on the CUDA-core
//    micro-tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "dense_tile.cuh"
#include "smem_limit.cuh"

namespace {

using namespace dense_tile;

constexpr int kMaxSteps = 32;
constexpr int kThreads = 256;
constexpr int kWel = 4;             // Welford elements a thread: T * d_out <= kWel * kThreads

enum { kDense = 0, kAct = 1 };

// One step. Offsets in elements: b/bp into the fp32 parameter buffer, w
// into the fp32 buffer or, for an int8 weight (w_int8), into the int8
// buffer with its scales at ws in the bf16 one (per-row tensors start at
// row 0). Staged offsets (steps of the body only): sw in floats, into the
// row slot for an fp32 weight ([round8(d_in)][d_out]) or into the dequant
// buffer for an int8 one; sb/sbp in floats into the row slot; sq in bytes
// into the row slot, the int8 weight as stored ([d_in][d_out]). An act step
// has d_in == d_out == the width.
struct Step {
  int kind, act, per_sample, has_b, has_bp, d_in, d_out;
  long long w, b, bp;
  int sw, sb, sbp, sq;
  int w_int8;
  long long ws;
};

struct Chain {
  int n_steps, cut;                 // steps [0, cut) are the shared prefix
  int n_rows, n_masks, groups;
  int d_in, d_out;
  int pfx_rows, buf_rows;           // features of the input tile, of each ping-pong tile
  int slot_floats, deq_floats;      // one row slot; the dequant buffer (int8 chains)
  Step steps[kMaxSteps];
};

constexpr int kHeader = 11;         // layout of the int64 descriptor the wrapper builds
constexpr int kStepFields = 16;

int parse_chain(const long long* d, Chain* ch) {
  ch->n_steps = (int)d[0];
  ch->cut = (int)d[1];
  ch->n_rows = (int)d[2];
  ch->n_masks = (int)d[3];
  ch->groups = (int)d[4];
  ch->d_in = (int)d[5];
  ch->d_out = (int)d[6];
  ch->pfx_rows = (int)d[7];
  ch->buf_rows = (int)d[8];
  ch->slot_floats = (int)d[9];
  ch->deq_floats = (int)d[10];
  if (ch->n_steps < 1 || ch->n_steps > kMaxSteps || ch->cut < 0 || ch->cut > ch->n_steps ||
      ch->slot_floats % 4 || ch->deq_floats % 4)
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
    st.sq = (int)f[13];
    st.w_int8 = (int)f[14];
    st.ws = f[15];
  }
  return 0;
}

// An int8 chain needs both of its buffers.
bool missing_int8_buffers(const Chain& ch, const int8_t* qparams, const __nv_bfloat16* scales) {
  for (int s = 0; s < ch.n_steps; ++s)
    if (ch.steps[s].kind == kDense && ch.steps[s].w_int8 && (!qparams || !scales)) return true;
  return false;
}

// Start the copy of row `row`'s body parameters into `slot`: bulk copies on
// `bar` where aligned (returns their bytes, the same in every thread),
// cp.async otherwise; the caller commits, arrives, waits and holds a
// barrier.
__device__ unsigned stage_row(const Chain& ch, const float* params, const int8_t* qparams,
                              float* slot, int row, uint64_t* bar) {
  unsigned bytes = 0;
  for (int s = ch.cut; s < ch.n_steps; ++s) {
    const Step& st = ch.steps[s];
    if (st.kind != kDense) continue;
    const long long nw = (long long)st.d_in * st.d_out;
    const long long w_at = st.w + (st.per_sample ? row * nw : 0);
    if (st.w_int8) {
      bytes += stage_bulk(reinterpret_cast<char*>(slot) + st.sq, st.d_out, qparams + w_at,
                          st.d_out, st.d_in, st.d_out, 1, bar);
    } else {
      bytes += stage_bulk(slot + st.sw, st.d_out, params + w_at, st.d_out, st.d_in, st.d_out,
                          4, bar);
      zero_rows(slot + st.sw, st.d_out, st.d_in, round8(st.d_in));
    }
    if (st.has_b)
      bytes += stage_bulk(slot + st.sb, st.d_out, params + st.b, st.d_out, 1, st.d_out, 4, bar);
    if (st.has_bp)
      bytes += stage_bulk(slot + st.sbp, st.d_out, params + st.bp + (long long)row * st.d_out,
                          st.d_out, 1, st.d_out, 4, bar);
  }
  return bytes;
}

// Widen row `row`'s staged int8 weights into the dequant buffer; the caller
// holds a barrier before and after.
__device__ void dequant_row(const Chain& ch, const __nv_bfloat16* scales, const float* slot,
                            float* deq, int row) {
  for (int s = ch.cut; s < ch.n_steps; ++s) {
    const Step& st = ch.steps[s];
    if (st.kind != kDense || !st.w_int8) continue;
    const int8_t* q = reinterpret_cast<const int8_t*>(reinterpret_cast<const char*>(slot) + st.sq);
    dequant_rows(deq + st.sw, st.d_out, q, st.d_in, st.d_out,
                 scales + st.ws + (st.per_sample ? (long long)row * st.d_out : 0));
  }
}

// Steps [s0, s1) on tile `in`, ping-ponging between buf0 and buf1; returns
// the tile that holds the result (`in` itself when the range is empty).
// Prefix steps read their parameters from device memory, body steps from
// the staged row (an int8 weight from the dequant buffer). Every step ends
// at a barrier.
__device__ const float* run_steps(const Chain& ch, int s0, int s1, const float* in, float* buf0,
                                  float* buf1, int ldt, int T, const float* params,
                                  const int8_t* qparams, const __nv_bfloat16* scales,
                                  const float* slot, const float* deq) {
  const float* cur = in;
  float* next = buf0;
  for (int s = s0; s < s1; ++s) {
    const Step& st = ch.steps[s];
    if (st.kind == kAct) {
      act_tile(cur, next, ldt, T, st.d_out, st.act);
    } else if (s >= ch.cut) {
      const SmemW w{(st.w_int8 ? deq : slot) + st.sw, st.d_out};
      dense(cur, next, ldt, T, w, st.has_b ? slot + st.sb : nullptr,
            st.has_bp ? slot + st.sbp : nullptr, st.d_in, st.d_out, st.act);
    } else if (st.w_int8) {         // prefix: no per-row bias
      dense(cur, next, ldt, T, GlobalQ{qparams + st.w, scales + st.ws, st.d_out},
            st.has_b ? params + st.b : nullptr, nullptr, st.d_in, st.d_out, st.act);
    } else {
      dense(cur, next, ldt, T, GlobalW{params + st.w, st.d_out},
            st.has_b ? params + st.b : nullptr, nullptr, st.d_in, st.d_out, st.act);
    }
    __syncthreads();
    cur = next;
    next = next == buf0 ? buf1 : buf0;
  }
  return cur;
}

// Runs the shared prefix on the x tile held in `pfx` and parks its result
// back in `pfx`, which the per-row body reads for every row.
__device__ void run_prefix(const Chain& ch, float* pfx, float* buf0, float* buf1, int ldt, int T,
                           const float* params, const int8_t* qparams,
                           const __nv_bfloat16* scales) {
  const float* h = run_steps(ch, 0, ch.cut, pfx, buf0, buf1, ldt, T, params, qparams, scales,
                             nullptr, nullptr);
  if (h == pfx) return;
  // with its zero rows up to the next multiple of 8
  const int w0 = round8(ch.steps[ch.cut - 1].d_out);
  for (int e = threadIdx.x; e < w0 * ldt; e += blockDim.x) pfx[e] = h[e];
  __syncthreads();
}

// Shared memory (floats): kBarFloats of mbarriers (bars[0] the row slot's,
// bars[1] the x tile's) | the row slot | dequant buffer | pfx tile | buf0 |
// buf1, each tile [rows][ldt], ldt = T + kPad.
constexpr int kBarFloats = 8;
struct Smem {
  uint64_t* bars;
  float *slot, *deq, *pfx, *buf0, *buf1;
  __device__ Smem(float* base, const Chain& ch, int ldt) {
    bars = reinterpret_cast<uint64_t*>(base);
    slot = base + kBarFloats;
    deq = slot + ch.slot_floats;
    pfx = deq + ch.deq_floats;
    buf0 = pfx + ch.pfx_rows * ldt;
    buf1 = buf0 + ch.buf_rows * ldt;
  }
};

// Start the x tile: rows [b0, b0 + T) land row-major in buf0..buf1 (a bulk
// copy on bars[1] where aligned) for land_x to transpose into pfx, or, where
// they do not fit there, as 4-byte copies straight into pfx. Thread 0
// arrives on bars[1]; the caller commits.
__device__ bool start_x(const Chain& ch, const Smem& sm, const float* x, int B, int b0, int ldt,
                        int T) {
  const bool rows = T * ch.d_in <= 2 * ch.buf_rows * ldt;
  unsigned bytes = 0;
  if (rows)
    bytes = stage_bulk(sm.buf0, ch.d_in, x + (size_t)b0 * ch.d_in, ch.d_in, min(T, B - b0),
                       ch.d_in, 4, &sm.bars[1]);
  else
    load_x_tile(x, B, ch.d_in, b0, 0, ch.d_in, sm.pfx, ldt, T);
  if (threadIdx.x == 0) mbar_arrive_tx(&sm.bars[1], bytes);
  return rows;
}

// Finish it (after its cp.async group has been waited for): wait for the
// bulk copy, then transpose. Ends at a barrier.
__device__ void land_x(const Chain& ch, const Smem& sm, bool rows, int B, int b0, int ldt, int T) {
  mbar_wait(&sm.bars[1], 0);
  __syncthreads();
  if (rows) {
    transpose_x(sm.buf0, ch.d_in, min(T, B - b0), sm.pfx, ldt, T);
    __syncthreads();
  }
}

__device__ void init_bars(const Smem& sm) {
  if (threadIdx.x == 0)
    for (int i = 0; i < 2; ++i) mbar_init(&sm.bars[i]);
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
fused_samples_kernel(const __grid_constant__ Chain ch, const float* __restrict__ x, int B,
                     const float* __restrict__ params, const int8_t* __restrict__ qparams,
                     const __nv_bfloat16* __restrict__ scales, float* __restrict__ out, int T) {
  extern __shared__ __align__(16) float smem[];
  const int ldt = T + kPad;
  const Smem sm(smem, ch, ldt);
  const int row = blockIdx.y, b0 = blockIdx.x * T;
  init_bars(sm);
  const bool rows = start_x(ch, sm, x, B, b0, ldt, T);
  cp_async_commit();
  const unsigned bytes = stage_row(ch, params, qparams, sm.slot, row, &sm.bars[0]);
  cp_async_commit();                                // the row lands while the prefix runs
  if (threadIdx.x == 0) mbar_arrive_tx(&sm.bars[0], bytes);
  cp_async_wait<1>();
  land_x(ch, sm, rows, B, b0, ldt, T);
  run_prefix(ch, sm.pfx, sm.buf0, sm.buf1, ldt, T, params, qparams, scales);
  cp_async_wait<0>();
  mbar_wait(&sm.bars[0], 0);
  __syncthreads();
  if (ch.deq_floats) {
    dequant_row(ch, scales, sm.slot, sm.deq, row);
    __syncthreads();
  }
  const float* y = run_steps(ch, ch.cut, ch.n_steps, sm.pfx, sm.buf0, sm.buf1, ldt, T, params,
                             qparams, scales, sm.slot, sm.deq);
  float* o = out + (size_t)row * B * ch.d_out;
  for (int e = threadIdx.x; e < T * ch.d_out; e += blockDim.x) {
    const int t = e / ch.d_out, c = e % ch.d_out;
    if (b0 + t < B) o[(size_t)(b0 + t) * ch.d_out + c] = y[c * ldt + t];
  }
}

__global__ void __launch_bounds__(kThreads)
fused_moments_kernel(const __grid_constant__ Chain ch, const float* __restrict__ x, int B,
                     const float* __restrict__ params, const int8_t* __restrict__ qparams,
                     const __nv_bfloat16* __restrict__ scales, float* __restrict__ mean_out,
                     float* __restrict__ std_out, int T) {
  extern __shared__ __align__(16) float smem[];
  const int ldt = T + kPad;
  const Smem sm(smem, ch, ldt);
  const int b0 = blockIdx.x * T, g = blockIdx.y, first = g * ch.n_masks;
  const int d_out = ch.d_out, cols = ch.groups * d_out, n_out = T * d_out;
  init_bars(sm);
  const bool rows = start_x(ch, sm, x, B, b0, ldt, T);
  cp_async_commit();
  unsigned bytes = stage_row(ch, params, qparams, sm.slot, first, &sm.bars[0]);
  cp_async_commit();                                // the first row lands while the prefix runs
  if (threadIdx.x == 0) mbar_arrive_tx(&sm.bars[0], bytes);
  cp_async_wait<1>();
  land_x(ch, sm, rows, B, b0, ldt, T);
  run_prefix(ch, sm.pfx, sm.buf0, sm.buf1, ldt, T, params, qparams, scales);
  float mean[kWel], m2[kWel];
#pragma unroll
  for (int i = 0; i < kWel; ++i) mean[i] = m2[i] = 0.f;
  for (int k = 0; k < ch.n_masks; ++k) {
    // Every reader of the slot finished before the last barrier of row
    // k - 1. The slot's mbarrier completes one phase a row.
    if (k > 0) {
      bytes = stage_row(ch, params, qparams, sm.slot, first + k, &sm.bars[0]);
      cp_async_commit();
      if (threadIdx.x == 0) mbar_arrive_tx(&sm.bars[0], bytes);
    }
    cp_async_wait<0>();
    mbar_wait(&sm.bars[0], k & 1);
    __syncthreads();
    if (ch.deq_floats) {
      dequant_row(ch, scales, sm.slot, sm.deq, first + k);
      __syncthreads();
    }
    const float* y = run_steps(ch, ch.cut, ch.n_steps, sm.pfx, sm.buf0, sm.buf1, ldt, T,
                               params, qparams, scales, sm.slot, sm.deq);
    // Running Welford over the group's masks: element e = (column c, voxel
    // t) stays with thread e % blockDim.x for the whole group.
#pragma unroll
    for (int i = 0; i < kWel; ++i) {
      const int e = threadIdx.x + i * blockDim.x;
      if (e < n_out) {
        const int c = e / T, t = e % T;
        const float v = y[c * ldt + t];
        if (k == 0) {
          mean[i] = v;
          m2[i] = 0.f;
        } else {
          const float delta = v - mean[i];
          mean[i] += delta / (float)(k + 1);
          m2[i] += delta * (v - mean[i]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kWel; ++i) {
    const int e = threadIdx.x + i * blockDim.x;
    if (e < n_out) {
      const int c = e / T, t = e % T;
      if (b0 + t < B) {
        const size_t at = (size_t)(b0 + t) * cols + g * d_out + c;
        mean_out[at] = mean[i];
        std_out[at] = sqrtf(m2[i] / (float)ch.n_masks);
      }
    }
  }
}

// T: a multiple of 4 (of 16 for the tensor-core path), at most 128.
bool bad_tile(int T) { return T < 4 || T > 128 || T % 4; }

}  // namespace

// Both entries: desc is the host int64 chain descriptor, T the voxels a
// block, smem the dynamic shared-memory bytes the wrapper computed (its
// residency guard has already held them to the 227 KB a block may opt
// into); qparams and scales are the int8 weights and their bf16 scales
// (null for an fp32 chain). Each launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int fused_samples_launch(const long long* desc, const float* x, int B,
                                    const float* params, const int8_t* qparams,
                                    const __nv_bfloat16* scales, float* out, int T,
                                    long long smem, void* stream) {
  Chain ch;
  int err = parse_chain(desc, &ch);
  if (err) return err;
  if (B < 1 || bad_tile(T) || ch.n_rows < 1 || ch.n_rows > 65535 ||
      missing_int8_buffers(ch, qparams, scales))
    return (int)cudaErrorInvalidValue;
  static SmemLimit limit;                  // the attribute is set once a device
  err = (int)limit.raise((const void*)fused_samples_kernel, (int)smem);
  if (err) return err;
  const dim3 grid((B + T - 1) / T, ch.n_rows);
  fused_samples_kernel<<<grid, kThreads, (size_t)smem, static_cast<cudaStream_t>(stream)>>>(
      ch, x, B, params, qparams, scales, out, T);
  return (int)cudaGetLastError();
}

extern "C" int fused_moments_launch(const long long* desc, const float* x, int B,
                                    const float* params, const int8_t* qparams,
                                    const __nv_bfloat16* scales, float* mean, float* std,
                                    int T, long long smem, void* stream) {
  Chain ch;
  int err = parse_chain(desc, &ch);
  if (err) return err;
  if (B < 1 || bad_tile(T) || ch.n_masks < 1 ||
      ch.groups < 1 || ch.groups > 65535 || T * ch.d_out > kWel * kThreads ||
      missing_int8_buffers(ch, qparams, scales))
    return (int)cudaErrorInvalidValue;
  static SmemLimit limit;
  err = (int)limit.raise((const void*)fused_moments_kernel, (int)smem);
  if (err) return err;
  const dim3 grid((B + T - 1) / T, ch.groups);
  fused_moments_kernel<<<grid, kThreads, (size_t)smem, static_cast<cudaStream_t>(stream)>>>(
      ch, x, B, params, qparams, scales, mean, std, T);
  return (int)cudaGetLastError();
}
