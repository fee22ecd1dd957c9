// One serving decode step of a dense transformer's mask-expanded slot pool,
// in one cooperative launch (sm_90a).
//
// Replaces src/repro/kernels/fused_plan/kernel.py:260 (fused_decode_pallas,
// pallas_call :324). The TPU kernel was one program with no grid and the
// whole pool resident in VMEM (weights, caches, residual). At full width
// the model is gigabytes, so here the step is a persistent grid: every
// block stays resident (cudaLaunchCooperativeKernel, grid sized by the
// occupancy calculator) and the stages of the chain are separated by grid
// barriers (cooperative_groups::this_grid().sync()):
//
//   per layer:  norm1 | q/k/v GEMV | attention | wo GEMV (+= residual) |
//               norm2 | gate/up GEMV | hidden (act * up * mask) |
//               down GEMV (+= residual)
//   then:       final norm | LM head GEMV | row max + log-sum-exp |
//               Welford over the mask groups | argmax + rel-unc
//
// What bounds it: one step must read every weight once (a 1.5 B-parameter
// model is 3.1 GB in bf16, ~0.97 ms at 3.35 TB/s) and do 2 x rows FLOPs per
// weight (~99.7 GFLOP at 32 rows, ~1.5 ms at the 67 TFLOP/s of fp32 CUDA
// cores): operations bound it at fp32 arithmetic, so the GEMV stages are
// built to keep the FMA pipes busy while each weight is read once per step
// for ALL rows.
//
// A GEMV stage computes out[rows, N] (+)= in[rows, K] @ W[K, N] for every
// job of the stage (q/k/v are three jobs; packed FFN weights one job per
// mask over that mask's rows). A block task is a tile of 64 x P columns
// over a slice of K; its 8 warps split into P column groups of 64 (a lane
// owns columns n and n + 32) and 8 / P warps that interleave over the
// slice's 8-deep chunks. A warp stages its chunk of every row's input in
// shared memory and keeps the rows' partial sums in registers, so one
// broadcast 16-byte shared load feeds 8 FMAs and a weight element, read
// once, feeds one FMA per row. Warps sharing columns sum through shared
// memory; the block adds its tile to the output with one atomic per element
// (slices of K meet there; outputs are zeroed, or the residual, first).
// The host picks P and the K split per stage so the tasks fill the grid in
// the fewest waves (choose_split).
//
// Attention is one block per (row, query head) whose warps split the
// row's cache slots, each with an online softmax over coalesced k/v rows;
// masked slots score -inf, the fresh k/v are appended, and the warps'
// partial softmax states are combined in shared memory. Norms are one
// block per row. Inter-stage activations and the
// [rows, vocab] logits live in a workspace in device memory (the TPU kept
// them in VMEM); they are read back through L2 (__ldcg), never through the
// non-coherent L1. Block 0 stamps %globaltimer after every barrier, so the
// wrapper can report where a step's time goes.
//
// Contract (kernels/fused_plan/ref.py fused_decode_ref): caches read-only;
// the fresh post-RoPE k and v come back per layer for the caller to commit;
// fp32 arithmetic throughout; weights, x and k/v outputs in the storage
// type TW (float or bf16, upcast exactly), caches in TC.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "smem_limit.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// Two blocks (16 warps) per SM: at the 128 registers a thread then gets, a
// GEMV warp's 64 partial sums spill a little, yet on the H100 this ran
// faster than one block per SM without spills (fewer warps hide less of
// the loads' latency).
constexpr int MIN_BLOCKS = 2;
constexpr int KC = 8;          // reduction-axis chunk a GEMV warp stages
constexpr int RT = 32;         // rows a GEMV warp holds in registers
constexpr int TN = 64;         // columns of a GEMV warp (lane: n, n + 32)
constexpr int MAX_DH = 256;
// shared floats: GEMV staging [WARPS][RT][KC] + reduction [4][RT][TN]
// (P <= 4 column groups reduce; P = 8 has one warp per group), or the
// attention's q / fresh k / fresh v and the warps' partial softmax states
constexpr int GEMV_SMEM = WARPS * RT * KC + 4 * RT * TN;
constexpr int ATTN_SMEM = 3 * MAX_DH + 2 * WARPS + WARPS * MAX_DH;
constexpr int SMEM_BYTES =
    4 * (GEMV_SMEM > ATTN_SMEM ? GEMV_SMEM : ATTN_SMEM);

// per-layer pointer table (int64 each), filled by kernels/fused_decode/ops.py
enum {
  LP_N1S, LP_N1B, LP_WQ, LP_BQ, LP_WK, LP_BK, LP_WV, LP_BV, LP_WO,
  LP_N2S, LP_N2B, LP_WG, LP_WU, LP_BU, LP_WD, LP_BD, LP_MASK,
  LP_KC, LP_VC, LP_KPOS, LP_WINDOW, LP_SMAX, LP_COUNT
};

// activation codes: kernels/fused_decode/ops.py _ACT_CODES
enum { ACT_ID = 0, ACT_RELU, ACT_GELU, ACT_SILU, ACT_SIGMOID, ACT_TANH };

// stages that run a batch of GEMV jobs
enum { J_QKV = 0, J_WO, J_GU, J_DOWN, J_HEAD, J_KINDS };

struct Split {                      // how a GEMV stage covers the grid
  int p;                            // 64-column groups per block task
  int ks;                           // slices of the reduction axis
  int cps;                          // KC-chunks per slice
  int tasks;                        // column tiles x ks
};

struct Args {
  int R, d, H, Hkv, dh, rot, F, V, L, nsamp, npk;
  int layernorm, gated, masked, packed, ffn_bias, qkv_bias, act;
  float eps;
  const void* x;
  const int* pos;
  const float* cos;
  const float* sin;
  const long long* layers;          // [L, LP_COUNT]
  const void* fns;
  const void* fnb;
  const void* head;                 // [d, V]
  float* mean_out;                  // [b, V]
  float* rel_out;                   // [b]
  void* knew;                       // [L, R, Hkv, dh]
  void* vnew;
  float* resid;                     // [R, d]
  float* hn;                        // [R, d]
  float* qkv;                       // [R, (H + 2 Hkv) dh]
  float* att;                       // [R, H dh]
  float* gu;                        // [R, 2F]  gate | up
  float* mid;                       // [R, F]
  float* logits;                    // [R, V]
  float* rowmax;                    // [R]
  float* rowlse;                    // [R]
  float* stdv;                      // [b, V]
  unsigned long long* stamps;       // [2 + 8 L + 4] barrier times, ns
  Split split[J_KINDS];
};

struct Job {                        // out[r, col0 + n] += sum_k in[r, k] w[k, n]
  const void* w;
  const void* bias;                 // added once (by slice 0), may be null
  int K, N;
  const float* in;
  int ld_in;
  int row0, nrows;
  float* out;
  int ld_out, col0;
};

__device__ __forceinline__ float ld(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float ld(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, long long i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void st(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16(v);
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ float activate(int code, float x) {
  switch (code) {
    case ACT_RELU: return fmaxf(x, 0.f);
    case ACT_GELU: {               // tanh form (jax.nn.gelu's default)
      const float c = 0.7978845608028654f;
      return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
    }
    case ACT_SILU: return x / (1.f + expf(-x));
    case ACT_SIGMOID: return 1.f / (1.f + expf(-x));
    case ACT_TANH: return tanhf(x);
    default: return x;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ long long lp_at(const Args& a, int layer, int s) {
  return a.layers[(long long)layer * LP_COUNT + s];
}

__device__ __forceinline__ int floor_mod(int x, int m) {
  int r = x % m;
  return r < 0 ? r + m : r;
}

// ---- GEMV jobs of each stage ----------------------------------------------

__host__ __device__ int n_jobs(const Args& a, int kind) {
  switch (kind) {
    case J_QKV: return 3;
    case J_GU: return (a.gated ? 2 : 1) * (a.packed ? a.npk : 1);
    case J_DOWN: return a.packed ? a.npk : 1;
    default: return 1;
  }
}

// Reduction depth and the output width of job `idx` of a stage: the only
// job fields the host's split choice needs.
__host__ __device__ void job_shape(const Args& a, int kind, int idx, int* K,
                                   int* N) {
  const int qw = a.H * a.dh, kw = a.Hkv * a.dh;
  switch (kind) {
    case J_QKV: *K = a.d; *N = idx == 0 ? qw : kw; break;
    case J_WO: *K = qw; *N = a.d; break;
    case J_GU: *K = a.d; *N = a.F; break;
    case J_DOWN: *K = a.F; *N = a.d; break;
    default: *K = a.d; *N = a.V; break;
  }
}

template <class TW>
__device__ Job job_at(const Args& a, int layer, int kind, int idx) {
  Job j;
  j.bias = nullptr;
  j.row0 = 0;
  j.nrows = a.R;
  j.col0 = 0;
  job_shape(a, kind, idx, &j.K, &j.N);
  const int qw = a.H * a.dh, kw = a.Hkv * a.dh;
  if (kind == J_QKV) {
    const int wslot = idx == 0 ? LP_WQ : idx == 1 ? LP_WK : LP_WV;
    const int bslot = idx == 0 ? LP_BQ : idx == 1 ? LP_BK : LP_BV;
    j.w = (const void*)lp_at(a, layer, wslot);
    if (a.qkv_bias) j.bias = (const void*)lp_at(a, layer, bslot);
    j.in = a.hn;
    j.ld_in = a.d;
    j.out = a.qkv;
    j.ld_out = qw + 2 * kw;
    j.col0 = idx == 0 ? 0 : idx == 1 ? qw : qw + kw;
  } else if (kind == J_WO) {
    j.w = (const void*)lp_at(a, layer, LP_WO);
    j.in = a.att;
    j.ld_in = qw;
    j.out = a.resid;
    j.ld_out = a.d;
  } else if (kind == J_GU) {
    const int mats = a.gated ? 2 : 1;
    const int m = idx / mats;
    const bool up = !a.gated || (idx % mats) == 1;
    const TW* w = (const TW*)lp_at(a, layer, up ? LP_WU : LP_WG);
    if (a.packed) {
      const int bpk = a.R / a.npk;
      w += (long long)m * a.d * a.F;
      j.row0 = m * bpk;
      j.nrows = bpk;
    } else if (up && a.ffn_bias) {
      j.bias = (const void*)lp_at(a, layer, LP_BU);
    }
    j.w = w;
    j.in = a.hn;
    j.ld_in = a.d;
    j.out = a.gu;
    j.ld_out = 2 * a.F;
    j.col0 = up ? a.F : 0;
  } else if (kind == J_DOWN) {
    const TW* w = (const TW*)lp_at(a, layer, LP_WD);
    if (a.packed) {
      const int bpk = a.R / a.npk;
      w += (long long)idx * a.F * a.d;
      j.row0 = idx * bpk;
      j.nrows = bpk;
    } else if (a.ffn_bias) {
      j.bias = (const void*)lp_at(a, layer, LP_BD);
    }
    j.w = w;
    j.in = a.mid;
    j.ld_in = a.F;
    j.out = a.resid;
    j.ld_out = a.d;
  } else {                          // J_HEAD
    j.w = a.head;
    j.in = a.hn;
    j.ld_in = a.d;
    j.out = a.logits;
    j.ld_out = a.V;
  }
  return j;
}

// One warp's share of a block task for rows [r0, r0 + nr) (nr <= NR):
// columns n and n + 32 of its 64-column group, chunks c_begin + kl,
// c_begin + kl + kw, ... below c_end. With `red` the partial sums go to the
// block's shared tile; without, the warp owns its columns' whole slice and
// adds them to the output itself (with the bias if `bias_on`).
template <class TW, int NR>
__device__ void warp_rows(const Job& j, int r0, int nr, int n0, int c_begin,
                          int c_end, int kl, int kw, float* s_in, float* red,
                          bool bias_on, int lane) {
  float acc0[NR], acc1[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) acc0[r] = acc1[r] = 0.f;
  const int n1 = n0 + 32;
  const bool ok0 = n0 < j.N, ok1 = n1 < j.N;
  const TW* w = (const TW*)j.w;
  for (int c = c_begin + kl; c < c_end; c += kw) {
    const int k0 = c * KC;
    const int kc = min(KC, j.K - k0);
    __syncwarp();                   // the last chunk's reads are done
#pragma unroll
    for (int i = 0; i < NR * KC / 32; ++i) {
      const int e = lane + 32 * i, r = e / KC, kk = e % KC;
      s_in[e] = (r < nr && kk < kc)
                    ? __ldcg(j.in + (long long)(j.row0 + r0 + r) * j.ld_in
                             + k0 + kk)
                    : 0.f;
    }
    float w0[KC], w1[KC];
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      const long long base = (long long)(k0 + kk) * j.N;
      w0[kk] = (kk < kc && ok0) ? ld(w, base + n0) : 0.f;
      w1[kk] = (kk < kc && ok1) ? ld(w, base + n1) : 0.f;
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < NR; ++r) {
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        const float xv = s_in[r * KC + kk];
        acc0[r] = fmaf(xv, w0[kk], acc0[r]);
        acc1[r] = fmaf(xv, w1[kk], acc1[r]);
      }
    }
  }
  if (red) {
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      if (r < nr) {
        atomicAdd(red + r * TN + lane, acc0[r]);
        atomicAdd(red + r * TN + lane + 32, acc1[r]);
      }
    }
    return;
  }
  const TW* bias = (const TW*)j.bias;
  const float b0 = (bias_on && ok0) ? ld(bias, n0) : 0.f;
  const float b1 = (bias_on && ok1) ? ld(bias, n1) : 0.f;
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    if (r < nr) {
      float* o = j.out + (long long)(j.row0 + r0 + r) * j.ld_out + j.col0;
      if (ok0) atomicAdd(o + n0, acc0[r] + b0);
      if (ok1) atomicAdd(o + n1, acc1[r] + b1);
    }
  }
}

template <class TW>
__device__ void gemv_stage(const Args& a, int layer, int kind, float* smem,
                           int warp, int lane) {
  const Split sp = a.split[kind];
  const int kw = WARPS / sp.p, group = warp % sp.p, kl = warp / sp.p;
  const int tile_cols = TN * sp.p;
  float* s_in = smem + warp * RT * KC;
  float* red_all = kw > 1 ? smem + WARPS * RT * KC : nullptr;
  float* red = red_all ? red_all + group * RT * TN : nullptr;
  const int red_n = sp.p * RT * TN;
  if (red_all) {
    for (int i = threadIdx.x; i < red_n; i += THREADS) red_all[i] = 0.f;
    __syncthreads();
  }
  const int nj = n_jobs(a, kind);
  for (int task = blockIdx.x; task < sp.tasks; task += gridDim.x) {
    int tile = task / sp.ks;
    const int slice = task % sp.ks;
    int ji = 0;
    Job j = job_at<TW>(a, layer, kind, 0);
    for (int nt = (j.N + tile_cols - 1) / tile_cols; tile >= nt && ji + 1 < nj;
         nt = (j.N + tile_cols - 1) / tile_cols) {
      tile -= nt;
      j = job_at<TW>(a, layer, kind, ++ji);
    }
    const int kchunks = (j.K + KC - 1) / KC;
    const int c_begin = slice * sp.cps;
    const int c_end = min(kchunks, c_begin + sp.cps);
    const int col_base = tile * tile_cols;
    const int n0 = col_base + group * TN + lane;
    const bool bias_on = slice == 0 && j.bias;
    for (int r0 = 0; r0 < j.nrows; r0 += RT) {
      const int nr = min(RT, j.nrows - r0);
      if (nr <= 8)
        warp_rows<TW, 8>(j, r0, nr, n0, c_begin, c_end, kl, kw, s_in, red,
                         bias_on, lane);
      else
        warp_rows<TW, RT>(j, r0, nr, n0, c_begin, c_end, kl, kw, s_in, red,
                          bias_on, lane);
      if (red_all) {                // sum the column groups' warps, flush
        __syncthreads();
        const TW* bias = (const TW*)j.bias;
        for (int i = threadIdx.x; i < red_n; i += THREADS) {
          const int g = i / (RT * TN), r = (i / TN) % RT;
          const int col = col_base + g * TN + i % TN;
          const float v = red_all[i];
          red_all[i] = 0.f;
          if (r < nr && col < j.N)
            atomicAdd(j.out + (long long)(j.row0 + r0 + r) * j.ld_out
                          + j.col0 + col,
                      v + (bias_on ? ld(bias, col) : 0.f));
        }
        __syncthreads();
      }
    }
  }
}

// ---- norms (one block per row) --------------------------------------------

__device__ float block_reduce(float v, bool is_max, float* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  v = is_max ? warp_max(v) : warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float out = red[0];
  for (int w = 1; w < WARPS; ++w)
    out = is_max ? fmaxf(out, red[w]) : out + red[w];
  return out;
}

// dst = norm(src) with src the residual (or x, which layer 0 first copies
// into the residual). Also zeroes `zero_n` floats at `zero` (grid-stride).
template <class TW>
__device__ void norm_stage(const Args& a, bool from_x, const void* scale_p,
                           const void* bias_p, float* dst, float* zero,
                           long long zero_n, float* zero2, long long zero2_n,
                           float* red) {
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long nthr = (long long)gridDim.x * THREADS;
  for (long long i = tid; i < zero_n; i += nthr) zero[i] = 0.f;
  for (long long i = tid; i < zero2_n; i += nthr) zero2[i] = 0.f;
  const TW* x = (const TW*)a.x;
  const TW* scale = (const TW*)scale_p;
  const TW* bias = (const TW*)bias_p;
  const int d = a.d;
  for (int r = blockIdx.x; r < a.R; r += gridDim.x) {
    const long long base = (long long)r * d;
    float s = 0.f;
    for (int c = threadIdx.x; c < d; c += THREADS) {
      const float v = from_x ? ld(x, base + c) : __ldcg(a.resid + base + c);
      if (from_x) a.resid[base + c] = v;
      s += v;
    }
    const float mean = block_reduce(s, false, red) / d;
    float ss = 0.f;                 // centered for layernorm, as jnp.var
    for (int c = threadIdx.x; c < d; c += THREADS) {
      const float v = from_x ? ld(x, base + c) : __ldcg(a.resid + base + c);
      const float dv = a.layernorm ? v - mean : v;
      ss += dv * dv;
    }
    const float inv = rsqrtf(block_reduce(ss, false, red) / d + a.eps);
    for (int c = threadIdx.x; c < d; c += THREADS) {
      const float v = from_x ? ld(x, base + c) : __ldcg(a.resid + base + c);
      float y = (a.layernorm ? v - mean : v) * inv * ld(scale, c);
      if (a.layernorm) y += ld(bias, c);
      dst[base + c] = y;
    }
  }
}

// ---- attention (one block per (row, query head)) --------------------------

// The block's warps split the row's cache slots, each keeping an online
// softmax over its slots with DR head dims per lane (dh <= 32 DR) and k/v
// rows read coalesced, four slots in flight; warp 0 adds the fresh key.
// The warps' (max, sum, acc) are then combined in shared memory.
template <class TW, class TC, int DR>
__device__ void attn_stage(const Args& a, int layer, float* sm, int warp,
                           int lane) {
  const int H = a.H, Hkv = a.Hkv, dh = a.dh, G = H / Hkv;
  const int half = a.rot / 2;
  const long long Nq = (long long)(H + 2 * Hkv) * dh;
  const TC* kc = (const TC*)lp_at(a, layer, LP_KC);
  const TC* vc = (const TC*)lp_at(a, layer, LP_VC);
  const int* kpos = (const int*)lp_at(a, layer, LP_KPOS);
  const int window = (int)lp_at(a, layer, LP_WINDOW);
  const int S = (int)lp_at(a, layer, LP_SMAX);
  const float scale = rsqrtf((float)dh);
  float* sq = sm;                   // rotated q
  float* sk = sq + MAX_DH;          // fresh k (rotated) and v
  float* sv = sk + MAX_DH;
  float* wm = sv + MAX_DH;          // per warp: running max, sum, acc
  float* wl = wm + WARPS;
  float* wacc = wl + WARPS;
  for (int task = blockIdx.x; task < a.R * H; task += gridDim.x) {
    const int r = task / H, h = task % H, j = h / G;
    const int p = a.pos[r];
    const float* row = a.qkv + (long long)r * Nq;
    const float* qh = row + (long long)h * dh;
    const float* kh = row + (long long)H * dh + (long long)j * dh;
    const float* vh = row + (long long)(H + Hkv) * dh + (long long)j * dh;
    __syncthreads();                // the last task's reads are done
    for (int c = threadIdx.x; c < dh; c += THREADS) {
      float q = __ldcg(qh + c), k = __ldcg(kh + c);
      if (c < a.rot) {              // split-half RoPE on the leading rot lanes
        const int i = c < half ? c : c - half;
        const float cs = a.cos[(long long)r * half + i];
        const float sn = a.sin[(long long)r * half + i];
        if (c < half) {
          q = q * cs - __ldcg(qh + c + half) * sn;
          k = k * cs - __ldcg(kh + c + half) * sn;
        } else {
          q = __ldcg(qh + i) * sn + q * cs;
          k = __ldcg(kh + i) * sn + k * cs;
        }
      }
      sq[c] = q;
      sk[c] = k;
      sv[c] = __ldcg(vh + c);
    }
    __syncthreads();
    if (h % G == 0) {               // the fresh k/v, for the caller's commit
      const long long o = (((long long)layer * a.R + r) * Hkv + j) * dh;
      for (int c = threadIdx.x; c < dh; c += THREADS) {
        st((TW*)a.knew, o + c, sk[c]);
        st((TW*)a.vnew, o + c, sv[c]);
      }
    }
    float q[DR], acc[DR];
#pragma unroll
    for (int t = 0; t < DR; ++t) {
      const int c = lane + 32 * t;
      q[t] = c < dh ? sq[c] : 0.f;
      acc[t] = 0.f;
    }
    const int slot = floor_mod(window ? floor_mod(p, window) : p, S);
    const long long cbase = ((long long)r * Hkv + j) * S;
    float m = -INFINITY, l = 0.f;
    for (int s0 = warp; s0 < S; s0 += 4 * WARPS) {   // the cache's slots
      float kr[4][DR], vr[4][DR], sc[4];
      bool ok[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int s = s0 + u * WARPS;
        const int kp = s < S ? kpos[(long long)r * S + s] : -1;
        ok[u] = kp >= 0 && kp <= p && s != slot;
        const long long at = (cbase + min(s, S - 1)) * dh;
#pragma unroll
        for (int t = 0; t < DR; ++t) {
          const int c = lane + 32 * t;
          kr[u][t] = (c < dh && s < S) ? ld(kc + at, c) : 0.f;
          vr[u][t] = (c < dh && s < S) ? ld(vc + at, c) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float part = 0.f;
#pragma unroll
        for (int t = 0; t < DR; ++t) part = fmaf(q[t], kr[u][t], part);
        const float dot = warp_sum(part);
        sc[u] = ok[u] ? dot * scale : -INFINITY;
      }
      const float m_new =
          fmaxf(fmaxf(m, fmaxf(sc[0], sc[1])), fmaxf(sc[2], sc[3]));
      if (m_new == -INFINITY) continue;            // nothing valid yet
      const float corr = expf(m - m_new);          // 0 while m is -inf
      float e[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) e[u] = ok[u] ? expf(sc[u] - m_new) : 0.f;
      l = l * corr + ((e[0] + e[1]) + (e[2] + e[3]));
#pragma unroll
      for (int t = 0; t < DR; ++t) {
        float v = acc[t] * corr;
#pragma unroll
        for (int u = 0; u < 4; ++u) v = fmaf(e[u], vr[u][t], v);
        acc[t] = v;
      }
      m = m_new;
    }
    if (warp == 0) {                // the fresh key, in warp 0's state
      float part = 0.f;
#pragma unroll
      for (int t = 0; t < DR; ++t) {
        const int c = lane + 32 * t;
        if (c < dh) part = fmaf(q[t], sk[c], part);
      }
      const float sc = warp_sum(part) * scale;
      const float m_new = fmaxf(m, sc);
      const float corr = expf(m - m_new);
      const float e = expf(sc - m_new);
      l = l * corr + e;
#pragma unroll
      for (int t = 0; t < DR; ++t) {
        const int c = lane + 32 * t;
        acc[t] = fmaf(e, c < dh ? sv[c] : 0.f, acc[t] * corr);
      }
      m = m_new;
    }
    if (lane == 0) {
      wm[warp] = m;
      wl[warp] = l;
    }
#pragma unroll
    for (int t = 0; t < DR; ++t) {
      const int c = lane + 32 * t;
      if (c < dh) wacc[warp * MAX_DH + c] = acc[t];
    }
    __syncthreads();
    float mx = -INFINITY;
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, wm[w]);
    for (int c = threadIdx.x; c < dh; c += THREADS) {
      float sum = 0.f, o = 0.f;
      for (int w = 0; w < WARPS; ++w) {
        if (wm[w] == -INFINITY) continue;          // the warp saw no slot
        const float e = expf(wm[w] - mx);
        sum += wl[w] * e;
        o += wacc[w * MAX_DH + c] * e;
      }
      a.att[(long long)r * H * dh + (long long)h * dh + c] = o / sum;
    }
  }
}

// ---- FFN hidden units: act(gate) * up [* mask] -------------------------------

template <class TW>
__device__ void hidden_stage(const Args& a, int layer) {
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long nthr = (long long)gridDim.x * THREADS;
  const long long total = (long long)a.R * a.F;
  const TW* mask = (const TW*)lp_at(a, layer, LP_MASK);
  for (long long i = tid; i < total; i += nthr) {
    const long long r = i / a.F, c = i % a.F;
    const float* g = a.gu + r * 2 * a.F;
    const float up = __ldcg(g + a.F + c);
    float v = a.gated ? activate(a.act, __ldcg(g + c)) * up
                      : activate(a.act, up);
    if (a.masked) v *= ld(mask, i);
    a.mid[i] = v;
  }
}

// ---- posterior epilogue ------------------------------------------------------

__device__ void lse_stage(const Args& a, float* red) {
  for (int r = blockIdx.x; r < a.R; r += gridDim.x) {
    const float* row = a.logits + (long long)r * a.V;
    float mx = -INFINITY;
    for (int c = threadIdx.x; c < a.V; c += THREADS)
      mx = fmaxf(mx, __ldcg(row + c));
    mx = block_reduce(mx, true, red);
    float s = 0.f;
    for (int c = threadIdx.x; c < a.V; c += THREADS)
      s += expf(__ldcg(row + c) - mx);
    s = block_reduce(s, false, red);
    if (threadIdx.x == 0) {
      a.rowmax[r] = mx;
      a.rowlse[r] = logf(s);
    }
  }
}

__device__ void welford_stage(const Args& a) {
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long nthr = (long long)gridDim.x * THREADS;
  const int b = a.R / a.nsamp;
  const long long total = (long long)b * a.V;
  for (long long i = tid; i < total; i += nthr) {
    const long long jcol = i / a.V, v = i % a.V;
    float mean = 0.f, m2 = 0.f;
    for (int k = 0; k < a.nsamp; ++k) {
      const long long row = k * b + jcol;
      const float y = (__ldcg(a.logits + row * a.V + v) - __ldcg(a.rowmax + row))
                      - __ldcg(a.rowlse + row);
      if (k == 0) {
        mean = y;
      } else {
        const float delta = y - mean;
        mean += delta / (k + 1);
        m2 += delta * (y - mean);
      }
    }
    a.mean_out[i] = mean;
    a.stdv[i] = sqrtf(m2 / a.nsamp);
  }
}

__device__ void argmax_stage(const Args& a, float* red) {
  int* redi = (int*)(red + WARPS);
  const int b = a.R / a.nsamp;
  for (int jcol = blockIdx.x; jcol < b; jcol += gridDim.x) {
    const float* row = a.mean_out + (long long)jcol * a.V;
    float best = -INFINITY;
    int bi = 0x7fffffff;
    for (int c = threadIdx.x; c < a.V; c += THREADS) {
      const float v = __ldcg(row + c);
      if (v > best || (v == best && c < bi)) {
        best = v;
        bi = c;
      }
    }
    for (int o = 16; o > 0; o >>= 1) {             // first index of the max
      const float ov = __shfl_xor_sync(0xffffffffu, best, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (ov > best || (ov == best && oi < bi)) {
        best = ov;
        bi = oi;
      }
    }
    __syncthreads();
    if (threadIdx.x % 32 == 0) {
      red[threadIdx.x / 32] = best;
      redi[threadIdx.x / 32] = bi;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < WARPS; ++w)
        if (red[w] > best || (red[w] == best && redi[w] < bi)) {
          best = red[w];
          bi = redi[w];
        }
      const long long o = (long long)jcol * a.V + bi;
      a.rel_out[jcol] = __ldcg(a.stdv + o) / fmaxf(fabsf(__ldcg(a.mean_out + o)),
                                                   1e-12f);
    }
  }
}

// ---- the step ----------------------------------------------------------------

template <class TW, class TC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
fused_decode_kernel(const Args a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool stamp = a.stamps && blockIdx.x == 0 && threadIdx.x == 0;
  int si = 0;
  auto sync = [&]() {
    grid.sync();
    if (stamp) a.stamps[si++] = now_ns();
  };
  if (stamp) a.stamps[si++] = now_ns();
  const long long qkv_n = (long long)a.R * (a.H + 2 * a.Hkv) * a.dh;
  const long long gu_n = (long long)a.R * 2 * a.F;
  for (int l = 0; l < a.L; ++l) {
    norm_stage<TW>(a, l == 0, (const void*)lp_at(a, l, LP_N1S),
                   (const void*)lp_at(a, l, LP_N1B), a.hn, a.qkv, qkv_n,
                   a.gu, gu_n, smem);
    sync();
    gemv_stage<TW>(a, l, J_QKV, smem, warp, lane);
    sync();
    switch ((a.dh + 31) / 32) {     // head dims per lane
      case 1: attn_stage<TW, TC, 1>(a, l, smem, warp, lane); break;
      case 2: attn_stage<TW, TC, 2>(a, l, smem, warp, lane); break;
      case 3:
      case 4: attn_stage<TW, TC, 4>(a, l, smem, warp, lane); break;
      default: attn_stage<TW, TC, 8>(a, l, smem, warp, lane); break;
    }
    sync();
    gemv_stage<TW>(a, l, J_WO, smem, warp, lane);
    sync();
    norm_stage<TW>(a, false, (const void*)lp_at(a, l, LP_N2S),
                   (const void*)lp_at(a, l, LP_N2B), a.hn, nullptr, 0,
                   nullptr, 0, smem);
    sync();
    gemv_stage<TW>(a, l, J_GU, smem, warp, lane);
    sync();
    hidden_stage<TW>(a, l);
    sync();
    gemv_stage<TW>(a, l, J_DOWN, smem, warp, lane);
    sync();
  }
  norm_stage<TW>(a, false, a.fns, a.fnb, a.hn, a.logits,
                 (long long)a.R * a.V, nullptr, 0, smem);
  sync();
  gemv_stage<TW>(a, 0, J_HEAD, smem, warp, lane);
  sync();
  lse_stage(a, smem);
  sync();
  welford_stage(a);
  sync();
  argmax_stage(a, smem);
  if (stamp) a.stamps[si++] = now_ns();   // block 0's share of the last stage
}

// Pick P (64-column groups per block task) and the K split of one GEMV
// stage: fewest waves of tasks over the grid times the chunks the busiest
// warp walks (+1 for the block's reduction and atomics); ties go to fewer
// slices, i.e. fewer atomics.
Split choose_split(const Args& a, int kind, int grid) {
  Split best = {1, 1, 1, 0};
  long long best_cost = -1;
  const int nj = n_jobs(a, kind);
  int K = 1, N = 1;
  job_shape(a, kind, 0, &K, &N);
  const int kchunks = (K + KC - 1) / KC;
  for (int p = 1; p <= WARPS; p *= 2) {
    long long tiles = 0;
    for (int i = 0; i < nj; ++i) {
      job_shape(a, kind, i, &K, &N);
      tiles += (N + TN * p - 1) / (TN * p);
    }
    const int kw = WARPS / p;
    for (int ks = 1; ks <= kchunks; ++ks) {
      const int cps = (kchunks + ks - 1) / ks;
      if ((long long)(ks - 1) * cps >= kchunks) continue;   // empty slice
      const long long waves = (tiles * ks + grid - 1) / grid;
      const long long cost = waves * ((cps + kw - 1) / kw + 1);
      if (best_cost < 0 || cost < best_cost) {
        best_cost = cost;
        best = {p, ks, cps, (int)(tiles * ks)};
      }
    }
  }
  return best;
}

template <class TW, class TC>
int launch(Args a, cudaStream_t stream, int* grid_out) {
  auto kernel = fused_decode_kernel<TW, TC>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  static SmemLimit limit;      // the attribute is set once a device
  if (err == cudaSuccess) err = limit.raise((const void*)kernel, SMEM_BYTES);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        THREADS, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int grid = per_sm * sms;
  if (grid_out) *grid_out = grid;
  for (int kind = 0; kind < J_KINDS; ++kind)
    a.split[kind] = choose_split(a, kind, grid);
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid),
                                    dim3(THREADS), params, SMEM_BYTES, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// meta: int64 fields in the order kernels/fused_decode/ops.py _META writes.
extern "C" int fused_decode_launch(const long long* meta, int tw, int tc,
                                   void* stream, int* grid_out) {
  Args a;
  int i = 0;
  a.R = (int)meta[i++];
  a.d = (int)meta[i++];
  a.H = (int)meta[i++];
  a.Hkv = (int)meta[i++];
  a.dh = (int)meta[i++];
  a.rot = (int)meta[i++];
  a.F = (int)meta[i++];
  a.V = (int)meta[i++];
  a.L = (int)meta[i++];
  a.nsamp = (int)meta[i++];
  a.npk = (int)meta[i++];
  a.layernorm = (int)meta[i++];
  a.gated = (int)meta[i++];
  a.masked = (int)meta[i++];
  a.packed = (int)meta[i++];
  a.ffn_bias = (int)meta[i++];
  a.qkv_bias = (int)meta[i++];
  a.act = (int)meta[i++];
  a.eps = 1e-6f;
  a.x = (const void*)meta[i++];
  a.pos = (const int*)meta[i++];
  a.cos = (const float*)meta[i++];
  a.sin = (const float*)meta[i++];
  a.layers = (const long long*)meta[i++];
  a.fns = (const void*)meta[i++];
  a.fnb = (const void*)meta[i++];
  a.head = (const void*)meta[i++];
  a.mean_out = (float*)meta[i++];
  a.rel_out = (float*)meta[i++];
  a.knew = (void*)meta[i++];
  a.vnew = (void*)meta[i++];
  a.resid = (float*)meta[i++];
  a.hn = (float*)meta[i++];
  a.qkv = (float*)meta[i++];
  a.att = (float*)meta[i++];
  a.gu = (float*)meta[i++];
  a.mid = (float*)meta[i++];
  a.logits = (float*)meta[i++];
  a.rowmax = (float*)meta[i++];
  a.rowlse = (float*)meta[i++];
  a.stdv = (float*)meta[i++];
  a.stamps = (unsigned long long*)meta[i++];
  if (a.dh > MAX_DH || a.rot > a.dh) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (tw == 0 && tc == 0) return launch<float, float>(a, s, grid_out);
  if (tw == 0 && tc == 1) return launch<float, __nv_bfloat16>(a, s, grid_out);
  if (tw == 1 && tc == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(a, s, grid_out);
  if (tw == 1 && tc == 0) return launch<__nv_bfloat16, float>(a, s, grid_out);
  return (int)cudaErrorInvalidValue;
}
