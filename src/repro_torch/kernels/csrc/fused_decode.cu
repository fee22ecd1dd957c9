// One serving decode step of a dense transformer's mask-expanded slot pool,
// in one cooperative launch (sm_90a).
//
// Replaces src/repro/kernels/fused_plan/kernel.py:260 (fused_decode_pallas,
// pallas_call :324). The TPU kernel was one program with no grid and the
// whole pool resident in VMEM (weights, caches, residual). At full width
// the model is gigabytes, so here the step is a persistent grid: every
// block stays resident (cudaLaunchCooperativeKernel, grid sized by the
// occupancy calculator) and the stages are separated by grid barriers
// (cooperative_groups::this_grid().sync()):
//
//   per layer:  norm1 | qkv | attention | wo | norm2 | gate/up | down
//   then:       final norm | LM head | row max + log-sum-exp |
//               Welford over the mask groups | argmax + rel-unc
//
// What bounds it: bytes. A step reads every weight once (qwen2-1.5b at 32
// rows and a 160-slot cache: 3.23 GB with the k/v it reads, 0.964 ms at
// 3.35 TB/s) for all rows at once; its 2 x rows FLOPs a weight (99.5 GFLOP)
// run on the tensor cores as three bf16 products (0.30 ms at 989 / 3
// TFLOP/s), so the products stay under the bytes. What it loses beyond them
// goes to each chunk's fixed work (staging, the block barrier, the TMA
// issue) and to register spills at two blocks an SM (PERF.md).
//
// GEMV stages (q/k/v, wo, gate/up, down, LM head) compute out[rows, N] (+)=
// in[rows, K] @ W[K, N] for each job of the stage (q/k/v are three jobs;
// packed FFN weights one job a mask over that mask's rows). The work is a
// stream of chunks, KC = 32 weight rows x TN = 128 columns for up to 32
// pool rows, cut evenly across the blocks (stream-K: a block's range may
// start or end inside a column tile; partial sums meet in fp32 atomics on
// the output, which is zeroed, or the residual, beforehand). A block keeps
// a ring of chunk slots: a chunk's weights land as two TMA boxes (2D tensor
// maps encoded once per weight set, 128-byte swizzle, zeros past K and N)
// two chunks ahead; its activation rows land as a TMA box four chunks
// ahead and two ahead are transformed (act(gate) * up * mask for the down
// GEMV) and split three ways into bf16 planes, x = hi + mid + lo, which is
// x exactly. Each product is then three
// mma.sync m16n8k16 on one weight fragment (ldmatrix.trans from the [k][n]
// tile, the weights as the A operand, the pool rows in n-tiles of 8 as B):
// bf16 products are exact in fp32, so the result is the reference's fp32
// product over bf16 storage but for the order of the sums. fp32 weights take
// the same loop with 3xTF32 (m16n8k8, both operands split hi/lo), as the
// IVIM kernels do (dense_tile.cuh). Warp w owns the chunk's 16 columns 16 w
// for both k-halves, so each output has one writer; at a tile's end the
// block adds the tile to the output with one float4 atomic per four columns.
// Small or misaligned shapes (no tensor map) take plain copies instead.
//
// Norms (RMSNorm or layernorm) are stages of their own, one block a row,
// writing the normed rows the next GEMV stages. The hidden stage is gone:
// the down GEMV's staging computes act(gate) * up * mask, so a layer takes
// 7 grid barriers.
//
// Attention is shared across each GQA group: a task is (row, KV head, part
// of the cache slots) and holds the group's G query heads, so each cached
// k/v row is read once for G dot products. A group whose state does not fit
// the stage's shared memory is cut into head chunks, each its own task
// (and each reading the k/v rows once). Each pass over up to SC of the
// part's slots stages their k/v rows, the queries and cos/sin by bulk copies
// on one mbarrier; scores are one thread a (head, slot), the softmax runs
// online across passes, P.V one thread a (head, dim). The parts' (max, sum,
// acc) states meet without a barrier: the last part to finish (an atomic
// count a (row, head chunk)) combines them. Masked slots score -inf; part 0
// also holds the fresh key, and part 0 of the first head chunk writes the
// fresh k/v.
//
// Inter-stage activations and the [rows, vocab] logits live in a workspace in
// device memory; they are read back through L2 (__ldcg), never through the
// non-coherent L1. Block 0 stamps %globaltimer after every barrier, so the
// wrapper can report where a step's time goes.
//
// Contract (kernels/fused_plan/ref.py fused_decode_ref): caches read-only;
// the fresh post-RoPE k and v come back per layer for the caller to commit;
// fp32 arithmetic throughout; weights, x and k/v outputs in the storage type
// TW (float or bf16, upcast exactly), caches in TC.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <mutex>
#include <vector>

#include "dense_tile.cuh"
#include "smem_limit.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;
using dense_tile::cp_async16_zfill;
using dense_tile::cp_async4_zfill;
using dense_tile::cp_async_commit;
using dense_tile::cp_async_wait;
using dense_tile::fence_proxy_async;
using dense_tile::fence_proxy_async_global;
using dense_tile::ldmatrix_x4;
using dense_tile::ldmatrix_x4_trans;
using dense_tile::mbar_arrive_tx;
using dense_tile::mbar_init;
using dense_tile::mbar_wait;
using dense_tile::mma_bf16;
using dense_tile::mma_tf32;
using dense_tile::split_bf16x3;
using dense_tile::split_tf32;
using dense_tile::tma_load_2d;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// Two blocks (16 warps) an SM: two rings in flight, though the register cap
// that comes with it (128) spills some of the loop's state; one block an SM
// without spills ran slower on the H100 (tools/probe_fused_decode.py).
constexpr int MIN_BLOCKS = 2;
constexpr int KC = 32;              // weight rows of a chunk: one bulk copy a lane
constexpr int TN = 128;             // columns of a chunk (a column tile)
constexpr int RG = 32;              // pool rows a chunk's products cover (4 n-tiles)
constexpr int BLD = TN + 4;         // stride of the shared tile the warps' sums meet in
constexpr int MAX_DH = 256;
constexpr int MAX_JOBS = 32;        // job table of a stage; more jobs run in batches
constexpr int PMAX = 8;             // attention parts a (row, KV head), csrc and ops.py
constexpr int SC = 64;              // cache slots an attention pass scores
constexpr int ATTN_SMEM = 80 * 1024;
constexpr int HEADER = 4096;        // mbarriers and the stage's job table
constexpr int RAW_BAR = 8;          // mbarriers: the ring's from 0, the raw slots', the
constexpr int ATTN_BAR = 11;        // attention's
#ifdef FUSED_DECODE_CLOCKS
constexpr int CLK_BYTES = 128;      // the phase counters (probe builds)
#else
constexpr int CLK_BYTES = 0;
#endif

// Activation planes of a chunk: bf16 weights take x = hi + mid + lo (bf16),
// fp32 weights x = hi + lo (tf32 bit patterns, 3xTF32). Plane rows are
// padded so the fragment loads fall on distinct banks.
template <class TW>
struct Tile;
template <>
struct Tile<bf16> {
  using Plane = bf16;
  static constexpr int kPlanes = 3, kXLD = KC + 8, kSlots = 2;
};
template <>
struct Tile<float> {
  using Plane = unsigned;
  static constexpr int kPlanes = 2, kXLD = KC + 4, kSlots = 2;
};
// A chunk's activation sources as they land, before the planes: the rows'
// values (the down GEMV: gate in x, up in y) and the down GEMV's mask as TMA
// boxes of 32 rows x 32 k (row-major, zeros past the tensor's edge).
constexpr int RAW_SLOTS = 3;
template <class TW>
struct alignas(128) Raw {
  float x[RG * KC];
  float y[RG * KC];
  TW m[RG * KC];
};
// A chunk's weights land as TMA boxes of KC rows x 128 bytes (64 bf16 or 32
// fp32 columns) with the 128-byte swizzle: within a box, row k's 16-byte
// piece q sits at piece q ^ (k % 8), so the 8 rows an ldmatrix (or a tf32
// fragment load) reads fall on distinct banks.
constexpr int BOX = KC * 128;
template <class TW>
__host__ __device__ constexpr int w_bytes() {
  return KC * TN * (int)sizeof(TW);
}
template <class TW>
__host__ __device__ constexpr int plane_elems() {
  return RG * Tile<TW>::kXLD;
}
template <class TW>
__host__ __device__ constexpr int plane_bytes() {
  return Tile<TW>::kPlanes * plane_elems<TW>() * (int)sizeof(typename Tile<TW>::Plane);
}
template <class TW>
__host__ __device__ constexpr int slot_bytes() {
  return w_bytes<TW>() + plane_bytes<TW>();
}
// byte offset of weight (k, n) in a chunk's weight tile
template <class TW>
__device__ __forceinline__ int w_off(int k, int n) {
  constexpr int per = 128 / (int)sizeof(TW);
  const int nb = (n % per) * (int)sizeof(TW);
  return (n / per) * BOX + k * 128 + (((nb >> 4) ^ (k & 7)) << 4) + (nb & 15);
}
constexpr int RED_FLOATS = RG * BLD;
template <class TW>
__host__ __device__ constexpr int gemv_bytes() {
  return Tile<TW>::kSlots * slot_bytes<TW>() + RED_FLOATS * 4 +
         RAW_SLOTS * (int)sizeof(Raw<TW>);
}
template <class TW>
__host__ __device__ constexpr int smem_bytes() {   // + room to align the boxes to 1 KB
  return HEADER + 1024 + (gemv_bytes<TW>() > ATTN_SMEM ? gemv_bytes<TW>() : ATTN_SMEM) +
         CLK_BYTES;
}

// per-layer pointer table (int64 each), filled by kernels/fused_decode/ops.py
enum {
  LP_N1S, LP_N1B, LP_WQ, LP_BQ, LP_WK, LP_BK, LP_WV, LP_BV, LP_WO,
  LP_N2S, LP_N2B, LP_WG, LP_WU, LP_BU, LP_WD, LP_BD, LP_MASK,
  LP_KC, LP_VC, LP_KPOS, LP_WINDOW, LP_SMAX, LP_COUNT
};

// activation codes: kernels/fused_decode/ops.py _ACT_CODES
enum { ACT_ID = 0, ACT_RELU, ACT_GELU, ACT_SILU, ACT_SIGMOID, ACT_TANH };

// stages that run a batch of GEMV jobs
enum { J_QKV = 0, J_WO, J_GU, J_DOWN, J_HEAD };

// what a GEMV stage's chunks stage as their activation rows
enum { SRC_PLAIN = 0, SRC_HIDDEN };

struct Args {
  int R, d, H, Hkv, dh, rot, F, V, L, nsamp, npk;
  int layernorm, gated, masked, packed, ffn_bias, qkv_bias, act;
  int attn_heads;                   // query heads an attention task holds
  int parts;                        // attention parts a (row, head chunk)
  int attn_slots;                   // cache slots an attention pass stages
  int nstamps;
  float eps;
  const void* x;
  const int* pos;
  const float* cos;
  const float* sin;
  const long long* layers;          // [L, LP_COUNT]
  const void* fns;
  const void* fnb;
  const void* head;                 // [d, V]
  const CUtensorMap* tmaps;         // the weights' tensor maps (tmap_index)
  const int* tmap_ok;               // 0 where a weight takes no tensor map
  const long long* host_layers;     // the layer table, host copy
  float* mean_out;                  // [b, V]
  float* rel_out;                   // [b]
  void* knew;                       // [L, R, Hkv, dh]
  void* vnew;
  float* resid;                     // [R, d]
  float* hn;                        // [R, d] the norm's output
  float* qkv;                       // [R, (H + 2 Hkv) dh]
  float* att;                       // [R, H dh]
  float* gu;                        // [R, 2F]  gate | up
  float* logits;                    // [R, V]
  float* rowmax;                    // [R]
  float* rowlse;                    // [R]
  float* stdv;                      // [b, V]
  float* part_ml;                   // [R H PMAX 2] a part's (max, sum): a head chunk's
  float* part_acc;                  // [R H PMAX dh]  [PMAX][heads] from its first head
  int* cnt;                         // [R H] parts done a head chunk (reset by the last)
  unsigned long long* stamps;       // [nstamps] barrier times, ns
};

struct Job {                        // out[r, col0 + n] += sum_k in[r, k] w[k, n]
  const void* w;                    // [K, N] row-major, TW
  const CUtensorMap* tmap;          // w's tensor map, or null (plain copies)
  const CUtensorMap* amap;          // in's tensor map, or null (read in convert)
  const CUtensorMap* mmap;          // mask's tensor map, or null
  const void* bias;                 // [N] TW, added once (the range holding k = 0)
  const float* in;                  // the staged rows' source (fp32)
  const void* mask;                 // SRC_HIDDEN: [R, F] (TW) or null
  float* out;
  int K, N, ld_in, row0, nrows, ld_out, col0;
  int tiles, rgroups;               // column tiles, row groups of RG
};

struct Header {
  uint64_t bars[16];
  Job jobs[MAX_JOBS];
};
static_assert(sizeof(Header) <= HEADER, "header");

// a position in a GEMV stage's chunk stream: job, row group, column tile,
// chunk along K (advanced in place: no division a chunk)
struct Cursor {
  int ji, rg, tile, kc;
};

// what a chunk covers
struct Chunk {
  int ji;                           // its job
  int rr0, nr;                      // first pool row, rows (<= RG)
  int col;                          // first column of its tile, in the job
  int k0, kv;                       // first k, valid k rows (<= KC)
};


__device__ __forceinline__ float ld(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float ld(const bf16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, long long i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void st(bf16* p, long long i, float v) {
  p[i] = __float2bfloat16(v);
}

// Built with -DFUSED_DECODE_CLOCKS (tools/probe_fused_decode.py), thread 0
// of block 0 adds the SM cycles of each phase of the GEMV loop (0-7) and of
// the attention task (8-13) into 16 counters at the end of the block's
// shared memory, added to clocks[] when the kernel ends and read by
// fused_decode_clocks(); otherwise the marks compile to nothing.
#ifdef FUSED_DECODE_CLOCKS
__device__ unsigned long long clocks[16];
// the counters sit after everything else the block uses (the bf16 and fp32
// layouts differ, so they are found from the dynamic size)
__device__ __forceinline__ unsigned long long* clk_counters(char* smem) {
  unsigned size;
  asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(size));
  return (unsigned long long*)(smem + size - CLK_BYTES);
}
#define CLK_START(smem)                                 \
  unsigned long long* clk_c = clk_counters(smem);       \
  long long clk_t = clock64()
#define CLK(i)                                          \
  do {                                                  \
    if (blockIdx.x == 0 && threadIdx.x == 0) {          \
      const long long clk_now = clock64();              \
      clk_c[i] += clk_now - clk_t;                      \
      clk_t = clk_now;                                  \
    }                                                   \
  } while (0)
#else
#define CLK_START(smem)
#define CLK(i)
#endif

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

__host__ __device__ __forceinline__ long long lp_at(const Args& a, int layer, int s) {
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

// Index of a weight's tensor map: per layer q, k, v, o, then gate, up and
// down of each packed mask (one set unpacked), then the LM head.
__host__ __device__ __forceinline__ int maps_per_layer(const Args& a) {
  return 4 + 3 * (a.packed ? a.npk : 1);
}
__host__ __device__ __forceinline__ int tmap_index(const Args& a, int layer, int kind, int idx) {
  const int base = layer * maps_per_layer(a);
  switch (kind) {
    case J_QKV: return base + idx;
    case J_WO: return base + 3;
    case J_GU: {
      const int mats = a.gated ? 2 : 1;
      const bool up = !a.gated || idx % mats == 1;
      return base + 4 + 3 * (idx / mats) + (up ? 1 : 0);
    }
    case J_DOWN: return base + 6 + 3 * idx;
    default: return a.L * maps_per_layer(a);
  }
}

// After the weights' maps: the activation buffers' (hn, att, gu), then
// each layer's FFN mask.
enum { AM_HN = 0, AM_ATT, AM_GU, AM_COUNT };
__host__ __device__ __forceinline__ int act_map_index(const Args& a, int which) {
  return a.L * maps_per_layer(a) + 1 + which;
}
__host__ __device__ __forceinline__ int mask_map_index(const Args& a, int layer) {
  return act_map_index(a, AM_COUNT) + layer;
}
__host__ __device__ __forceinline__ int n_maps(const Args& a) {
  return mask_map_index(a, a.L);
}

template <class TW>
__device__ Job job_at(const Args& a, int layer, int kind, int idx) {
  Job j;
  j.bias = j.mask = nullptr;
  j.row0 = 0;
  j.nrows = a.R;
  j.col0 = 0;
  const int qw = a.H * a.dh, kw = a.Hkv * a.dh;
  if (kind == J_QKV) {
    const int wslot = idx == 0 ? LP_WQ : idx == 1 ? LP_WK : LP_WV;
    const int bslot = idx == 0 ? LP_BQ : idx == 1 ? LP_BK : LP_BV;
    j.w = (const void*)lp_at(a, layer, wslot);
    if (a.qkv_bias) j.bias = (const void*)lp_at(a, layer, bslot);
    j.K = a.d;
    j.N = idx == 0 ? qw : kw;
    j.out = a.qkv;
    j.ld_out = qw + 2 * kw;
    j.col0 = idx == 0 ? 0 : idx == 1 ? qw : qw + kw;
  } else if (kind == J_WO) {
    j.w = (const void*)lp_at(a, layer, LP_WO);
    j.K = qw;
    j.N = a.d;
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
    j.K = a.d;
    j.N = a.F;
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
    j.K = a.F;
    j.N = a.d;
    j.in = a.gu;
    j.ld_in = 2 * a.F;
    if (a.masked) j.mask = (const void*)lp_at(a, layer, LP_MASK);
    j.out = a.resid;
    j.ld_out = a.d;
  } else {                          // J_HEAD
    j.w = a.head;
    j.K = a.d;
    j.N = a.V;
    j.out = a.logits;
    j.ld_out = a.V;
  }
  if (kind == J_QKV || kind == J_GU || kind == J_HEAD) {
    j.in = a.hn;
    j.ld_in = a.d;
  }
  j.tiles = (j.N + TN - 1) / TN;
  j.rgroups = (j.nrows + RG - 1) / RG;
  const int mi = tmap_index(a, kind == J_HEAD ? 0 : layer, kind, idx);
  j.tmap = a.tmap_ok[mi] ? a.tmaps + mi : nullptr;
  const int ai = act_map_index(a, j.in == a.hn ? AM_HN : j.in == a.att ? AM_ATT : AM_GU);
  j.amap = a.tmap_ok[ai] ? a.tmaps + ai : nullptr;
  const int mm = mask_map_index(a, layer);
  j.mmap = j.mask && a.tmap_ok[mm] ? a.tmaps + mm : nullptr;
  return j;
}

__device__ Cursor cursor_at(const Job* jobs, int nj, int kch, int g) {
  Cursor c;
  int t = g / kch;
  c.kc = g - t * kch;
  c.ji = 0;
  while (c.ji + 1 < nj && t >= jobs[c.ji].rgroups * jobs[c.ji].tiles) {
    t -= jobs[c.ji].rgroups * jobs[c.ji].tiles;
    ++c.ji;
  }
  c.rg = t / jobs[c.ji].tiles;
  c.tile = t - c.rg * jobs[c.ji].tiles;
  return c;
}

__device__ __forceinline__ void advance(Cursor& c, const Job* jobs, int kch) {
  if (++c.kc < kch) return;
  c.kc = 0;
  if (++c.tile < jobs[c.ji].tiles) return;
  c.tile = 0;
  if (++c.rg < jobs[c.ji].rgroups) return;
  c.rg = 0;
  ++c.ji;
}

__device__ __forceinline__ Chunk chunk_of(const Job* jobs, const Cursor& c) {
  const Job& j = jobs[c.ji];
  Chunk ch;
  ch.ji = c.ji;
  ch.rr0 = j.row0 + c.rg * RG;
  ch.nr = min(RG, j.nrows - c.rg * RG);
  ch.col = c.tile * TN;
  ch.k0 = c.kc * KC;
  ch.kv = min(KC, j.K - ch.k0);
  return ch;
}

template <class TW>
__device__ __forceinline__ TW zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() {
  return 0.f;
}
template <>
__device__ __forceinline__ bf16 zero_of<bf16>() {
  return __float2bfloat16(0.f);
}

// The chunk's weights into its slot's tile (swizzled boxes, zeros past K
// and N): by TMA from the weight's tensor map (thread 0; one arrival
// expecting every box's bytes). A weight without one (a row stride off 16
// bytes, as a packed FFN's kept width can be, or a small shape) is copied
// by every thread, COPY_GROUP loads in flight before their stores (no byte
// goes through the mbarrier; the loop's block barrier orders the stores
// before the chunk's products).
constexpr int COPY_GROUP = 8;       // 4 or 16: slower (tools/probe_fused_decode.py)
template <class TW>
__device__ void issue(const Job& j, const Chunk& ch, char* W, uint64_t* bar) {
  constexpr int boxes = w_bytes<TW>() / BOX;
  if (j.tmap) {
    if (threadIdx.x == 0) {
      mbar_arrive_tx(bar, w_bytes<TW>());
      for (int b = 0; b < boxes; ++b)
        tma_load_2d(W + b * BOX, j.tmap, ch.col + b * (128 / (int)sizeof(TW)), ch.k0, bar);
    }
    return;
  }
  const TW* w = (const TW*)j.w;
  for (int p0 = 0; p0 < KC * TN / THREADS; p0 += COPY_GROUP) {
    TW v[COPY_GROUP];
#pragma unroll
    for (int p = 0; p < COPY_GROUP; ++p) {
      const int e = threadIdx.x + (p0 + p) * THREADS, i = e / TN, n = e % TN;
      v[p] = i < ch.kv && ch.col + n < j.N ? __ldcg(w + (long long)(ch.k0 + i) * j.N + ch.col + n)
                                           : zero_of<TW>();
    }
#pragma unroll
    for (int p = 0; p < COPY_GROUP; ++p) {
      const int e = threadIdx.x + (p0 + p) * THREADS;
      *(TW*)(W + w_off<TW>(e / TN, e % TN)) = v[p];
    }
  }
  fence_proxy_async();              // before a later bulk copy into the slot
  if (threadIdx.x == 0) mbar_arrive_tx(bar, 0);
}

// Whether a job's activation sources take the async path: tensor maps for
// its rows (and mask). Otherwise convert() reads them itself (a ragged
// shape).
__device__ __forceinline__ bool raw_async(const Job& j) {
  return j.amap && (!j.mask || j.mmap);
}

// The chunk's activation sources into a raw slot: the row boxes by TMA
// (thread 32; one arrival on `bar` expecting their bytes).
template <class TW, int SRC>
__device__ void raw_issue(const Args& a, const Job& j, const Chunk& ch, Raw<TW>* r,
                          uint64_t* bar) {
  if (threadIdx.x == 32) {          // warp 1 (warp 0 issues the weights' boxes)
    unsigned bytes = 0;
    if (SRC != SRC_HIDDEN || a.gated) {
      tma_load_2d(r->x, j.amap, ch.k0, ch.rr0, bar);
      bytes += sizeof(r->x);
    }
    if constexpr (SRC == SRC_HIDDEN) {
      tma_load_2d(r->y, j.amap, a.F + ch.k0, ch.rr0, bar);
      bytes += sizeof(r->y);
      if (j.mask) {
        tma_load_2d(r->m, j.mmap, ch.k0, ch.rr0, bar);
        bytes += sizeof(r->m);
      }
    }
    mbar_arrive_tx(bar, bytes);
  }
}

// The chunk's activation tile into the planes of its slot: thread t takes
// row t / 8, k 4 (t % 8) .. + 3; the value (zero past the chunk's rows and
// K) is split into the planes. From the raw slot, or (`direct`) read here.
template <class TW, int SRC>
__device__ void convert(const Args& a, const Job& j, const Chunk& ch, const Raw<TW>* r,
                        bool direct, char* planes) {
  using Plane = typename Tile<TW>::Plane;
  constexpr int XLD = Tile<TW>::kXLD;
  Plane* X = (Plane*)planes;
  const int t = threadIdx.x, row = t / 8, q = 4 * (t % 8);
  const long long grow = ch.rr0 + row;
  float v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int kk = q + e, k = ch.k0 + kk, at = row * KC + kk;
    float val = 0.f;
    if (row < ch.nr && kk < ch.kv) {
      if constexpr (SRC == SRC_HIDDEN) {
        const float* src = j.in + grow * j.ld_in + k;
        const float up = direct ? __ldcg(src + a.F) : r->y[at];
        if (a.gated)
          val = activate(a.act, direct ? __ldcg(src) : r->x[at]) * up;
        else
          val = activate(a.act, up);
        if (j.mask)
          val *= direct ? ld((const TW*)j.mask, grow * a.F + k) : ld(r->m, at);
      } else {
        val = direct ? __ldcg(j.in + grow * j.ld_in + k) : r->x[at];
      }
    }
    v[e] = val;
  }
  const int o = row * XLD + q;
  if constexpr (Tile<TW>::kPlanes == 3) {
    bf16 h[3][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split_bf16x3(v[e], h[0][e], h[1][e], h[2][e]);
#pragma unroll
    for (int p = 0; p < 3; ++p)
      *reinterpret_cast<uint2*>(X + p * plane_elems<TW>() + o) =
          *reinterpret_cast<const uint2*>(h[p]);
  } else {
    unsigned hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(v[e], hi[e], lo[e]);
    *reinterpret_cast<uint4*>(X + o) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(X + plane_elems<TW>() + o) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// A lane's fragment addresses in a chunk's weight tile and planes, fixed
// for a stage (the swizzle depends on k % 8 only, so the second k-half is
// 16 rows further): warp w takes the 16 columns 16 w of the chunk, both
// k-halves; bf16: the ldmatrix.trans row of its A tile (bytes) and the
// ldmatrix row of the planes (elements); tf32: the four A elements (bytes)
// and the B element of the planes (elements).
struct Frag {
  int w[4];
  int x;
};
template <class TW>
__device__ __forceinline__ Frag frag_offsets(int warp, int lane) {
  constexpr int XLD = Tile<TW>::kXLD;
  Frag f;
  if constexpr (Tile<TW>::kPlanes == 3) {
    f.w[0] = w_off<TW>((lane / 16) * 8 + lane % 8, warp * 16 + ((lane / 8) % 2) * 8);
    f.x = ((lane / 16) * 8 + lane % 8) * XLD + ((lane / 8) % 2) * 8;
  } else {
    const int g = lane / 4, c = lane % 4;
    for (int i = 0; i < 4; ++i)
      f.w[i] = w_off<TW>(c + 4 * (i >> 1), warp * 16 + g + 8 * (i & 1));
    f.x = g * XLD + c;
  }
  return f;
}

// The warp's products on one chunk (its 16 columns x 32 k), n-tiles j < nt
// of its pool rows.
template <class TW>
__device__ __forceinline__ void products(float (&acc)[4][4], const char* W, const char* Xp,
                                         int nt, const Frag& f) {
  constexpr int XLD = Tile<TW>::kXLD;
  if constexpr (Tile<TW>::kPlanes == 3) {
    const bf16* X = (const bf16*)Xp + f.x;
#pragma unroll
    for (int kh = 0; kh < 2; ++kh) {
      unsigned af[4];
      ldmatrix_x4_trans(af, W + f.w[0] + kh * 16 * 128);
      // the small parts first
#pragma unroll
      for (int p = 2; p >= 0; --p) {
        unsigned b[4][2];
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          if (2 * jp >= nt) break;
          unsigned r[4];
          ldmatrix_x4(r, X + p * plane_elems<TW>() + 16 * jp * XLD + 16 * kh);
          b[2 * jp][0] = r[0];
          b[2 * jp][1] = r[1];
          b[2 * jp + 1][0] = r[2];
          b[2 * jp + 1][1] = r[3];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j < nt) mma_bf16(acc[j], af, b[j]);
      }
    }
  } else {
    const unsigned* Xh = (const unsigned*)Xp + f.x;
    const unsigned* Xl = Xh + plane_elems<TW>();
#pragma unroll
    for (int s = 0; s < 4; ++s) {   // k steps of 8: the swizzle repeats every 8 rows
      unsigned ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        split_tf32(*(const float*)(W + f.w[i] + s * 8 * 128), ah[i], al[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j >= nt) break;
        const int e = 8 * j * XLD + 8 * s;
        const unsigned bh[2] = {Xh[e], Xh[e + 4]}, bl[2] = {Xl[e], Xl[e + 4]};
        mma_tf32(acc[j], al, bh);
        mma_tf32(acc[j], ah, bl);
        mma_tf32(acc[j], ah, bh);
      }
    }
  }
}

// The warp's accumulators into the block's shared tile [RG][BLD] (each
// element has one writer), then zeroed.
__device__ __forceinline__ void acc_to_tile(float (&acc)[4][4], float* tile, int nt, int warp,
                                            int lane) {
  const int g = lane / 4, c = lane % 4;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (j < nt) tile[(8 * j + 2 * c + (i & 1)) * BLD + warp * 16 + g + 8 * (i >> 1)] = acc[j][i];
      acc[j][i] = 0.f;
    }
  }
}

// The shared tile onto the output (one float4 atomic per four columns where
// aligned), with the bias if the block's range held k = 0.
template <class TW>
__device__ void flush_tile(const Job& j, const Chunk& ch, float* tile, bool bias_on) {
  const TW* bias = bias_on ? (const TW*)j.bias : nullptr;
  for (int e = threadIdx.x; e < RG * TN / 4; e += THREADS) {
    const int rr = e / (TN / 4), q = 4 * (e % (TN / 4)), n = ch.col + q;
    if (rr >= ch.nr || n >= j.N) continue;  // rows past nt x 8 are stale
    const float4 v = *reinterpret_cast<const float4*>(tile + rr * BLD + q);
    float vv[4] = {v.x, v.y, v.z, v.w};
    if (bias)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (n + i < j.N) vv[i] += ld(bias, n + i);
    float* o = j.out + (long long)(ch.rr0 + rr) * j.ld_out + j.col0 + n;
    if (n + 3 < j.N && ((uintptr_t)o & 15) == 0) {
      atomicAdd(reinterpret_cast<float4*>(o), make_float4(vv[0], vv[1], vv[2], vv[3]));
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (n + i < j.N) atomicAdd(o + i, vv[i]);
    }
  }
}

// A batch of a GEMV stage's jobs (jobs j0 .. j0 + nj - 1, nj <= MAX_JOBS):
// this block's even share of their chunk stream. `ring` counts the chunks
// the block's slots have taken so far (slot and mbarrier phase of a chunk
// follow from it). SRC: what the stage's chunks stage as their activation
// rows (the same for all its jobs).
//
// Chunk c's weights are issued S chunks ahead (bulk copies), its activation
// sources four ahead (TMA boxes into a ring of three raw slots) and turned
// into planes two ahead, right after the barrier that ends chunk c - 2's
// products; the raw slot a new copy lands in was read a barrier earlier.
template <class TW, int SRC>
__device__ void gemv_jobs(const Args& a, int layer, int kind, int j0, int nj, char* smem,
                          unsigned& ring, unsigned& raw_ring) {
  using T = Tile<TW>;
  Header* hd = (Header*)smem;
  // the weight tiles (1 KB aligned: the swizzled boxes), planes, tile, raw
  char* ring_mem = (char*)(((uintptr_t)smem + HEADER + 1023) & ~(uintptr_t)1023);
  char* planes_mem = ring_mem + T::kSlots * w_bytes<TW>();
  float* red = (float*)(planes_mem + T::kSlots * plane_bytes<TW>());
  Raw<TW>* raw = (Raw<TW>*)(red + RED_FLOATS);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();                  // the last batch's table read
  if (threadIdx.x < nj) hd->jobs[threadIdx.x] = job_at<TW>(a, layer, kind, j0 + threadIdx.x);
  __syncthreads();
  const Job* jobs = hd->jobs;
  const int kch = (jobs[0].K + KC - 1) / KC;
  int total = 0;
  for (int i = 0; i < nj; ++i) total += jobs[i].rgroups * jobs[i].tiles;
  total *= kch;
  const int g0 = (int)((long long)total * blockIdx.x / gridDim.x);
  const int n = (int)((long long)total * (blockIdx.x + 1) / gridDim.x) - g0;
  bool direct = false;
  for (int i = 0; i < nj; ++i) direct |= !raw_async(jobs[i]);
  uint64_t* raw_bar = &hd->bars[RAW_BAR];
  auto slot_of = [&](int c) {      // chunk c's weight tile
    return ring_mem + (size_t)((ring + c) % T::kSlots) * w_bytes<TW>();
  };
  auto planes_of = [&](int c) {
    return planes_mem + (size_t)((ring + c) % T::kSlots) * plane_bytes<TW>();
  };
  auto bar_of = [&](int c) { return &hd->bars[(ring + c) % T::kSlots]; };
  const Frag frag = frag_offsets<TW>(warp, lane);
  // the chunk consumed (c); the ones converted (c + 2), whose raw copies are
  // issued (c + 4) and whose weights are issued (c + S) are found from it
  Cursor cc = cursor_at(jobs, nj, kch, g0);
  auto ahead = [&](int k) {
    Cursor x = cc;
    for (int i = 0; i < k; ++i) advance(x, jobs, kch);
    return chunk_of(jobs, x);
  };
  auto raw_next = [&](int c, int k) {   // chunk c = (consumed) + k, raw slot c % 3
    if (c < n && !direct) {
      const Chunk ch = ahead(k);
      raw_issue<TW, SRC>(a, jobs[ch.ji], ch, raw + c % RAW_SLOTS,
                         raw_bar + (raw_ring + c) % RAW_SLOTS);
    }
  };
  auto raw_wait = [&](int c) {    // chunk c's row boxes landed
    if (!direct)
      mbar_wait(raw_bar + (raw_ring + c) % RAW_SLOTS, ((raw_ring + c) / RAW_SLOTS) & 1);
  };
  for (int c = 0; c < 3; ++c) raw_next(c, c);
  for (int c = 0; c < min(n, T::kSlots); ++c) {
    const Chunk ch = ahead(c);
    issue<TW>(jobs[ch.ji], ch, slot_of(c), bar_of(c));
  }
  __syncthreads();
  for (int c = 0; c < min(n, 2); ++c) {
    const Chunk ch = ahead(c);
    raw_wait(c);
    convert<TW, SRC>(a, jobs[ch.ji], ch, raw + c, direct, planes_of(c));
  }
  __syncthreads();
  raw_next(3, 3);
  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  bool seg_first = false;           // this tile segment holds the tile's k = 0
  CLK_START(smem);
  for (int c = 0; c < n; ++c) {
    const int nt = (min(RG, jobs[cc.ji].nrows - cc.rg * RG) + 7) / 8;
    CLK(0);
    mbar_wait(bar_of(c), ((ring + c) / T::kSlots) & 1);
    CLK(1);
    products<TW>(acc, slot_of(c), planes_of(c), nt, frag);
    CLK(2);
    seg_first |= cc.kc == 0;
    const bool flush = cc.kc == kch - 1 || c == n - 1;
    if (flush) acc_to_tile(acc, red, nt, warp, lane);
    __syncthreads();                // chunk c consumed, the tile written
    CLK(3);
    if (flush) {
      const Chunk ch = chunk_of(jobs, cc);
      flush_tile<TW>(jobs[ch.ji], ch, red, seg_first);
      seg_first = false;
      __syncthreads();              // the tile read before the next sums
    }
    CLK(4);
    if (c + T::kSlots < n) {
      const Chunk chi = ahead(T::kSlots);
      issue<TW>(jobs[chi.ji], chi, slot_of(c), bar_of(c));
    }
    CLK(5);
    if (c + 2 < n) {
      const Chunk chv = ahead(2);
      raw_wait(c + 2);
      convert<TW, SRC>(a, jobs[chv.ji], chv, raw + (c + 2) % RAW_SLOTS, direct,
                       planes_of(c + 2));
    }
    raw_next(c + 4, 4);
    advance(cc, jobs, kch);
    CLK(6);
  }
  ring += n;
  if (!direct) raw_ring += n;
}

// One GEMV stage: its jobs in batches of the job table's size.
template <class TW, int SRC>
__device__ void gemv_stage(const Args& a, int layer, int kind, char* smem, unsigned& ring,
                           unsigned& raw_ring) {
  const int nall = n_jobs(a, kind);
  for (int j0 = 0; j0 < nall; j0 += MAX_JOBS)
    gemv_jobs<TW, SRC>(a, layer, kind, j0, min(MAX_JOBS, nall - j0), smem, ring, raw_ring);
}

__device__ void zero_grid(float* p, long long n) {
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  for (long long i = tid; i < n; i += (long long)gridDim.x * THREADS) p[i] = 0.f;
}

// ---- norms (RMSNorm or layernorm: one block per row) ----------------------

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
  zero_grid(zero, zero_n);
  zero_grid(zero2, zero2_n);
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

// ---- attention: a task is (row, KV head, part of the slots) ---------------

// q . k over dh, k a staged cache row. Lanes of a warp score different
// rows; starting each row's 16-byte pieces at piece `rot` (the row's index)
// puts the warp's loads of unpadded rows on distinct banks.
__device__ __forceinline__ float dot_row(const float* q, const bf16* k, int dh, int rot) {
  float s = 0.f;
  if ((dh & 7) == 0) {
    const int pieces = dh / 8;
    int pc = rot % pieces;
    for (int i = 0; i < pieces; ++i, pc = pc + 1 == pieces ? 0 : pc + 1) {
      const int c = 8 * pc;
      const uint4 raw = *reinterpret_cast<const uint4*>(k + c);
      const bf16* kv = reinterpret_cast<const bf16*>(&raw);
      const float4 q0 = *reinterpret_cast<const float4*>(q + c);
      const float4 q1 = *reinterpret_cast<const float4*>(q + c + 4);
      s = fmaf(q0.x, __bfloat162float(kv[0]), s);
      s = fmaf(q0.y, __bfloat162float(kv[1]), s);
      s = fmaf(q0.z, __bfloat162float(kv[2]), s);
      s = fmaf(q0.w, __bfloat162float(kv[3]), s);
      s = fmaf(q1.x, __bfloat162float(kv[4]), s);
      s = fmaf(q1.y, __bfloat162float(kv[5]), s);
      s = fmaf(q1.z, __bfloat162float(kv[6]), s);
      s = fmaf(q1.w, __bfloat162float(kv[7]), s);
    }
    return s;
  }
  for (int c = 0; c < dh; ++c) s = fmaf(q[c], __bfloat162float(k[c]), s);
  return s;
}
__device__ __forceinline__ float dot_row(const float* q, const float* k, int dh, int rot) {
  float s = 0.f;
  if ((dh & 3) == 0) {
    const int pieces = dh / 4;
    int pc = rot % pieces;
    for (int i = 0; i < pieces; ++i, pc = pc + 1 == pieces ? 0 : pc + 1) {
      const float4 kv = *reinterpret_cast<const float4*>(k + 4 * pc);
      const float4 qv = *reinterpret_cast<const float4*>(q + 4 * pc);
      s = fmaf(qv.x, kv.x, s);
      s = fmaf(qv.y, kv.y, s);
      s = fmaf(qv.z, kv.z, s);
      s = fmaf(qv.w, kv.w, s);
    }
    return s;
  }
  for (int c = 0; c < dh; ++c) s = fmaf(q[c], k[c], s);
  return s;
}

// rows x bytes from src (row stride lds bytes, device memory) to dst (row
// stride ldd, shared memory) by cp.async, 16 bytes a copy where everything
// is 16-byte aligned (else 4, else plain byte copies); all threads take part
// (the caller commits, waits and holds a barrier).
__device__ void stage_rows_async(void* dst, int ldd, const void* src, long long lds, int rows,
                                 int bytes) {
  const uintptr_t bits = (uintptr_t)dst | (uintptr_t)src | (uintptr_t)ldd | (uintptr_t)lds |
                         (uintptr_t)bytes;
  const int w = (bits & 15) == 0 ? 16 : (bits & 3) == 0 ? 4 : 1;
  const int per = bytes / w, total = rows * per;
  for (int e = threadIdx.x; e < total; e += THREADS) {
    const int r = e / per, o = (e - r * per) * w;
    char* d = (char*)dst + (long long)r * ldd + o;
    const char* s = (const char*)src + r * lds + o;
    if (w == 16)
      cp_async16_zfill(d, s, 16);
    else if (w == 4)
      cp_async4_zfill(d, s, 4);
    else
      *d = *s;
  }
}

// Shared floats of the attention stage for a task of G heads: the fixed
// part (queries, fresh k/v, cos/sin, accumulators, softmax state,
// alignment) and one staged cache slot (scores, kpos, its k and v rows).
__host__ __device__ __forceinline__ int attn_fixed_floats(int G, int dh) {
  return (G + 2) * dh + dh + G * dh + 3 * G + 64;
}
__host__ __device__ __forceinline__ int attn_slot_floats(int G, int dh, int tc_bytes) {
  return G + 2 + 2 * dh * tc_bytes / 4;
}
// Query heads an attention task holds: the whole GQA group where its state
// and 8 cache slots fit, else the most that do (a head chunk a task).
__host__ __forceinline__ int attn_heads(int G, int dh, int tc_bytes) {
  int g = G;
  while (g > 1 && attn_fixed_floats(g, dh) + 8 * attn_slot_floats(g, dh, tc_bytes) >
                      ATTN_SMEM / 4)
    --g;
  return g;
}

// One (row, KV head, head chunk, part) task at a time: the part's cache
// slots staged in passes of SP (a.attn_slots), each pass's pieces landing
// together (bulk copies on the block's attention mbarrier where 16-byte
// aligned, cp.async otherwise); `phase` counts that mbarrier's phases.
template <class TW, class TC>
__device__ void attn_stage(const Args& a, int layer, char* scratch, uint64_t* bar,
                           unsigned& phase) {
  const int H = a.H, Hkv = a.Hkv, dh = a.dh, G = H / Hkv, P = a.parts;
  const int GT = a.attn_heads, HC = (G + GT - 1) / GT;
  const int half = a.rot / 2, SP = a.attn_slots;
  const long long Nq = (long long)(H + 2 * Hkv) * dh;
  const TC* kc = (const TC*)lp_at(a, layer, LP_KC);
  const TC* vc = (const TC*)lp_at(a, layer, LP_VC);
  const int* kpos = (const int*)lp_at(a, layer, LP_KPOS);
  const int window = (int)lp_at(a, layer, LP_WINDOW);
  const int S = (int)lp_at(a, layer, LP_SMAX);
  const float scale = rsqrtf((float)dh);
  auto up4 = [](int n) { return (n + 3) & ~3; };   // floats, to 16 bytes
  float* sq = (float*)scratch;      // [GT][dh] queries, then [dh] fresh k, [dh] fresh v
  float* cs = sq + up4((GT + 2) * dh);              // [half] cos, [half] sin
  float* sn = cs + up4(half);
  float* acc = sn + up4(half);      // [GT][dh]
  float* mrun = acc + up4(GT * dh); // [GT] running max, sum, rescale
  float* lrun = mrun + GT;
  float* corr = lrun + GT;
  int* last = (int*)(corr + GT);
  float* sc = (float*)(last + 4);   // [GT][SP] scores, then exp weights
  int* skp = (int*)(sc + GT * SP);  // [SP] kpos of the staged slots
  TC* kst = (TC*)(((uintptr_t)(skp + SP) + 15) & ~(uintptr_t)15);  // [SP][dh]
  TC* vst = (TC*)(((uintptr_t)(kst + SP * dh) + 15) & ~(uintptr_t)15);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int span = (S + P - 1) / P;                 // cache slots a part covers
  int bulk = 0;                     // bytes the pass's bulk copies bring
  auto stage = [&](void* dst, const void* src, int bytes) {
    if (bytes <= 0) return;
    if (((uintptr_t)dst | (uintptr_t)src | (uintptr_t)bytes) & 15) {
      stage_rows_async(dst, 0, src, 0, 1, bytes);
      return;
    }
    if (tid == 0) dense_tile::bulk_copy(dst, src, (unsigned)bytes, bar);
    bulk += bytes;
  };
  auto land = [&]() {               // the pass's pieces, then a barrier
    if (tid == 0) mbar_arrive_tx(bar, (unsigned)bulk);
    bulk = 0;
    cp_async_commit();
    cp_async_wait<0>();
    mbar_wait(bar, phase & 1);
    ++phase;
    __syncthreads();
  };
  for (int task = blockIdx.x; task < a.R * Hkv * HC * P; task += gridDim.x) {
    const int rh = task / P, part = task % P, hc = rh % HC, rj = rh / HC;
    const int r = rj / Hkv, j = rj % Hkv;
    const int h0 = j * G + hc * GT, g_n = min(GT, G - hc * GT);   // its heads
    float* sk = sq + g_n * dh;
    float* sv = sk + dh;
    const int p = a.pos[r];
    const float* row = a.qkv + (long long)r * Nq;
    const int slot = floor_mod(window ? floor_mod(p, window) : p, S);
    const int s_lo = min(S, part * span), ncache = min(S, s_lo + span) - s_lo;
    const int nall = ncache + (part == 0);          // part 0: + the fresh key
    const long long cb = ((long long)r * Hkv + j) * S;
    const TC* kr = kc + (cb + s_lo) * dh;
    const TC* vr = vc + (cb + s_lo) * dh;
    const int* kp = kpos + (long long)r * S + s_lo;
    const int n0 = min(SP, ncache);
    CLK_START(scratch - HEADER);
    fence_proxy_async();            // the last task's writes, before the copies
    __syncthreads();                // ... and its reads are done
    // the chunk's queries, fresh key and value as the q/k/v GEMV left them,
    // cos/sin, and the first pass's cache rows, together
    stage(sq, row + (long long)h0 * dh, g_n * dh * 4);
    stage(sk, row + (long long)(H + j) * dh, dh * 4);
    stage(sv, row + (long long)(H + Hkv + j) * dh, dh * 4);
    stage(cs, a.cos + (long long)r * half, half * 4);
    stage(sn, a.sin + (long long)r * half, half * 4);
    stage(kst, kr, n0 * dh * (int)sizeof(TC));
    stage(vst, vr, n0 * dh * (int)sizeof(TC));
    stage_rows_async(skp, 0, kp, 0, 1, 4 * n0);
    land();
    CLK(7);
    // split-half RoPE on the leading rot lanes of each query and the key: a
    // thread a pair
    for (int e = tid; e < (g_n + 1) * dh; e += THREADS) {
      const int c = e % dh;
      if (c >= half) continue;
      float* x = sq + (long long)(e / dh) * dh;
      const float v0 = x[c], v1 = x[c + half];
      x[c] = v0 * cs[c] - v1 * sn[c];
      x[c + half] = v0 * sn[c] + v1 * cs[c];
    }
    for (int e = tid; e < g_n * dh; e += THREADS) acc[e] = 0.f;
    for (int g = tid; g < g_n; g += THREADS) {
      mrun[g] = -INFINITY;
      lrun[g] = 0.f;
    }
    __syncthreads();
    CLK(8);
    if (part == 0 && hc == 0) {     // the fresh k/v, for the caller's commit
      const long long o = (((long long)layer * a.R + r) * Hkv + j) * dh;
      for (int c = tid; c < dh; c += THREADS) {
        st((TW*)a.knew, o + c, sk[c]);
        st((TW*)a.vnew, o + c, sv[c]);
      }
    }
    for (int i0 = 0; i0 < nall; i0 += SP) {
      const int n = min(SP, nall - i0);
      const int nc = max(0, min(n, ncache - i0));   // staged cache slots
      if (i0 > 0) {                 // the next pass's rows
        fence_proxy_async();
        __syncthreads();
        stage(kst, kr + (long long)i0 * dh, nc * dh * (int)sizeof(TC));
        stage(vst, vr + (long long)i0 * dh, nc * dh * (int)sizeof(TC));
        stage_rows_async(skp, 0, kp + i0, 0, 1, 4 * nc);
        land();
      }
      for (int e = tid; e < n * g_n; e += THREADS) {  // a (head, slot) a thread
        const int g = e / n, i = e % n;
        const float* q = sq + g * dh;
        float s = -INFINITY;
        if (i < nc) {
          const int sl = s_lo + i0 + i, kpv = skp[i];
          if (kpv >= 0 && kpv <= p && sl != slot) s = dot_row(q, kst + i * dh, dh, i) * scale;
        } else {                    // the fresh key
          s = dot_row(q, sk, dh, 0) * scale;
        }
        sc[g * SP + i] = s;
      }
      __syncthreads();
      CLK(9);
      for (int g = warp; g < g_n; g += WARPS) {     // online softmax, a warp a head
        float mx = -INFINITY;
        for (int i = lane; i < n; i += 32) mx = fmaxf(mx, sc[g * SP + i]);
        mx = warp_max(mx);
        const float m_old = mrun[g], m_new = fmaxf(m_old, mx);
        float sum = 0.f;
        for (int i = lane; i < n; i += 32) {
          const float s = sc[g * SP + i];
          const float e = s == -INFINITY ? 0.f : expf(s - m_new);
          sc[g * SP + i] = e;
          sum += e;
        }
        sum = warp_sum(sum);
        if (lane == 0) {
          const float cr = m_old == -INFINITY ? 0.f : expf(m_old - m_new);
          corr[g] = cr;
          lrun[g] = lrun[g] * cr + sum;
          mrun[g] = m_new;
        }
      }
      __syncthreads();
      CLK(10);
      for (int e = tid; e < g_n * dh; e += THREADS) { // P.V, a thread a (head, dim)
        const int g = e / dh, c = e % dh;
        const float* pg = sc + g * SP;
        float o = acc[e] * corr[g];
        for (int i = 0; i < nc; ++i) o = fmaf(pg[i], ld(vst + i * dh, c), o);
        if (nc < n) o = fmaf(pg[nc], sv[c], o);    // the fresh key's value
        acc[e] = o;
      }
    }
    __syncthreads();
    CLK(11);
    float* out = a.att + (long long)r * H * dh + (long long)h0 * dh;
    if (P == 1) {
      for (int e = tid; e < g_n * dh; e += THREADS) out[e] = acc[e] / lrun[e / dh];
      continue;
    }
    const long long rc = (long long)r * H + h0;     // the chunk's state, at its first head
    float* pml = a.part_ml + rc * PMAX * 2;
    float* pacc = a.part_acc + rc * PMAX * dh;
    for (int e = tid; e < g_n * dh; e += THREADS) pacc[(long long)part * g_n * dh + e] = acc[e];
    for (int g = tid; g < g_n; g += THREADS) {
      pml[(part * g_n + g) * 2] = mrun[g];
      pml[(part * g_n + g) * 2 + 1] = lrun[g];
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) *last = atomicAdd(a.cnt + rc, 1) == P - 1;
    __syncthreads();
    if (!*last) continue;
    __threadfence();                // the last part combines the P states
    for (int e = tid; e < g_n * dh; e += THREADS) {
      const int g = e / dh;
      float mx = -INFINITY;
      for (int q = 0; q < P; ++q) mx = fmaxf(mx, __ldcg(pml + (q * g_n + g) * 2));
      float num = 0.f, den = 0.f;
      for (int q = 0; q < P; ++q) {
        const float m = __ldcg(pml + (q * g_n + g) * 2);
        if (m == -INFINITY) continue;               // the part saw no valid slot
        const float w = expf(m - mx);
        den += w * __ldcg(pml + (q * g_n + g) * 2 + 1);
        num += w * __ldcg(pacc + (long long)q * g_n * dh + e);
      }
      out[e] = num / den;
    }
    if (tid == 0) a.cnt[rc] = 0;
    CLK(12);
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
    float sum = 0.f;
    for (int c = threadIdx.x; c < a.V; c += THREADS)
      sum += expf(__ldcg(row + c) - mx);
    sum = block_reduce(sum, false, red);
    if (threadIdx.x == 0) {
      a.rowmax[r] = mx;
      a.rowlse[r] = logf(sum);
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
      const float y = (__ldcg(a.logits + row * a.V + v) - __ldcg(a.rowmax + row)) -
                      __ldcg(a.rowlse + row);
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
      if (bi >= a.V) bi = 0;        // a row of NaN: no index beats another
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
  extern __shared__ __align__(128) char smem[];
#ifdef FUSED_DECODE_CLOCKS
  if (threadIdx.x < 16) clk_counters(smem)[threadIdx.x] = 0;
#endif
  Header* hd = (Header*)smem;
  char* scratch = smem + HEADER;
  float* red = (float*)scratch;
  if (threadIdx.x == 0) {
    for (int i = 0; i < Tile<TW>::kSlots; ++i) mbar_init(&hd->bars[i]);
    for (int i = 0; i < RAW_SLOTS; ++i) mbar_init(&hd->bars[RAW_BAR + i]);
    mbar_init(&hd->bars[ATTN_BAR]);
  }
  __syncthreads();
  unsigned ring = 0, raw_ring = 0, attn_phase = 0;
  const bool stamp = a.stamps && blockIdx.x == 0 && threadIdx.x == 0;
  int si = 0;
  auto mark = [&]() {
    if (stamp && si < a.nstamps) a.stamps[si++] = now_ns();
  };
  auto sync = [&]() {
    // what this stage wrote may take bulk copies next: into the scratch
    // (this block's), and out of the q/k/v buffer (any block's)
    fence_proxy_async();
    fence_proxy_async_global();
    grid.sync();
    mark();
  };
  mark();
  const long long qkv_n = (long long)a.R * (a.H + 2 * a.Hkv) * a.dh;
  const long long gu_n = (long long)a.R * 2 * a.F;
  const long long logit_n = (long long)a.R * a.V;
  for (int l = 0; l < a.L; ++l) {
    norm_stage<TW>(a, l == 0, (const void*)lp_at(a, l, LP_N1S),
                   (const void*)lp_at(a, l, LP_N1B), a.hn, a.qkv, qkv_n,
                   a.gu, gu_n, red);
    sync();
    gemv_stage<TW, SRC_PLAIN>(a, l, J_QKV, smem, ring, raw_ring);
    sync();
    attn_stage<TW, TC>(a, l, scratch, &hd->bars[ATTN_BAR], attn_phase);
    sync();
    gemv_stage<TW, SRC_PLAIN>(a, l, J_WO, smem, ring, raw_ring);
    sync();
    norm_stage<TW>(a, false, (const void*)lp_at(a, l, LP_N2S),
                   (const void*)lp_at(a, l, LP_N2B), a.hn, nullptr, 0,
                   nullptr, 0, red);
    sync();
    gemv_stage<TW, SRC_PLAIN>(a, l, J_GU, smem, ring, raw_ring);
    sync();
    gemv_stage<TW, SRC_HIDDEN>(a, l, J_DOWN, smem, ring, raw_ring);
    sync();
  }
  norm_stage<TW>(a, false, a.fns, a.fnb, a.hn, a.logits, logit_n, nullptr, 0, red);
  sync();
  gemv_stage<TW, SRC_PLAIN>(a, 0, J_HEAD, smem, ring, raw_ring);
  sync();
  lse_stage(a, red);
  sync();
  welford_stage(a);
  sync();
  argmax_stage(a, red);
  mark();                           // block 0's share of the last stage
#ifdef FUSED_DECODE_CLOCKS
  if (blockIdx.x == 0 && threadIdx.x < 16) clocks[threadIdx.x] += clk_counters(smem)[threadIdx.x];
#endif
}

// The weights' tensor maps (2D, boxes of KC rows x 128 bytes, 128-byte
// swizzle, zeros past the edges), encoded once per set of weight pointers
// and shapes and kept in device memory, with a flag a map: a weight whose
// base or row stride is not 16-byte aligned takes none (plain copies).
class TensorMaps {
 public:
  // {maps, flags} on the current device for this launch's weights
  cudaError_t get(const Args& a, int esize, const CUtensorMap** maps, const int** ok) {
    std::vector<long long> key = {a.L, a.d, a.H, a.Hkv, a.dh, a.F, a.V, a.npk, a.packed,
                                  a.gated, a.R, esize, (long long)a.head,
                                  (long long)a.hn, (long long)a.att, (long long)a.gu};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    key.push_back(dev);
    for (int l = 0; l < a.L; ++l)
      for (int s : {LP_WQ, LP_WK, LP_WV, LP_WO, LP_WG, LP_WU, LP_WD, LP_MASK})
        key.push_back(a.host_layers[(long long)l * LP_COUNT + s]);
    std::lock_guard<std::mutex> lock(mu_);
    for (auto& e : cache_)
      if (e.key == key) {
        *maps = (const CUtensorMap*)e.dev;
        *ok = (const int*)((const CUtensorMap*)e.dev + e.n);
        return cudaSuccess;
      }
    if (!encode_) {
      cudaDriverEntryPointQueryResult found;
      err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", (void**)&encode_,
                                    cudaEnableDefault, &found);
      if (err != cudaSuccess) return err;
      if (found != cudaDriverEntryPointSuccess || !encode_) return cudaErrorNotSupported;
    }
    const int n = n_maps(a);
    std::vector<CUtensorMap> host(n);
    std::vector<int> flags(n, 0);
    const int qw = a.H * a.dh, kw = a.Hkv * a.dh, mats = a.packed ? a.npk : 1;
    auto put = [&](int i, const void* base, long long rows, long long cols, int es = 0) {
      flags[i] = encode(&host[i], base, rows, cols, es ? es : esize, es != 0);
    };
    for (int l = 0; l < a.L; ++l) {
      auto ptr = [&](int s) { return (const char*)a.host_layers[(long long)l * LP_COUNT + s]; };
      const int b = l * maps_per_layer(a);
      put(b, ptr(LP_WQ), a.d, qw);
      put(b + 1, ptr(LP_WK), a.d, kw);
      put(b + 2, ptr(LP_WV), a.d, kw);
      put(b + 3, ptr(LP_WO), qw, a.d);
      for (int m = 0; m < mats; ++m) {
        const long long off = (long long)m * a.d * a.F * esize;
        if (a.gated) put(b + 4 + 3 * m, ptr(LP_WG) + off, a.d, a.F);
        put(b + 5 + 3 * m, ptr(LP_WU) + off, a.d, a.F);
        put(b + 6 + 3 * m, ptr(LP_WD) + off, a.F, a.d);
      }
    }
    put(a.L * maps_per_layer(a), a.head, a.d, a.V);
    // activation boxes: 32 rows x 32 k, unswizzled
    put(act_map_index(a, AM_HN), a.hn, a.R, a.d, 4);
    put(act_map_index(a, AM_ATT), a.att, a.R, qw, 4);
    put(act_map_index(a, AM_GU), a.gu, a.R, 2LL * a.F, 4);
    for (int l = 0; l < a.L; ++l)
      if (a.masked)
        put(mask_map_index(a, l), (const void*)a.host_layers[(long long)l * LP_COUNT + LP_MASK],
            a.R, a.F, esize);
    void* dev_buf = nullptr;
    const size_t bytes = n * sizeof(CUtensorMap) + n * sizeof(int);
    err = cudaMalloc(&dev_buf, bytes);
    if (err == cudaSuccess)
      err = cudaMemcpy(dev_buf, host.data(), n * sizeof(CUtensorMap), cudaMemcpyHostToDevice);
    if (err == cudaSuccess)
      err = cudaMemcpy((CUtensorMap*)dev_buf + n, flags.data(), n * sizeof(int),
                       cudaMemcpyHostToDevice);
    if (err != cudaSuccess) {
      cudaFree(dev_buf);
      return err;
    }
    if (cache_.size() >= kEntries) {  // the oldest weight set goes
      cudaFree(cache_.front().dev);
      cache_.erase(cache_.begin());
    }
    cache_.push_back({key, dev_buf, n});
    *maps = (const CUtensorMap*)dev_buf;
    *ok = (const int*)((const CUtensorMap*)dev_buf + n);
    return cudaSuccess;
  }

 private:
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  struct Entry {
    std::vector<long long> key;
    void* dev;
    int n;
  };
  static constexpr size_t kEntries = 16;

  // a weight's map (boxes of KC rows x 128 bytes, swizzled), or with `act`
  // an activation's (boxes of RG rows x KC elements, as stored)
  int encode(CUtensorMap* m, const void* base, long long rows, long long cols, int esize,
             bool act) {
    if (!base || ((uintptr_t)base & 15) || ((cols * esize) & 15)) return 0;
    const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)(cols * esize)};
    const cuuint32_t box[2] = {act ? (cuuint32_t)KC : (cuuint32_t)(128 / esize),
                               act ? (cuuint32_t)RG : (cuuint32_t)KC};
    const cuuint32_t one[2] = {1, 1};
    return encode_(m, esize == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                   2, (void*)base, dims, strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
                   act ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
  }

  std::mutex mu_;
  std::vector<Entry> cache_;
  Encode encode_ = nullptr;
};

// The grid (occupancy x SMs) of a kernel on each device, found once a device:
// the attribute and occupancy queries cost host time on every launch.
struct GridCache {
  static constexpr int kDevices = 64;
  std::atomic<int> blocks[kDevices]{};

  template <class K>
  cudaError_t get(K kernel, int smem, SmemLimit& limit, int* grid) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const bool tracked = dev >= 0 && dev < kDevices;
    if (tracked && (*grid = blocks[dev].load(std::memory_order_relaxed)) > 0) return cudaSuccess;
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) err = limit.raise((const void*)kernel, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    *grid = per_sm * sms;
    if (tracked) blocks[dev].store(*grid, std::memory_order_relaxed);
    return cudaSuccess;
  }
};

template <class TW, class TC>
int launch(Args a, cudaStream_t stream, int* grid_out) {
  auto kernel = fused_decode_kernel<TW, TC>;
  constexpr int smem = smem_bytes<TW>();
  static SmemLimit limit;           // set once a device
  static GridCache grids;           // found once a device
  static TensorMaps tmaps;          // encoded once a weight set
  int grid = 0;
  cudaError_t err = grids.get(kernel, smem, limit, &grid);
  if (err == cudaSuccess) err = tmaps.get(a, (int)sizeof(TW), &a.tmaps, &a.tmap_ok);
  if (err != cudaSuccess) return (int)err;
  if (grid_out) *grid_out = grid;
  // the heads a task holds, enough (row, head chunk, part) tasks to cover
  // the grid once, and as many cache slots a pass as the attention stage's
  // shared memory holds
  const int G = a.H / a.Hkv, tcb = (int)sizeof(TC);
  a.attn_heads = attn_heads(G, a.dh, tcb);
  const int chunks = a.R * a.Hkv * ((G + a.attn_heads - 1) / a.attn_heads);
  a.parts = chunks >= grid ? 1 : min(PMAX, grid / chunks);
  a.attn_slots = min(SC, (ATTN_SMEM / 4 - attn_fixed_floats(a.attn_heads, a.dh)) /
                             attn_slot_floats(a.attn_heads, a.dh, tcb));
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(THREADS), params, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

#ifdef FUSED_DECODE_CLOCKS
// The phase clocks so far into out[16] (then zeroed), for the probe.
extern "C" int fused_decode_clocks(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, clocks, sizeof(clocks));
  const unsigned long long zero[16] = {};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(clocks, zero, sizeof(zero));
  return (int)err;
}
#endif

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
  a.logits = (float*)meta[i++];
  a.rowmax = (float*)meta[i++];
  a.rowlse = (float*)meta[i++];
  a.stdv = (float*)meta[i++];
  a.part_ml = (float*)meta[i++];
  a.part_acc = (float*)meta[i++];
  a.cnt = (int*)meta[i++];
  a.stamps = (unsigned long long*)meta[i++];
  a.nstamps = (int)meta[i++];
  a.host_layers = (const long long*)meta[i++];
  a.parts = a.attn_slots = a.attn_heads = 1;
  const int G = a.Hkv > 0 ? a.H / a.Hkv : 0;
  if (a.dh > MAX_DH || a.rot > a.dh || G < 1 || G * a.Hkv != a.H)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (tw == 0 && tc == 0) return launch<float, float>(a, s, grid_out);
  if (tw == 0 && tc == 1) return launch<float, bf16>(a, s, grid_out);
  if (tw == 1 && tc == 1) return launch<bf16, bf16>(a, s, grid_out);
  if (tw == 1 && tc == 0) return launch<bf16, float>(a, s, grid_out);
  return (int)cudaErrorInvalidValue;
}
