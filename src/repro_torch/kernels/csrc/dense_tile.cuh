// A block-level dense tile for Hopper (sm_90a), shared by fused_plan.cu and
// masked_ffn.cu:
//
//     out[T x N] = act(in[T x K] . W[K x N] (+ b) (+ bp))
//
// Activation tiles are k-major: element (voxel t, feature k) lives at
// tile[k * ldt + t], ldt = T + 8. Staged weights are row-major [round8(K)][N]
// as stored (one bulk copy), rows past K zero. Activation rows past a width
// up to the next multiple of 8 are zero (an epilogue writes zeros there), so
// a product may run K to a multiple of 8; columns past N read the next
// row's weights, which only ever reach padded output columns.
//
// Three paths, by shape:
//  * tensor cores (tc_dense; T % 16 == 0, weights in shared memory, N >= 4):
//    mma.sync m16n8k8 on tf32 operands with fp32 accumulation, each fp32
//    operand split as x = hi + lo (hi: x cut to tf32, lo = x - hi) and
//    each product taken as lo.hi + hi.lo + hi.hi ("3xTF32"): the dropped
//    lo.lo and the bits of lo the tensor cores ignore are below 2^-19 of
//    |a.b|, so a dot matches fp32 to about 1e-6 relative. A warp job is 16
//    voxels x up to 32 columns (4 n-tiles); fragments are scalar shared
//    loads, the A fragments on distinct banks (ldt is 8 or 24 mod 32). On
//    the card this beat 4 x 4 and 8 x 8 CUDA-core micro-tiles at the IVIM
//    widths (PERF.md).
//  * CUDA cores (dense_cc; the shared prefix, whose weights stay in device
//    memory, and tiles that are not a multiple of 16 voxels): a 4 x 4
//    register micro-tile a thread, two float4 shared loads for 16 FMAs.
//  * narrow outputs (N < 4, the 52 -> 1 sigmoid head of an IVIM row): a
//    split-K dot, S lanes a (voxel, column), reduced with warp shuffles.
//
// Staging: stage_bulk lands a matrix in shared memory by the copy engine
// (cp.async.bulk, completing on an mbarrier) where it is 16-byte aligned,
// and by per-thread cp.async (stage_rows) where it is not, so a caller can
// overlap the copy of the next row's parameters with the current row's
// products. An int8 weight is staged as int8 and widened once a row by
// dequant_rows, float(q) * float(s): exact in fp32 (8 bits times an 8-bit
// mantissa), so the products use the values of the plain version. Widening
// where each product reads it would repeat the conversion once a warp job
// on the 16-a-clock conversion unit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace dense_tile {

constexpr int kPad = 8;             // ldt = T + kPad: 8 or 24 mod 32 for T % 16 == 0
constexpr int kNT = 4;              // n-tiles (8 columns each) of a tensor-core warp job

enum { kIdentity = 0, kRelu = 1, kGelu = 2, kSilu = 3, kSigmoid = 4, kTanh = 5 };

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }
__host__ __device__ constexpr int round8(int n) { return (n + 7) & ~7; }

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

// ---- PTX: cp.async, mma.sync, bulk copies (nvcc; a host build for
// rehearsing the index math supplies its own) --------------------------------
#ifdef __CUDACC__
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// d += a . b on one 16 x 8 x 8 tile (fragments in the PTX ISA's m16n8k8
// .tf32 layouts: a0 (g, c), a1 (g + 8, c), a2 (g, c + 4), a3 (g + 8, c + 4);
// b0 (k = c, n = g), b1 (c + 4, g); d0/d1 (g, 2c / 2c + 1), d2/d3 (g + 8, ...),
// g = lane / 4, c = lane % 4).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm(  // not volatile: the compiler may interleave independent tiles
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// ---- bulk copies (the copy engine) completing on an mbarrier in shared
// memory ----
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// An mbarrier whose phases each take one arrival (plus the bytes it expects).
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// The phase's one arrival, expecting `bytes` from its bulk copies.
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n"
      :
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
}
// bytes (a multiple of 16) from src to dst, both 16-byte aligned.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :
      : "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// 16 (4) bytes global -> shared of which the first `bytes` are read from
// src (aligned as the copy) and the rest zero-filled; lands after the
// caller's cp_async_commit / cp_async_wait.
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, unsigned bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4_zfill(void* dst, const void* src, unsigned bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}
// The box at (c0 inner, c1 outer) of a 2D tensor map (a CUtensorMap in
// device memory) to dst, completing on `bar` with the box's bytes (zeros
// where the box passes the tensor's edge).
__device__ __forceinline__ void tma_load_2d(void* dst, const void* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n"
      :
      : "r"(smem_u32(dst)), "l"(map), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}
// Orders this thread's earlier generic accesses to shared memory before
// later bulk copies (the async proxy) into the same bytes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// The same for device memory: this thread's generic writes before bulk
// copies (after a barrier, from any thread) that read them.
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}
// ---- bf16 fragments (m16n8k16) ----
// Four 8 x 8 b16 matrices from shared memory: lane l gives the 16-byte row
// l % 8 of matrix l / 8; register q of lane t holds matrix q's row t / 4,
// columns 2 (t % 4) and + 1 (low half first). With .trans, column t / 4,
// rows 2 (t % 4) and + 1: a row-major [k][n] tile read as A[n][k].
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
// d += a . b on one 16 x 8 x 16 tile, bf16 operands, fp32 accumulation
// (PTX ISA layouts: a0 (g, 2c | 2c + 1), a1 (g + 8, ...), a2 (g, 2c + 8 |
// 2c + 9), a3 (g + 8, ...); b0 (k = 2c | 2c + 1, n = g), b1 (k = 2c + 8 |
// 2c + 9, n = g); d as in mma_tf32). A bf16 x bf16 product is exact in fp32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm(  // not volatile: the compiler may interleave independent tiles
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
#endif

// x = hi + mid + lo, each part x's remainder rounded to bf16 (nearest): x's
// 24 significant bits in three 8-bit pieces, so the sum is x exactly (for
// |x| above bf16's normal floor, 2^-126). Three bf16 products on one weight
// fragment then give w . x as fp32 would, but for the order of the sums.
__device__ __forceinline__ void split_bf16x3(float x, __nv_bfloat16& hi, __nv_bfloat16& mid,
                                             __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(x);
  const float r1 = x - __bfloat162float(hi);
  mid = __float2bfloat16_rn(r1);
  lo = __float2bfloat16_rn(r1 - __bfloat162float(mid));
}

// Copy rows x cols elements of `esize` bytes from src (row stride lds
// elements, device memory) to dst (row stride ldd elements, shared memory),
// all threads of the block taking part. The cp.async part lands after the
// caller's cp_async_commit / cp_async_wait and a barrier; the plain part
// after the barrier alone.
__device__ inline void stage_rows(void* dst, int ldd, const void* src, long long lds, int rows,
                                  int cols, int esize) {
  if (rows <= 0 || cols <= 0) return;
  if (lds == cols && ldd == cols) {   // contiguous on both sides: one long row
    cols *= rows;
    rows = 1;
  }
  const char* s = static_cast<const char*>(src);
  char* d = static_cast<char*>(dst);
  const int rb = cols * esize, db = ldd * esize;
  const long long sb = lds * esize;
  // one mask test a chunk size (a 64-bit % would cost more than the copy)
  const unsigned long long bits = reinterpret_cast<uintptr_t>(s) |
                                  reinterpret_cast<uintptr_t>(d) | (unsigned)rb |
                                  (rows == 1 ? 0ull : (unsigned long long)(sb | db));
  const int chunk = (bits & 15) == 0 ? 16 : (bits & 3) == 0 ? 4 : 1;
  // element e = (r, c) walks the rows x (rb / chunk) grid by blockDim steps
  const int per_row = rb / chunk, step = blockDim.x;
  int r = threadIdx.x / per_row, c = threadIdx.x % per_row;
  const int dr = step / per_row, dc = step % per_row;
  for (; r < rows; r += dr, c += dc) {
    if (c >= per_row) {
      c -= per_row;
      ++r;
      if (r >= rows) break;
    }
    char* to = d + r * db + c * chunk;
    const char* from = s + r * sb + c * chunk;
    if (chunk == 16)
      cp_async16(to, from);
    else if (chunk == 4)
      cp_async4(to, from);
    else
      *to = *from;
  }
}

// The same copy through the copy engine where source, destination and the
// row strides are 16-byte aligned (one bulk copy for a contiguous matrix,
// one a row otherwise, completing on `bar`), and through stage_rows where
// they are not. Every thread returns the bytes sent through `bar` (the same
// value), which the phase's one arrival announces (mbar_arrive_tx).
// Per-thread copies are held to the SM's few outstanding requests, so
// their issue waits on their arrival; a bulk copy is one instruction. No
// proxy fence: the copy engine never writes where threads wrote, and the
// barrier before every re-stage orders the threads' earlier reads.
__device__ inline unsigned stage_bulk(void* dst, int ldd, const void* src, long long lds,
                                      int rows, int cols, int esize, uint64_t* bar) {
  if (rows <= 0 || cols <= 0) return 0;
  if (lds == cols && ldd == cols) {   // contiguous on both sides: one long row
    cols *= rows;
    rows = 1;
  }
  const unsigned rb = (unsigned)cols * esize;
  const long long sb = lds * esize, db = (long long)ldd * esize;
  const unsigned long long bits = reinterpret_cast<uintptr_t>(src) |
                                  reinterpret_cast<uintptr_t>(dst) | rb |
                                  (rows == 1 ? 0ull : (unsigned long long)(sb | db));
  if (bits & 15) {
    stage_rows(dst, ldd, src, lds, rows, cols, esize);
    return 0;
  }
  for (int r = threadIdx.x; r < rows; r += blockDim.x)
    bulk_copy(static_cast<char*>(dst) + r * db, static_cast<const char*>(src) + r * sb, rb, bar);
  return rb * (unsigned)rows;
}

// dst[r][c] (row stride ldd) = float(q[r * cols + c]) * float(scale[c]) for
// an int8 matrix staged contiguously in shared memory, scale in device
// memory; rows [rows, round8(rows)) of dst are zeroed. The caller holds a
// barrier before (q landed) and after.
__device__ inline void dequant_rows(float* dst, int ldd, const int8_t* q, int rows, int cols,
                                    const __nv_bfloat16* scale) {
  // a thread keeps one column (and its scale) over rows r0, r0 + per, ...
  for (int c0 = 0; c0 < cols; c0 += blockDim.x) {
    const int w = min(cols - c0, (int)blockDim.x), per = blockDim.x / w;
    const int c = c0 + threadIdx.x % w, r0 = threadIdx.x / w;
    if (r0 >= per) continue;
    const float sc = __bfloat162float(scale[c]);
    for (int r = r0; r < rows; r += per) dst[r * ldd + c] = (float)q[r * cols + c] * sc;
  }
  for (int e = threadIdx.x; e < (round8(rows) - rows) * ldd; e += blockDim.x)
    dst[rows * ldd + e] = 0.f;
}

// Zero rows [r0, r1) of a tile with row stride ld (shared memory).
__device__ inline void zero_rows(float* tile, int ld, int r0, int r1) {
  for (int e = threadIdx.x; e < (r1 - r0) * ld; e += blockDim.x) tile[r0 * ld + e] = 0.f;
}

// ---- the tensor-core path --------------------------------------------------

// x = hi + lo: hi is x cut to a tf32 (its top 19 bits), lo = x - hi exactly
// in fp32; the tensor cores read lo's top 19 bits, so lo . b misses at most
// 2^-10 of |lo| <= 2^-10 |x|. Two full-rate instructions, where
// cvt.rna.tf32.f32 runs on the 16-a-clock conversion unit.
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// acc[j] += A[m0:m0+16, 0:K] . w[0:K, n0 + 8j : n0 + 8j + 8] for j < nt
// (warp-uniform), A(m, k) at in[m * sm + k * sk] — a k-major tile (1, ldt)
// or row-major rows (ld, 1) — and K a multiple of 8 whose padding is zero
// in both.
__device__ __forceinline__ void tc_fma(float (&acc)[kNT][4], const float* in, int sm, int sk,
                                       int m0, const float* w, int ldw, int n0, int nt, int K) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const float* ap = in + (m0 + g) * sm + c * sk;
  const float* bp = w + c * ldw + n0 + g;
  for (int k0 = 0; k0 < K; k0 += 8) {
    unsigned ah[4], al[4], bh[kNT][2], bl[kNT][2];
    split_tf32(ap[0], ah[0], al[0]);
    split_tf32(ap[8 * sm], ah[1], al[1]);
    split_tf32(ap[4 * sk], ah[2], al[2]);
    split_tf32(ap[8 * sm + 4 * sk], ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      if (j < nt) {
        split_tf32(bp[8 * j], bh[j][0], bl[j][0]);
        split_tf32(bp[4 * ldw + 8 * j], bh[j][1], bl[j][1]);
      }
    }
    // the small terms first; consecutive mma go to different tiles, so no
    // mma waits on the one just issued
#pragma unroll
    for (int j = 0; j < kNT; ++j)
      if (j < nt) mma_tf32(acc[j], al, bh[j]);
#pragma unroll
    for (int j = 0; j < kNT; ++j)
      if (j < nt) mma_tf32(acc[j], ah, bl[j]);
#pragma unroll
    for (int j = 0; j < kNT; ++j)
      if (j < nt) mma_tf32(acc[j], ah, bh[j]);
    ap += 8 * sk;
    bp += 8 * ldw;
  }
}

// A warp job of a T x N product: voxels [m0, m0 + 16), n-tiles from n0.
struct TcJob {
  int m0, n0, nt;
};
__device__ __forceinline__ TcJob tc_job(int job, int T, int N) {
  const int mt = T / 16, tiles = (N + 7) / 8, grp = job / mt;
  return {(job % mt) * 16, grp * kNT * 8, min(kNT, tiles - grp * kNT)};
}
__device__ __forceinline__ int tc_jobs(int T, int N) {
  return T / 16 * (((N + 7) / 8 + kNT - 1) / kNT);
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// out[n][m0 + i] = act((acc + b[n]) + bp[n]) for the job's columns n < N,
// and 0 for n in [N, round8(N)).
template <typename Bv>
__device__ __forceinline__ void tc_store(float* out, int ldt, const TcJob& jb, int N,
                                         const float (&acc)[kNT][4], const Bv* b,
                                         const float* bp, int act) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    if (j >= jb.nt) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = jb.n0 + 8 * j + 2 * c + h;
      const bool live = n < N;
      const float bv = live && b ? to_float(b[n]) : 0.f, bpv = live && bp ? bp[n] : 0.f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float v = (acc[j][2 * r + h] + bv) + bpv;
        out[n * ldt + jb.m0 + g + 8 * r] = live ? activate(v, act) : 0.f;
      }
    }
  }
}

// One dense step on the tensor cores: w in shared memory, [round8(K)][ldw].
__device__ inline void tc_dense(const float* in, float* out, int ldt, int T, const float* w,
                                int ldw, const float* b, const float* bp, int K, int N, int act) {
  const int jobs = tc_jobs(T, N);
  for (int job = threadIdx.x >> 5; job < jobs; job += blockDim.x >> 5) {
    const TcJob jb = tc_job(job, T, N);
    float acc[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
    tc_fma(acc, in, 1, ldt, jb.m0, w, ldw, jb.n0, jb.nt, round8(K));
    tc_store(out, ldt, jb, N, acc, b, bp, act);
  }
}

// ---- the CUDA-core paths ---------------------------------------------------

// Weight sources: row k, columns n0 .. n0 + 3 (zero past N).
// fp32 in shared memory, row stride ld (columns past N are the next row's:
// they only reach padded outputs).
struct SmemW {
  const float* w;
  int ld;
  __device__ __forceinline__ float4 row4(int k, int n0) const {
    const float* p = w + k * ld + n0;
    if (!(ld & 3)) return *reinterpret_cast<const float4*>(p);
    return make_float4(p[0], p[1], p[2], p[3]);
  }
  __device__ __forceinline__ float at(int k, int n) const { return w[k * ld + n]; }
};

// fp32 [K][N] in device memory (a shared-prefix step).
struct GlobalW {
  const float* w;
  int n;
  __device__ __forceinline__ float at(int k, int c) const { return w[(size_t)k * n + c]; }
  __device__ __forceinline__ float4 row4(int k, int n0) const {
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = n0 + j < n ? at(k, n0 + j) : 0.f;
    return make_float4(v[0], v[1], v[2], v[3]);
  }
};

// int8 [K][N] in device memory with bf16 column scales (a shared-prefix step).
struct GlobalQ {
  const int8_t* q;
  const __nv_bfloat16* s;
  int n;
  __device__ __forceinline__ float at(int k, int c) const {
    return (float)q[(size_t)k * n + c] * __bfloat162float(s[c]);
  }
  __device__ __forceinline__ float4 row4(int k, int n0) const {
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = n0 + j < n ? at(k, n0 + j) : 0.f;
    return make_float4(v[0], v[1], v[2], v[3]);
  }
};

// N < 4: S lanes split K for each (voxel, column), S a power of two (<= 8)
// with T * N * S <= blockDim.x; partial sums meet by warp shuffles. The loop
// bound is warp-aligned so every lane of a warp reaches each shuffle.
template <class W>
__device__ void dense_narrow(const float* in, float* out, int ldt, int T, const W& w,
                             const float* b, const float* bp, int K, int N, int act) {
  int S = 1;
  while (S < 8 && T * N * S * 2 <= (int)blockDim.x) S *= 2;
  const int items = T * N * S, bound = (items + 31) & ~31;
  for (int p = threadIdx.x; p < bound; p += blockDim.x) {
    const bool live = p < items;
    const int s = p % S, q = p / S, t = q % T, n = q / T;
    float acc = 0.f;
    if (live)
      for (int k = s; k < K; k += S) acc = fmaf(in[k * ldt + t], w.at(k, n), acc);
    for (int m = S / 2; m > 0; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
    if (live && s == 0) {
      float v = acc;
      if (b) v += b[n];
      if (bp) v += bp[n];
      out[n * ldt + t] = activate(v, act);
    }
  }
}

// A 4 x 4 register micro-tile a thread (T % 4 == 0).
template <class W>
__device__ void dense_cc(const float* in, float* out, int ldt, int T, const W& w, const float* b,
                         const float* bp, int K, int N, int act) {
  const int nrg = T / 4, items = nrg * ((N + 3) / 4);
  for (int p = threadIdx.x; p < items; p += blockDim.x) {
    const int t0 = (p % nrg) * 4, n0 = (p / nrg) * 4;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 2
    for (int k = 0; k < K; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(in + k * ldt + t0);
      const float4 v = w.row4(k, n0);
      const float av[4] = {a.x, a.y, a.z, a.w}, wv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + j;
      if (n >= N) break;
      const float bv = b ? b[n] : 0.f, bpv = bp ? bp[n] : 0.f;
      float4 o;
      o.x = activate((acc[0][j] + bv) + bpv, act);
      o.y = activate((acc[1][j] + bv) + bpv, act);
      o.z = activate((acc[2][j] + bv) + bpv, act);
      o.w = activate((acc[3][j] + bv) + bpv, act);
      *reinterpret_cast<float4*>(out + n * ldt + t0) = o;
    }
  }
}

// One dense step over a T-voxel tile (T % 4 == 0), every thread of the block
// taking part; rows [N, round8(N)) of `out` come out zero. b and bp may be
// null. The caller holds a barrier after it.
template <class W>
__device__ void dense(const float* in, float* out, int ldt, int T, const W& w, const float* b,
                      const float* bp, int K, int N, int act) {
  if (N < 4)
    dense_narrow(in, out, ldt, T, w, b, bp, K, N, act);
  else
    dense_cc(in, out, ldt, T, w, b, bp, K, N, act);
  zero_rows(out, ldt, N, round8(N));
}
__device__ inline void dense(const float* in, float* out, int ldt, int T, const SmemW& w,
                             const float* b, const float* bp, int K, int N, int act) {
  if (N >= 4 && T % 16 == 0)                   // zeroes its padding itself
    tc_dense(in, out, ldt, T, w.w, w.ld, b, bp, K, N, act);
  else
    dense<SmemW>(in, out, ldt, T, w, b, bp, K, N, act);
}

// An elementwise activation over `width` features of a T-voxel tile; rows
// [width, round8(width)) come out zero.
__device__ inline void act_tile(const float* in, float* out, int ldt, int T, int width, int act) {
  for (int e = threadIdx.x; e < round8(width) * ldt; e += blockDim.x) {
    const int n = e / ldt;
    out[e] = n < width ? activate(in[e], act) : 0.f;
  }
}

// The rows [b0, b0 + valid) of a row-major [B, d] matrix, landed row-major
// at `rows` (a bulk copy), into a k-major tile: tile[c][t] for c < d, zeros
// past `valid` voxels and in rows [d, round8(d)). Shared memory to shared
// memory; the caller holds a barrier before and after.
__device__ inline void transpose_x(const float* rows, int d, int valid, float* tile, int ldt,
                                   int T) {
  // a warp moves a block of 4 voxels x 8 features at a time: lane (t, c) =
  // (lane % 4, lane / 4), so the reads rows[t][c] fall on distinct banks for
  // d = 8 mod 32 (the dense IVIM width 104) and the writes on two ways
  const int lane = threadIdx.x & 31, tl = lane & 3, cl = lane >> 2;
  const int nt = T / 4, blocks = nt * ((d + 7) / 8);
  for (int blk = threadIdx.x >> 5; blk < blocks; blk += blockDim.x >> 5) {
    const int t = (blk % nt) * 4 + tl, c = (blk / nt) * 8 + cl;
    if (c < d) tile[c * ldt + t] = t < valid ? rows[t * d + c] : 0.f;
  }
  zero_rows(tile, ldt, d, round8(d));
}

// x rows [b0, b0 + T) of a row-major [B, d] matrix into a k-major tile
// (columns [c0, c0 + cols) of x), as 4-byte cp.async copies: every element
// in flight at once, none through a register (the caller commits, waits and
// holds a barrier). Voxels past B and rows [cols, round8(cols)) are zeros.
__device__ inline void load_x_tile(const float* x, int B, int d, int b0, int c0, int cols,
                                   float* tile, int ldt, int T) {
  const int step = blockDim.x, dt = step / cols, dc = step % cols;
  int t = threadIdx.x / cols, c = threadIdx.x % cols;
  for (; t < T; t += dt, c += dc) {
    if (c >= cols) {
      c -= cols;
      ++t;
      if (t >= T) break;
    }
    if (b0 + t < B)
      cp_async4(tile + c * ldt + t, x + (size_t)(b0 + t) * d + c0 + c);
    else
      tile[c * ldt + t] = 0.f;
  }
  zero_rows(tile, ldt, cols, round8(cols));
}

}  // namespace dense_tile
