// Diagonal linear recurrence (the RG-LRU's inner loop) for Hopper (sm_90a):
// a chunked single-pass scan over time, forward and backward.
//
// Replaces: src/repro/kernels/rglru_scan/kernel.py:53 · rglru_scan_pallas
// (_rglru_kernel, pallas_call :66). For every channel (b, w) of a, b
// [B, S, W] (fp32, contiguous) it computes, from h_{-1} = 0,
//
//     h[b, t, w] = a[b, t, w] * h[b, t-1, w] + b[b, t, w]
//
// and writes every h [B, S, W] (fp32). The backward (training) replaces no
// TPU kernel: the reference differentiates its associative scan with XLA's
// autodiff. Given h and the gradient g = dL/dh it runs the same recurrence
// in reverse time,
//
//     dh[t] = g[t] + a[t+1] * dh[t+1],   dh[S] = 0
//     db[t] = dh[t],   da[t] = dh[t] * h[t-1],   h[-1] = 0 (so da[0] = 0).
//
// What bounds it: bytes. Forward: a and b read once, h written once, 12
// bytes an element for one FMA (126 MB, 37.6 us at 3.35 TB/s, at the served
// shape [32, 128, 2560]). Backward: a, h, g read once, da and db written
// once, 20 bytes an element for an FMA and a product.
//
// Design. Time is cut into chunks of L = kWarps * steps = 64 steps (forward
// and backward: a constant, so L depends on nothing). A block owns
// one (tile, chunk): a tile is 32 lanes of V channels of one batch row
// along W (V = 4, one 16-byte load a lane, where W % 4 == 0 and every base
// pointer is 16-byte aligned; V = 1 otherwise), so every warp access is
// one coalesced row segment. Warp k of the block owns `steps` consecutive
// steps of the chunk and keeps them in registers: the chunk is read from
// device memory once. Each block then
//   1. folds its steps from a zero state into a sub-chunk aggregate
//      (A = prod a, the local end value), and warp 0 folds the warps'
//      aggregates, in warp order, into the chunk's (A_c, L_c);
//   2. publishes (A_c, L_c) in the workspace with status "aggregate";
//   3. gets its carry-in from the chunks before it (the look-back below)
//      and publishes its inclusive value I_c = fmaf(A_c, carry, L_c) with
//      status "inclusive";
//   4. hands each warp its carry-in (warp aggregates folded in order) and
//      replays the staged steps from it with the sequential fmaf
//      recurrence, writing each output once.
// Backward blocks take their chunks from the end of time, each warp's
// coefficient row is a[t+1] and its h row h[t-1] (the rows are read
// shifted by one, so each element is still read once), and the folds run
// in reverse order; the code is otherwise shared.
//
// Fixed-order carry, hence determinism. The look-back walks back from the
// chunk before (in scan order) to the nearest one whose inclusive value is
// out (or to the first chunk), then folds forward from it over the
// aggregates in between: carry = fmaf(A_j, carry, L_j), j ascending. The
// inclusive values are defined by the same fold (I_j = fmaf(A_j, I_{j-1},
// L_j), I_{-1} = 0), so whichever predecessor a block finds published
// first, it computes the same fmaf chain over the same operands and gets
// the same bits. A CUB-style look-back that combines aggregates pairwise
// as they arrive would round by schedule; this one cannot. Each channel's
// result therefore depends only on its own row of a and b (a, h and g
// backward), on S and on L: two launches give equal bits, and a row of h
// does not depend on the batch it came in (V changes the loads, not the
// arithmetic).
//
// Scheduling. A block draws its (tile, chunk) from an atomic ticket at its
// start, chunk-major in scan order, so every predecessor it may wait for
// drew an earlier ticket and is already running: no launch order can
// deadlock it. Status words are published with a release store after a
// fence and polled with acquire loads; values are read through L2 (ld.cg).
//
// Workspaces. Launches on one workspace must run one after another: they
// share its ticket, count and epoch. An eager launch uses its (device,
// stream)'s, allocated by the C entry on first use and zeroed on the
// stream. A launch captured in a CUDA graph uses one that belongs to that
// capture and its stream (by capture id), allocated during the capture and
// zeroed by a memset node the graph runs before the capture's first scan
// on that stream, at every replay: graph launches of one instantiation run
// in turn, so a replay never shares a workspace with an eager launch, with
// another graph or with another replay, whatever stream it runs on. A
// workspace that must grow is replaced, never freed (the old one is kept
// alive: a graph may hold it), so the C entry never calls cudaFree. Each
// workspace's header holds the ticket, a count of the blocks done and an
// epoch: the launch's last block resets the first two and moves the epoch
// on. A status word is (epoch + 1) << 2 | status, so a word left by an
// earlier launch never reads as published, and the 64-bit epoch does not
// wrap. A block that waits on one status word for kSpinLimitNs traps (the
// launch fails) instead of hanging the card: in a correct launch every
// predecessor is running and publishes within microseconds. A mutex guards
// the host's table.
//
// Constants: 8 warps of 8 steps, forward and backward, 2 blocks an SM (the
// forward takes 128 registers at V = 4; the backward is held there by its
// launch bounds, its 24 staged float4s spilling a few words). Against
// these, in tuning builds on the card, 16 warps a block, 4-step warps,
// 128-step forward chunks, evict-first hints and one backward block an SM
// were no faster across the main path's shapes (PERF.md, row 7's findings).
//
// Rounding: within a chunk the kernel runs the sequential recurrence
// (fmaf, one rounding a step) from a carry that is a fold of fp32 chunk
// aggregates, each a product of at most L coefficients. With |a| < 1 the
// products decay and the carry's error does not grow with the number of
// chunks. Against the plain version (the reference's odd/even tree), on an
// NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py), 1.4e-6 max abs forward
// and 5.8e-7 of the gradient's magnitude backward: inside TOL_SCAN = 1e-5
// and TOL_SCAN_BWD_REL = 1e-5.

#include <cuda_runtime.h>

#include <algorithm>
#include <mutex>
#include <vector>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kFwdSteps = 8;   // the chunk: 64 steps forward
constexpr int kBwdSteps = 8;   // and backward
constexpr long long kSpinLimitNs = 2000000000;   // 2 s on one status word
constexpr unsigned long long kAggregate = 1, kInclusive = 2;

// The workspace's counters: the next ticket, the blocks done, the launches
// done (the epoch).
struct Header {
  unsigned ticket, done;
  unsigned long long epoch;
};

// A launch's view of its workspace: the header, one status word a (rank,
// tile) and three rows of tile-width floats beside it (A, L, I).
struct Space {
  Header* hdr;
  unsigned long long* status;
  float* vals;
};

template <int V>
__device__ __forceinline__ void load(const float* p, float (&x)[V]) {
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    x[0] = q.x, x[1] = q.y, x[2] = q.z, x[3] = q.w;
  } else {
    x[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float (&x)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    *p = x[0];
  }
}

__device__ __forceinline__ unsigned long long load_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" :: "l"(p), "l"(v) : "memory");
}

// Warp 0: make this lane's writes visible, then lane 0 flips the status.
__device__ __forceinline__ void publish(unsigned long long* status, unsigned long long tag,
                                        unsigned long long what) {
  __threadfence();
  __syncwarp();
  if ((threadIdx.x & 31) == 0) store_release(status, tag | what);
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Spin until the status word carries this launch's tag; returns the status.
// A word still unpublished after kSpinLimitNs traps.
__device__ __forceinline__ unsigned long long wait_status(const unsigned long long* status,
                                                          unsigned long long tag) {
  unsigned long long v = load_acquire(status);
  if ((v & ~3ull) == tag) return v & 3ull;
  const unsigned long long start = global_ns();
  while ((v & ~3ull) != tag) {
    if ((long long)(global_ns() - start) > kSpinLimitNs) __trap();
    __nanosleep(32);
    v = load_acquire(status);
  }
  return v & 3ull;
}

// The block's turn: its ticket (rank, the chunk in scan order, and tile)
// and this launch's status tag, (epoch + 1) << 2 (a zeroed word matches
// none).
struct Turn {
  unsigned ticket;
  unsigned long long tag;
};

__device__ __forceinline__ Turn take_turn(const Space& ws) {
  __shared__ Turn s_turn;
  if (threadIdx.x == 0) {
    s_turn.ticket = atomicAdd(&ws.hdr->ticket, 1u);
    s_turn.tag = (__ldcg(&ws.hdr->epoch) + 1) << 2;
  }
  __syncthreads();
  return s_turn;
}

// After the block's last status (once the count is full, every block has
// drawn its ticket): the launch's last block resets the ticket and the
// count for the next launch on this workspace and moves the epoch on.
__device__ __forceinline__ void end_turn(const Space& ws) {
  if (threadIdx.x == 0 && atomicAdd(&ws.hdr->done, 1u) == gridDim.x - 1) {
    ws.hdr->ticket = 0;
    ws.hdr->done = 0;
    ws.hdr->epoch += 1;
  }
}

// Warp 0 of rank r (of n_ranks) on tile `tile`: given this chunk's
// aggregate (cA, cL) per lane, publish it, fold the predecessors' in rank
// order into the carry-in (left in `carry`), publish the inclusive value.
template <int V>
__device__ __forceinline__ void chunk_carry(const Space& ws, unsigned long long tag, int r,
                                            int n_ranks, int tile, int n_tiles,
                                            const float (&cA)[V],
                                            const float (&cL)[V], float (&carry)[V]) {
  constexpr int TW = 32 * V;
  const int lane = threadIdx.x & 31;
  const size_t slot = (size_t)r * n_tiles + tile;
  float* mine = ws.vals + slot * 3 * TW;
  const bool has_next = r + 1 < n_ranks;
  if (has_next) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      mine[j * 32 + lane] = cA[j];
      mine[TW + j * 32 + lane] = cL[j];
    }
    publish(ws.status + slot, tag, kAggregate);
  }
#pragma unroll
  for (int j = 0; j < V; ++j) carry[j] = 0.f;
  if (r > 0) {
    // walk back to the nearest inclusive value, or to rank 0
    int k = r - 1;
    unsigned long long st = wait_status(ws.status + (size_t)k * n_tiles + tile, tag);
    while (st != kInclusive && k > 0) {
      --k;
      st = wait_status(ws.status + (size_t)k * n_tiles + tile, tag);
    }
    int from = k;   // first rank folded from its aggregate
    if (st == kInclusive) {
      const float* v = ws.vals + ((size_t)k * n_tiles + tile) * 3 * TW + 2 * TW;
#pragma unroll
      for (int j = 0; j < V; ++j) carry[j] = __ldcg(v + j * 32 + lane);
      from = k + 1;
    }
    for (int q = from; q < r; ++q) {
      const float* v = ws.vals + ((size_t)q * n_tiles + tile) * 3 * TW;
#pragma unroll
      for (int j = 0; j < V; ++j)
        carry[j] = fmaf(__ldcg(v + j * 32 + lane), carry[j], __ldcg(v + TW + j * 32 + lane));
    }
  }
  if (has_next) {
#pragma unroll
    for (int j = 0; j < V; ++j) mine[2 * TW + j * 32 + lane] = fmaf(cA[j], carry[j], cL[j]);
    publish(ws.status + slot, tag, kInclusive);
  }
}

// The block-level part shared by both directions, run by warp 0: the
// warps' aggregates (sA, sL; `warp_at(k)` is the k-th warp in scan order)
// are folded into the chunk's, the carry found, and each warp's carry-in
// left in sC.
template <int V, bool kReverse>
__device__ __forceinline__ void block_carries(const Space& ws, unsigned long long tag, int r,
                                              int n_ranks, int tile, int n_tiles,
                                              float (*sA)[32 * V],
                                              float (*sL)[32 * V], float (*sC)[32 * V]) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  auto warp_at = [](int k) { return kReverse ? kWarps - 1 - k : k; };
  float cA[V], cL[V], carry[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    cA[j] = sA[warp_at(0)][j * 32 + lane];
    cL[j] = sL[warp_at(0)][j * 32 + lane];
  }
#pragma unroll
  for (int k = 1; k < kWarps; ++k) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      cL[j] = fmaf(sA[warp_at(k)][j * 32 + lane], cL[j], sL[warp_at(k)][j * 32 + lane]);
      cA[j] *= sA[warp_at(k)][j * 32 + lane];
    }
  }
  chunk_carry<V>(ws, tag, r, n_ranks, tile, n_tiles, cA, cL, carry);
#pragma unroll
  for (int k = 0; k < kWarps; ++k) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      sC[warp_at(k)][j * 32 + lane] = carry[j];
      carry[j] = fmaf(sA[warp_at(k)][j * 32 + lane], carry[j], sL[warp_at(k)][j * 32 + lane]);
    }
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ h, int S, int W, int tiles_per_row, int n_tiles,
                  int n_chunks, Space ws) {
  constexpr int TW = 32 * V;
  constexpr int L = kWarps * kFwdSteps;
  __shared__ float sA[kWarps][TW], sL[kWarps][TW], sC[kWarps][TW];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Turn turn = take_turn(ws);
  const int r = (int)(turn.ticket / n_tiles), tile = (int)(turn.ticket % n_tiles);
  const int bi = tile / tiles_per_row;
  const int w = (tile % tiles_per_row) * TW + lane * V;
  const bool live = w < W;
  const int t0 = r * L + warp * kFwdSteps;
  const size_t row = (size_t)bi * S;

  float av[kFwdSteps][V], bv[kFwdSteps][V];
#pragma unroll
  for (int i = 0; i < kFwdSteps; ++i) {
    if (live && t0 + i < S) {
      load<V>(a + (row + t0 + i) * W + w, av[i]);
      load<V>(b + (row + t0 + i) * W + w, bv[i]);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) av[i][j] = 1.f, bv[i][j] = 0.f;
    }
  }
  float A[V], loc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) A[j] = 1.f, loc[j] = 0.f;
#pragma unroll
  for (int i = 0; i < kFwdSteps; ++i) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      loc[j] = fmaf(av[i][j], loc[j], bv[i][j]);
      A[j] *= av[i][j];
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) sA[warp][j * 32 + lane] = A[j], sL[warp][j * 32 + lane] = loc[j];
  __syncthreads();
  block_carries<V, false>(ws, turn.tag, r, n_chunks, tile, n_tiles, sA, sL, sC);
  __syncthreads();
  end_turn(ws);
  float c[V];
#pragma unroll
  for (int j = 0; j < V; ++j) c[j] = sC[warp][j * 32 + lane];
  if (!live) return;
#pragma unroll
  for (int i = 0; i < kFwdSteps; ++i) {
#pragma unroll
    for (int j = 0; j < V; ++j) c[j] = fmaf(av[i][j], c[j], bv[i][j]);
    if (t0 + i < S) store<V>(h + (row + t0 + i) * W + w, c);
  }
}

// Held to 2 blocks an SM (at most 128 registers a thread): at V = 4 its 24
// staged float4s alone would take it to one.
template <int V>
__global__ void __launch_bounds__(kThreads, 2)
rglru_scan_bwd_kernel(const float* __restrict__ a, const float* __restrict__ h,
                      const float* __restrict__ g, float* __restrict__ da,
                      float* __restrict__ db, int S, int W, int tiles_per_row, int n_tiles,
                      int n_chunks, Space ws) {
  constexpr int TW = 32 * V;
  constexpr int L = kWarps * kBwdSteps;
  __shared__ float sA[kWarps][TW], sL[kWarps][TW], sC[kWarps][TW];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Turn turn = take_turn(ws);
  const int r = (int)(turn.ticket / n_tiles), tile = (int)(turn.ticket % n_tiles);
  const int chunk = n_chunks - 1 - r;       // scan order runs from the end
  const int bi = tile / tiles_per_row;
  const int w = (tile % tiles_per_row) * TW + lane * V;
  const bool live = w < W;
  const int t0 = chunk * L + warp * kBwdSteps;
  const size_t row = (size_t)bi * S;

  // step t's coefficient a[t+1], its gradient g[t] and h[t-1]; zero past
  // either end (dh[S] = 0 needs no a[S]; h[-1] = 0)
  float an[kBwdSteps][V], gv[kBwdSteps][V], hp[kBwdSteps][V];
#pragma unroll
  for (int i = 0; i < kBwdSteps; ++i) {
    const int t = t0 + i;
#pragma unroll
    for (int j = 0; j < V; ++j) an[i][j] = 0.f, gv[i][j] = 0.f, hp[i][j] = 0.f;
    if (live && t + 1 < S) load<V>(a + (row + t + 1) * W + w, an[i]);
    if (live && t < S) load<V>(g + (row + t) * W + w, gv[i]);
    if (live && t >= 1 && t < S) load<V>(h + (row + t - 1) * W + w, hp[i]);
  }
  float A[V], loc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) A[j] = 1.f, loc[j] = 0.f;
#pragma unroll
  for (int i = kBwdSteps - 1; i >= 0; --i) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      loc[j] = fmaf(an[i][j], loc[j], gv[i][j]);
      A[j] *= an[i][j];
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) sA[warp][j * 32 + lane] = A[j], sL[warp][j * 32 + lane] = loc[j];
  __syncthreads();
  block_carries<V, true>(ws, turn.tag, r, n_chunks, tile, n_tiles, sA, sL, sC);
  __syncthreads();
  end_turn(ws);
  float c[V], d[V];
#pragma unroll
  for (int j = 0; j < V; ++j) c[j] = sC[warp][j * 32 + lane];
  if (!live) return;
#pragma unroll
  for (int i = kBwdSteps - 1; i >= 0; --i) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      c[j] = fmaf(an[i][j], c[j], gv[i][j]);
      d[j] = c[j] * hp[i][j];
    }
    if (t0 + i < S) {
      store<V>(db + (row + t0 + i) * W + w, c);
      store<V>(da + (row + t0 + i) * W + w, d);
    }
  }
}

// ---- host: the workspaces and the launches ---------------------------------

struct Workspace {
  int device;
  void* stream;
  unsigned long long capture;   // the capture's id; 0 for eager launches
  char* mem = nullptr;
  size_t status_cap = 0;   // status words
  size_t vals_cap = 0;     // floats
};

std::mutex g_mutex;
std::vector<Workspace> g_spaces;
std::vector<char*> g_retired;   // replaced workspaces, kept alive (a graph may hold one)

constexpr size_t kHeader = 256;   // the Header, padded
// an eager workspace's least size: one long request's [4, 4096, 2560] at
// V = 4 (80 tiles x 64 chunks) without a regrowth; capacities grow by
// doubling. A capture's is sized to its launch.
constexpr size_t kMinSlots = 8192;

size_t round_up(size_t n, size_t to) { return (n + to - 1) / to * to; }

// Under g_mutex: the workspace of this launch (its device and stream, and
// the stream's capture if one is under way), large enough for `slots`
// status words and `floats` values.
cudaError_t prepare(cudaStream_t stream, size_t slots, size_t floats, Workspace** out) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  cudaStreamCaptureStatus capturing = cudaStreamCaptureStatusNone;
  unsigned long long capture = 0;
  err = cudaStreamGetCaptureInfo(stream, &capturing, &capture);
  if (err != cudaSuccess) return err;
  if (capturing == cudaStreamCaptureStatusInvalidated) return cudaErrorStreamCaptureInvalidated;
  if (capturing == cudaStreamCaptureStatusNone) capture = 0;
  Workspace* ws = nullptr;
  for (auto& s : g_spaces)
    if (s.device == device && s.stream == (void*)stream && s.capture == capture) ws = &s;
  if (ws == nullptr) {
    g_spaces.push_back(Workspace{device, (void*)stream, capture});
    ws = &g_spaces.back();
  }
  if (slots > ws->status_cap || floats > ws->vals_cap) {
    const size_t least = capture ? 1 : kMinSlots;
    size_t status_cap = std::max(least, 2 * ws->status_cap);
    while (status_cap < slots) status_cap *= 2;
    size_t vals_cap = std::max(least * 3 * 32 * 4, 2 * ws->vals_cap);
    while (vals_cap < floats) vals_cap *= 2;
    char* mem = nullptr;
    const size_t bytes = kHeader + round_up(status_cap * 8, 256) + vals_cap * 4;
    // during a capture in the global or thread-local mode cudaMalloc is
    // refused unless this thread's mode is relaxed around it
    cudaStreamCaptureMode mode = cudaStreamCaptureModeRelaxed;
    if (capture) cudaThreadExchangeStreamCaptureMode(&mode);
    err = cudaMalloc(&mem, bytes);
    if (capture) cudaThreadExchangeStreamCaptureMode(&mode);
    if (err != cudaSuccess) return err;
    // on a capturing stream this is the graph's memset node
    err = cudaMemsetAsync(mem, 0, kHeader + status_cap * 8, stream);
    if (err != cudaSuccess) {
      g_retired.push_back(mem);
      return err;
    }
    if (ws->mem != nullptr) g_retired.push_back(ws->mem);
    ws->mem = mem, ws->status_cap = status_cap, ws->vals_cap = vals_cap;
  }
  *out = ws;
  return cudaSuccess;
}

Space view(const Workspace& ws) {
  return Space{reinterpret_cast<Header*>(ws.mem),
               reinterpret_cast<unsigned long long*>(ws.mem + kHeader),
               reinterpret_cast<float*>(ws.mem + kHeader + round_up(ws.status_cap * 8, 256))};
}

bool aligned16(const void* p) { return (reinterpret_cast<size_t>(p) & 15) == 0; }

// Grid of one direction: tiles of 32 * V channels, chunks of `chunk` steps.
struct Plan {
  int tiles_per_row, n_tiles, n_chunks;
  unsigned blocks;
};

bool plan_for(int B, int S, int W, int V, int chunk, Plan* p) {
  const int tw = 32 * V;
  const long long tiles_per_row = (W + tw - 1) / tw;
  const long long n_tiles = (long long)B * tiles_per_row;
  const long long n_chunks = (S + chunk - 1) / chunk;
  const long long blocks = n_tiles * n_chunks;
  if (n_tiles > 0x7fffffffLL || blocks > 0x7fffffffLL) return false;
  *p = Plan{(int)tiles_per_row, (int)n_tiles, (int)n_chunks, (unsigned)blocks};
  return true;
}

template <typename Launch>
int launch_scan(int B, int S, int W, int V, int chunk, void* stream, Launch&& go) {
  if (B < 1 || S < 1 || W < 1) return (int)cudaErrorInvalidValue;
  Plan p;
  if (!plan_for(B, S, W, V, chunk, &p)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  std::lock_guard<std::mutex> lock(g_mutex);
  Workspace* ws = nullptr;
  cudaError_t err = prepare(st, p.blocks, (size_t)p.blocks * 3 * 32 * V, &ws);
  if (err != cudaSuccess) return (int)err;
  go(p, view(*ws), st);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int rglru_scan_launch(const float* a, const float* b, float* h, int B, int S, int W,
                                 void* stream) {
  const int V = (W % 4 == 0 && aligned16(a) && aligned16(b) && aligned16(h)) ? 4 : 1;
  return launch_scan(B, S, W, V, kWarps * kFwdSteps, stream,
                     [&](const Plan& p, const Space& ws, cudaStream_t st) {
    if (V == 4)
      rglru_scan_kernel<4><<<p.blocks, kThreads, 0, st>>>(a, b, h, S, W, p.tiles_per_row,
                                                          p.n_tiles, p.n_chunks, ws);
    else
      rglru_scan_kernel<1><<<p.blocks, kThreads, 0, st>>>(a, b, h, S, W, p.tiles_per_row,
                                                          p.n_tiles, p.n_chunks, ws);
  });
}

// The backward: a, h (the forward's output) and g = dL/dh [B, S, W] fp32 ->
// da, db [B, S, W] fp32. Launches on `stream`; returns cudaGetLastError().
extern "C" int rglru_scan_bwd_launch(const float* a, const float* h, const float* g, float* da,
                                     float* db, int B, int S, int W, void* stream) {
  const int V = (W % 4 == 0 && aligned16(a) && aligned16(h) && aligned16(g) &&
                 aligned16(da) && aligned16(db)) ? 4 : 1;
  return launch_scan(B, S, W, V, kWarps * kBwdSteps, stream,
                     [&](const Plan& p, const Space& ws, cudaStream_t st) {
    if (V == 4)
      rglru_scan_bwd_kernel<4><<<p.blocks, kThreads, 0, st>>>(
          a, h, g, da, db, S, W, p.tiles_per_row, p.n_tiles, p.n_chunks, ws);
    else
      rglru_scan_bwd_kernel<1><<<p.blocks, kThreads, 0, st>>>(
          a, h, g, da, db, S, W, p.tiles_per_row, p.n_tiles, p.n_chunks, ws);
  });
}
