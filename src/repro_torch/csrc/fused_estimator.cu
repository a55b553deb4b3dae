// fused_estimator: the stratified estimator of Algorithms 3 + 4 over the
// gathered candidate rows, and its backward.
//
// Replaces the Pallas TPU kernel
// repro/kernels/fused_estimator.py::fused_estimator (grid (t, m): the
// scalar-prefetched candidate ids pick one embedding row per grid step, and a
// running max / sum / d-wide weighted row sum in scratch carries over the m
// axis — the online softmax of flash attention) and the backward of its custom
// VJP (repro/core/estimators.py::_fused_logz_bwd, which gathers the (t, m, d)
// candidate rows in HBM again and scatter-adds p·h into d_emb).
//
//   forward:  log_z[t] = log Σ_j exp(y_tj),  expv[t] = Σ_j softmax_j · E[ids_tj]
//             with y_tj = E[ids_tj] · h_t + log_w_tj
//   backward: p_tj = exp(y_tj - log_z[t]) · g[t]
//             d_emb[r] = Σ_{(t,j): ids_tj = r} p_tj · h_t
//
// What bounds them on an H100: bytes. The forward reads t·m candidate rows
// of d values and does 4·d flops per row (dot + weighted sum): one flop per
// byte for fp32 rows. Its least traffic reads each distinct live row once;
// the rows a launch names repeat (a training chunk's 256 tokens name ~2,000
// popular top-k rows ~70 times each, and ~30,000 tail rows ~4.6 times), so
// a kernel that reads a row once per use moves ~10x the bound through L2.
// The backward writes the dense (n, d) fp32 d_emb (262 MB at n 32,000, d
// 2,048) and reads p's inputs and h once (~0.08 ms); its (row, token) pairs
// read h_t from shared memory, 8 KB a pair at d 2,048 (~2.4 GB at a
// 256-token head chunk, ~0.1 ms on 132 SMs), beside the writes. On an H100
// it runs at about twice that, bound by latency.
//
// Forward design: one kernel family, chosen by a rule on the shapes alone
// (kernels/fused_estimator.py::route). It enqueues up to eight kernels and
// one memset, reads nothing back, and can be captured in a CUDA graph.
//
//   1. The plan, where t >= 2R and t·m >= n (fused_estimator_{count,tile,
//      compact}_kernel). It counts, in int32, the live slots naming each
//      table row (integer atomics, so the counts do not depend on order).
//      Rows named at least R = 32 times form U. They are numbered in row
//      order by one two-level scan: a count per tile of 2,048 rows, then
//      each tile adds the tiles before it. At most ``cap`` = 8,192 rows are
//      numbered; the rest stay on the walk. A row -> column map is
//      written over the counts, with the device-side count |U|.
//      Why R = 32: a dense column costs t TF32 dot products (three passes)
//      in each product, whether a token names the row or not; a row read
//      costs one use. At t 256 the measured break-even lies between 16 and
//      32 uses. With R = 16, a chunk whose S is uniform over 32,000 rows
//      (~9 uses a row) put ~670 rows of 16–25 uses into U, and the call
//      took 0.8615 ms against 0.7380 with R = 32, where those rows stay
//      on the walk (H100, kernel_ab.py); the ~2,000 popular rows (~66
//      uses each) reach U either way.
//   2. The dense chain, on a side stream forked after the plan and joined
//      before the combine. Tensor cores are busy here while the rows' walk
//      beside it waits on memory:
//      * fused_estimator_dense_score_kernel: Y = H · Uᵀ (t x |U|) with
//        mma.sync m16n8k8 TF32 in three passes. Each operand is split
//        x = hi + lo at TF32; the passes lo·hi, hi·lo, hi·hi run each over
//        a warp's 8 accumulators in turn, with fp32 sums (error ~2^-21).
//        bf16 rows are exact in TF32 and skip hi·lo. The reduction axis
//        is cut into splits of 512 and walked through a 3-stage cp.async
//        ring. The last split to arrive at a tile's integer counter adds
//        the splits' partials in split order. Grid sized for the cap:
//        blocks past |U| return at once.
//      * fused_estimator_dense_weights_kernel, one block a token: the
//        popular slots' y = Y[t, col] + log_w, their max M_U and sum S_U,
//        and the token's row of P_U = Σ exp(y - M_U) over the slots that
//        name each row. The sum runs in slot order; the lanes of a warp
//        naming one column are summed by their leader in lane order.
//      * fused_estimator_dense_sum_kernel: E_U = P_U · U, the same three
//        passes, split over U by 512 rows.
//   3. The rows' walk, on the caller's stream, enqueued before the dense
//      chain so that its blocks are dispatched first. Dead slots (weight
//      -inf) add exactly nothing and are skipped unread, and so are slots
//      of rows in U. A warp folds the rest 32 slots' ids and weights at a
//      time (fold_rows): F rows loaded at once, all of a batch's loads
//      issued before any row is scored, F = 8, 4, 4, 2, 1, 1 for d up to
//      128, 256, 512, 1,024, 2,048, 4,096. Each row is scored against h in
//      shared memory with explicit fmaf and a fixed xor butterfly (lane l
//      holds the float4 groups l, l+32, ...; bf16 rows as 8-byte loads
//      upcast exactly) and folded into the warp's running (max, sum,
//      d-wide sum) in registers; the warps merge in warp order. Two walks:
//      * fused_estimator_band_kernel, where the plan ran and m <= 4,096:
//        one block of 4 warps a token, so that a 256-token chunk is
//        resident at once. The block sorts its slots stably by the band of
//        their row (equal bands of the table, at most 16 MiB of fp32 rows
//        each, so that one fits in the 50 MB L2), then walks the bands in
//        order. The blocks sweep the table nearly in step, so a tail row
//        fetched from HBM for one token is read from L2 by the others that
//        name it: at the training chunk, ~30,000 tail rows used ~4.6 times
//        each are fetched ~once instead of ~4 times (the walk went from
//        0.42 to 0.21 ms with every S slot dead, H100, kernel_ab.py).
//      * fused_estimator_stream_kernel, grid (range, token), elsewhere: a
//        block of 8 warps takes one token and one contiguous range of its
//        slots, each warp a contiguous share. The range count fills the
//        132 SMs twice over at the blocks an SM holds. Each (token, range)
//        writes its partial.
//      The walk and the dense kernels ask for the SM's largest shared-
//      memory carve-out, so that a dense block fits beside walk blocks.
//   4. fused_estimator_combine_kernel, one block a token: merges the walk's
//      partials in range order, then (M_U, S_U, E_U), into log_z and
//      expv = V / S.
// The running max starts at -1e30, as the Pallas kernel's does, so an
// all-dead token gives log_z = -inf and expv = NaN, as there. Every slot's
// y is written when asked for (-inf on dead slots), by the walk or the
// weights kernel, for the backward. No float atomics anywhere: every sum
// runs in an order fixed by the shapes and the ids, so a result depends on
// the inputs alone. The (t, m, d) gather never exists in device memory.
//
// Backward design: an SpMM, d_emb = Pᵀ·H, deterministic, no float atomics.
// y comes from the forward, not from a re-score: the training path runs the
// backward right after the checkpoint's recompute of the same forward, and
// re-scoring read every candidate row and h_t once more through L2 (~4.8 GB
// a chunk, what bounded the earlier one-block-a-row kernel at 0.74 ms). The
// wrapper sorts the flat candidate ids once (stable) and finds each table
// row's segment with a binary search. Grid (d-slice of 128 columns, group of
// 32 warps): a block stages h[:, slice] in shared memory (128 KB at t 256).
// Each warp of a slice owns a run of whole rows, split by entries + a row's
// write cost (a 16-ary search over the offsets per half-warp, no atomics);
// the runs are dealt to the blocks in turn, so popular rows spread over the
// SMs. A warp walks its rows in order: 128 entries at a time it computes p
// = exp(y - log_z) · g, the positions loaded one batch ahead (each entry's
// p is written by one slice, e % slices), then lane l folds p · h[tok,
// 4l..4l+3] into registers entry by entry in segment order with fmaf, from
// 0 — the order of the one-block-a-row kernel, so d_emb keeps its bits —
// and writes the row's slice once. Rows no candidate touches are written as
// zeros. The kernel is latency-bound: 32 warps an SM, one float4 a lane.
// Where h's slice outgrows shared memory the block walks the tokens in
// tiles: a segment's tokens ascend, each partial row is carried through
// d_emb between tiles (a float store and load are exact), and an entry of
// another tile folds p = 0 against zeros, which leaves the sum as it was.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>
#include <mutex>
#include <type_traits>
#include <utility>

#include "pdl.cuh"
#include "row_dot.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNeg = -1e30f;  // the Pallas kernel's running-max sentinel

// the plan: R, the live uses that put a row into U (why 32: the header;
// kernels/fused_estimator.py's POPULAR_USES mirrors it); a compaction
// thread owns kPlanRows consecutive table rows
constexpr int kPopularUses = 32;
constexpr int kPlanRows = 8;
constexpr int kPlanTile = kThreads * kPlanRows;
// the weights kernel stages a token's slots kStage at a time for the P_U scatter
constexpr int kStage = 1024;
// the band walk: 4 warps a token, so that two blocks of a d-2,048 token fit
// an SM and a 256-token chunk is resident at once; at most kMaxBands bands
// (a token's band-sorted slot list lives in shared memory)
constexpr int kBandWarps = 4;
constexpr int kBandThreads = kBandWarps * 32;
constexpr int kMaxBands = 32;

// the tensor-core products: a block of 4 warps owns a 64 x 64 output tile,
// a warp 32 x 32 of it (2 x 4 mma tiles of 16 x 8), the reduction walked
// kDepth at a time; row strides padded so that fragment loads hit 32
// distinct banks
constexpr int kTile = 64;
constexpr int kDepth = 32;
constexpr int kMmaThreads = 128;
// at most ~100 registers a thread, so that a product's block fits in what
// two d-2,048 band-walk blocks leave of an SM's registers (beside them)
constexpr int kMmaBlocks = 5;
constexpr int kPadK = kDepth + 4;  // (64 rows, kDepth) tiles, k fastest
constexpr int kPadN = kTile + 8;   // (kDepth rows, 64) tiles, n fastest
constexpr int kStages = 3;         // tiles in flight a block (cp.async ring)
// the reduction axis split over the grid, kSplitTiles steps of kDepth a
// block (512 of d, or 512 popular rows), so that ~4 blocks of 4 warps share
// an SM: one warp a scheduler could not hide its own latencies
constexpr int kSplitTiles = 16;

// backward: 32 warps share one slice of h; lane l owns the slice's columns
// 4l..4l+3; each warp owns a run of whole rows
constexpr int kBwdWarps = 32;
constexpr int kBwdThreads = kBwdWarps * 32;
constexpr int kSliceCols = 128;
constexpr int kRowCost = 4;  // a row's write, in segment entries' work
constexpr int kBatch = 128;  // entries whose p a warp computes at once

// Float4 group g of a row, upcast to fp32 (bf16 -> fp32 is exact).
__device__ __forceinline__ float4 load_group(const float* row, int g) {
  return __ldg(reinterpret_cast<const float4*>(row) + g);
}

__device__ __forceinline__ float4 load_group(const __nv_bfloat16* row, int g) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(row) + g);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// ------------------------------------------------------------ the plan
// Sum of v over the block; every thread gets it. red: kWarps ints.
__device__ __forceinline__ int block_sum(int v, int* red) {
  v = __reduce_add_sync(kFull, v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int s = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += red[w];
  __syncthreads();  // red may be reused
  return s;
}

// counts[r] += 1 for every live slot naming row r (ids clamped by the caller)
__global__ void __launch_bounds__(kThreads)
    fused_estimator_count_kernel(const int* __restrict__ ids,
                                 const float* __restrict__ log_w,
                                 int* __restrict__ counts, int total) {
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < total;
       i += gridDim.x * kThreads)
    if (__ldg(log_w + i) != -INFINITY) atomicAdd(counts + __ldg(ids + i), 1);
}

// tiles[b] = the rows of tile b (kPlanTile rows) named at least R times
__global__ void __launch_bounds__(kThreads)
    fused_estimator_tile_kernel(const int* __restrict__ counts,
                                int* __restrict__ tiles, int n) {
  __shared__ int red[kWarps];
  const int r0 = blockIdx.x * kPlanTile;
  const int r1 = min(n, r0 + kPlanTile);
  int c = 0;
  for (int r = r0 + threadIdx.x; r < r1; r += kThreads)
    c += __ldg(counts + r) >= kPopularUses;
  c = block_sum(c, red);
  if (threadIdx.x == 0) tiles[blockIdx.x] = c;
}

// Numbers the popular rows in row order: colmap[r] (the counts, overwritten)
// becomes r's column in U or -1; rows[col] = r for col < cap; the last
// block writes |U| = min(popular rows, cap).
__global__ void __launch_bounds__(kThreads)
    fused_estimator_compact_kernel(int* __restrict__ colmap,
                                   const int* __restrict__ tiles,
                                   int* __restrict__ rows,
                                   int* __restrict__ n_u, int n, int cap) {
  __shared__ int red[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int pre = 0;  // the popular rows of the tiles before this one
  for (int i = threadIdx.x; i < blockIdx.x; i += kThreads) pre += tiles[i];
  pre = block_sum(pre, red);
  const int r0 = blockIdx.x * kPlanTile + threadIdx.x * kPlanRows;
  const bool whole = r0 + kPlanRows <= n;  // 8 rows: two 16-byte accesses
  int cnt[kPlanRows];
  if (whole) {
    const int4 u = reinterpret_cast<const int4*>(colmap + r0)[0];
    const int4 w = reinterpret_cast<const int4*>(colmap + r0)[1];
    cnt[0] = u.x, cnt[1] = u.y, cnt[2] = u.z, cnt[3] = u.w;
    cnt[4] = w.x, cnt[5] = w.y, cnt[6] = w.z, cnt[7] = w.w;
  } else {
#pragma unroll
    for (int i = 0; i < kPlanRows; ++i)
      cnt[i] = r0 + i < n ? colmap[r0 + i] : 0;
  }
  int mine = 0;
#pragma unroll
  for (int i = 0; i < kPlanRows; ++i) mine += cnt[i] >= kPopularUses;
  // exclusive scan of ``mine`` over the block, in thread order
  int x = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) red[warp] = x;
  __syncthreads();
  int col = pre + x - mine;
  for (int w = 0; w < warp; ++w) col += red[w];
#pragma unroll
  for (int i = 0; i < kPlanRows; ++i) {
    const bool popular = cnt[i] >= kPopularUses;
    const int c = popular && col < cap ? col : -1;
    if (c >= 0) rows[c] = r0 + i;
    col += popular;
    cnt[i] = c;
  }
  if (whole) {
    reinterpret_cast<int4*>(colmap + r0)[0] =
        make_int4(cnt[0], cnt[1], cnt[2], cnt[3]);
    reinterpret_cast<int4*>(colmap + r0)[1] =
        make_int4(cnt[4], cnt[5], cnt[6], cnt[7]);
  } else {
#pragma unroll
    for (int i = 0; i < kPlanRows; ++i)
      if (r0 + i < n) colmap[r0 + i] = cnt[i];
  }
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == kThreads - 1)
    *n_u = min(col, cap);
}

// ------------------------------------------------- tensor-core products
__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo: hi the nearest TF32 value, lo the nearest TF32 of the rest
// (x - hi is exact in fp32); |x - hi - lo| <= 2^-22 |x|
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One warp's 32 x 32 share (rows wm*32.., columns wn*32..) of a 64 x 64
// tile over kDepth of the reduction: A from ``as`` (64, kPadK), k fastest;
// B(k, n) from ``b_at``. Three passes per product, the small ones first:
// lo·hi, hi·lo, hi·hi; kExactB (B exact in TF32) drops hi·lo. Each pass
// runs over the warp's 8 accumulators before the next, so no mma waits on
// the one before it.
template <bool kExactB, typename BAt>
__device__ __forceinline__ void warp_tile_mma(float (&acc)[2][4][4],
                                              const float* as, BAt b_at,
                                              int wm, int wn, int lane) {
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int kk = 0; kk < kDepth; kk += 8) {
    unsigned ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float* a = as + (wm * 32 + i * 16 + g) * kPadK + kk + q;
      split_tf32(a[0], ah[i][0], al[i][0]);                // (g, q)
      split_tf32(a[8 * kPadK], ah[i][1], al[i][1]);        // (g + 8, q)
      split_tf32(a[4], ah[i][2], al[i][2]);                // (g, q + 4)
      split_tf32(a[8 * kPadK + 4], ah[i][3], al[i][3]);    // (g + 8, q + 4)
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int nn = wn * 32 + j * 8 + g;
      split_tf32(b_at(kk + q, nn), bh[j][0], bl[j][0]);
      split_tf32(b_at(kk + q + 4, nn), bh[j][1], bl[j][1]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_tf32(acc[i][j], al[i], bh[j]);
    if (!kExactB) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32(acc[i][j], ah[i], bl[j]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_tf32(acc[i][j], ah[i], bh[j]);
  }
}

// cp.async of one float4 group (4 values: 16 bytes fp32, 8 bytes bf16) of a
// row into shared memory; a false ``pred`` writes zeros and reads nothing.
__device__ __forceinline__ void copy_group(float* dst, const float* src,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void copy_group(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 8 : 0));
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most kStages - 2 groups of this thread are in flight.
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// After a block of a split product wrote its partial tile: true in the
// block that arrives last at its tile's counter (integer atomics), which
// then sums the splits' partials in split order, so the result does not
// depend on the arrival order. The last block resets the counter to 0.
__device__ __forceinline__ bool last_of_splits(int* counter, int splits) {
  __shared__ int last;
  __threadfence();  // this block's partial before its arrival
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(counter, 1) == splits - 1;
    if (last) *counter = 0;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// Shared memory of the products: kStages stages of an A tile (64, kPadK)
// fp32 and a B tile of T (64 x kPadK elements, or kDepth x kPadN).
template <typename T>
constexpr size_t mma_smem() {
  return kStages * (sizeof(float) * kTile * kPadK + sizeof(T) * kTile * kPadK);
}

// Y[tok, c] = h[tok] · emb[rows[c]] for the c < |U| popular rows: a block
// a (64 tokens, 64 columns) tile, the d axis kDepth at a time through a
// ring of kStages tiles in flight (cp.async), so a block's serial walk over
// d waits on one load latency, not one a step.
template <typename T>
__global__ void __launch_bounds__(kMmaThreads, kMmaBlocks)
    fused_estimator_dense_score_kernel(const T* __restrict__ emb,
                                       const float* __restrict__ h,
                                       const int* __restrict__ rows,
                                       const int* __restrict__ n_u,
                                       float* __restrict__ yd,
                                       float* __restrict__ ypart,
                                       int* __restrict__ counters, int d,
                                       int t, int cap) {
  extern __shared__ __align__(16) unsigned char mma_smem_raw[];
  float* as = reinterpret_cast<float*>(mma_smem_raw);       // (stage, 64, kPadK)
  T* bs = reinterpret_cast<T*>(as + kStages * kTile * kPadK);  // (stage, 64, kPadK)
  const int nu = *n_u;
  const int c0 = blockIdx.x * kTile, t0 = blockIdx.y * kTile;
  if (c0 >= nu) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const int d4 = d >> 2;
  // this thread's 4 of the tile's 64 rows x 8 float4 groups, A and B
  const float* arow[4];
  const T* brow[4];
  bool aok[4], bok[4];
  int grp[4], off[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int i = threadIdx.x + s * kMmaThreads;
    const int r = i >> 3;
    grp[s] = i & 7;
    off[s] = r * kPadK + grp[s] * 4;
    aok[s] = t0 + r < t;
    bok[s] = c0 + r < nu;
    arow[s] = h + static_cast<size_t>(aok[s] ? t0 + r : 0) * d;
    brow[s] = emb + static_cast<size_t>(bok[s] ? rows[c0 + r] : 0) * d;
  }
  // this block's split of d: steps [k_lo, k_hi) of kDepth
  const int k_lo = blockIdx.z * kSplitTiles;
  const int nk = min((d + kDepth - 1) / kDepth - k_lo, kSplitTiles);
  auto issue = [&](int kt) {
    if (kt < nk) {
      float* a = as + (kt % kStages) * kTile * kPadK;
      T* b = bs + (kt % kStages) * kTile * kPadK;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int gk = (k_lo + kt) * (kDepth / 4) + grp[s];
        const bool in = gk < d4;
        copy_group(a + off[s], arow[s] + (in ? gk * 4 : 0), aok[s] && in);
        copy_group(b + off[s], brow[s] + (in ? gk * 4 : 0), bok[s] && in);
      }
    }
    copy_commit();
  };
#pragma unroll
  for (int kt = 0; kt < kStages - 1; ++kt) issue(kt);
  float acc[2][4][4] = {};
  for (int kt = 0; kt < nk; ++kt) {
    copy_wait();
    __syncthreads();  // tile kt landed everywhere; tile kt-1's readers done
    issue(kt + kStages - 1);
    const T* b = bs + (kt % kStages) * kTile * kPadK;
    warp_tile_mma<std::is_same<T, __nv_bfloat16>::value>(
        acc, as + (kt % kStages) * kTile * kPadK,
        [&](int k, int c) { return to_float(b[c * kPadK + k]); }, wm, wn,
        lane);
  }
  const int g = lane >> 2, q = lane & 3;
  const int splits = gridDim.z;
  const size_t plane = static_cast<size_t>(t) * cap;
  float* out = splits > 1 ? ypart + blockIdx.z * plane : yd;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tok = t0 + wm * 32 + i * 16 + g + (e >> 1) * 8;
        const int c = c0 + wn * 32 + j * 8 + 2 * q + (e & 1);
        if (tok < t && c < nu) out[static_cast<size_t>(tok) * cap + c] =
            acc[i][j][e];
      }
  if (splits == 1 ||
      !last_of_splits(counters + blockIdx.y * gridDim.x + blockIdx.x, splits))
    return;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tok = t0 + wm * 32 + i * 16 + g + (e >> 1) * 8;
        const int c = c0 + wn * 32 + j * 8 + 2 * q + (e & 1);
        if (tok < t && c < nu) {
          const size_t at = static_cast<size_t>(tok) * cap + c;
          float sum = __ldcg(ypart + at);
          for (int z = 1; z < splits; ++z) sum += __ldcg(ypart + z * plane + at);
          yd[at] = sum;
        }
      }
}

// eu[tok] = Σ_c P[tok, c] · emb[rows[c]] over the c < |U| popular rows: a
// block a (64 tokens, 64 of d) tile, its split of U kDepth rows at a time
// through the same ring. P's rows are zero from |U| up to the next multiple
// of kDepth (the weights kernel writes them so).
template <typename T>
__global__ void __launch_bounds__(kMmaThreads, kMmaBlocks)
    fused_estimator_dense_sum_kernel(const T* __restrict__ emb,
                                     const float* __restrict__ pmat,
                                     const int* __restrict__ rows,
                                     const int* __restrict__ n_u,
                                     float* __restrict__ eu,
                                     float* __restrict__ opart,
                                     int* __restrict__ counters, int d, int t,
                                     int cap) {
  extern __shared__ __align__(16) unsigned char mma_smem_raw[];
  float* as = reinterpret_cast<float*>(mma_smem_raw);       // (stage, 64, kPadK)
  T* bs = reinterpret_cast<T*>(as + kStages * kTile * kPadK);  // (stage, kDepth, kPadN)
  __shared__ int srows[kSplitTiles * kDepth];  // the split's rows of U
  const int nu = *n_u;
  // this block's split of U: steps [k_lo, k_lo + nk) of kDepth rows
  const int steps = (nu + kDepth - 1) / kDepth;
  const int splits = (steps + kSplitTiles - 1) / kSplitTiles;
  if (static_cast<int>(blockIdx.z) >= splits) return;
  const int k_lo = blockIdx.z * kSplitTiles;
  const int nk = min(steps - k_lo, kSplitTiles);
  const int n0 = blockIdx.x * kTile, t0 = blockIdx.y * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const int d4 = d >> 2;
  for (int i = threadIdx.x; i < kSplitTiles * kDepth; i += kMmaThreads) {
    const int k = k_lo * kDepth + i;
    srows[i] = k < nu ? rows[k] : 0;
  }
  __syncthreads();
  auto issue = [&](int kt0) {
    const int kt = k_lo + kt0;
    if (kt0 < nk) {
      float* a = as + (kt % kStages) * kTile * kPadK;
      T* b = bs + (kt % kStages) * kDepth * kPadN;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int i = threadIdx.x + s * kMmaThreads;
        // A: 64 tokens x 8 groups of P's columns
        const int tr = i >> 3, ga = i & 7;
        const bool aok = t0 + tr < t;
        copy_group(a + tr * kPadK + ga * 4,
                   pmat + static_cast<size_t>(aok ? t0 + tr : 0) * cap +
                       kt * kDepth + ga * 4,
                   aok);
        // B: kDepth rows x 16 groups of d
        const int kr = i >> 4, gb = i & 15;
        const int k = kt * kDepth + kr;
        const bool bok = k < nu && (n0 >> 2) + gb < d4;
        copy_group(b + kr * kPadN + gb * 4,
                   emb + static_cast<size_t>(srows[kt0 * kDepth + kr]) * d +
                       (bok ? n0 + gb * 4 : 0),
                   bok);
      }
    }
    copy_commit();
  };
#pragma unroll
  for (int kt = 0; kt < kStages - 1; ++kt) issue(kt);
  float acc[2][4][4] = {};
  for (int kt0 = 0; kt0 < nk; ++kt0) {
    const int kt = k_lo + kt0;
    copy_wait();
    __syncthreads();
    issue(kt0 + kStages - 1);
    const T* b = bs + (kt % kStages) * kDepth * kPadN;
    warp_tile_mma<std::is_same<T, __nv_bfloat16>::value>(
        acc, as + (kt % kStages) * kTile * kPadK,
        [&](int k, int c) { return to_float(b[k * kPadN + c]); }, wm, wn,
        lane);
  }
  const int g = lane >> 2, q = lane & 3;
  const size_t plane = static_cast<size_t>(t) * d;
  float* out = splits > 1 ? opart + blockIdx.z * plane : eu;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int tok = t0 + wm * 32 + i * 16 + g + e2 * 8;
      if (tok >= t) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e1 = 0; e1 < 2; ++e1) {
          const int c = n0 + wn * 32 + j * 8 + 2 * q + e1;
          if (c < d) out[static_cast<size_t>(tok) * d + c] =
              acc[i][j][e2 * 2 + e1];
        }
    }
  if (splits == 1 ||
      !last_of_splits(counters + blockIdx.y * gridDim.x + blockIdx.x, splits))
    return;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int tok = t0 + wm * 32 + i * 16 + g + e2 * 8;
      if (tok >= t) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e1 = 0; e1 < 2; ++e1) {
          const int c = n0 + wn * 32 + j * 8 + 2 * q + e1;
          if (c >= d) continue;
          const size_t at = static_cast<size_t>(tok) * d + c;
          float sum = __ldcg(opart + at);
          for (int z = 1; z < splits; ++z) sum += __ldcg(opart + z * plane + at);
          eu[at] = sum;
        }
    }
}

// A block a token, after the dense scores: its popular slots' scores y =
// Y[tok, col] + log_w (written to y_out), their max M_U and sum S_U =
// Σ exp(y - M_U) (u_stat[tok], u_stat[t + tok]), and the token's row of
// P_U relative to M_U (pmat, stride cap): P_U[tok, col] = Σ exp(y - M_U)
// over the slots naming that row, added in slot order (the lanes of a warp
// naming one column are summed by their leader in lane order).
__global__ void __launch_bounds__(kThreads)
    fused_estimator_dense_weights_kernel(const int* __restrict__ ids,
                                         const float* __restrict__ log_w,
                                         const int* __restrict__ colmap,
                                         const float* __restrict__ yd,
                                         const int* __restrict__ n_u,
                                         float* __restrict__ y_out,
                                         float* __restrict__ u_stat,
                                         float* __restrict__ pmat, int t,
                                         int m, int cap) {
  // the P_U row (cap), then the (column, value) of kStage slots
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[kWarps];
  const int tok = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nu = *n_u;
  if (nu == 0) {  // no popular row: the tensor-core kernels return at once
    if (threadIdx.x == 0) {
      u_stat[tok] = kNeg;
      u_stat[t + tok] = 0.f;
    }
    return;
  }
  const size_t row0 = static_cast<size_t>(tok) * m;
  const float* ytok = yd + static_cast<size_t>(tok) * cap;
  // the max over the token's popular slots (exact in any order)
  float mx = kNeg;
  for (int j = threadIdx.x; j < m; j += kThreads) {
    const float lw = __ldg(log_w + row0 + j);
    if (lw == -INFINITY) continue;
    const int col = __ldg(colmap + __ldg(ids + row0 + j));
    if (col < 0) continue;
    const float y = ytok[col] + lw;
    mx = fmaxf(mx, y);
    if (y_out != nullptr) y_out[row0 + j] = y;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
  if (lane == 0) red[warp] = mx;
  const int nu_pad = (nu + kDepth - 1) / kDepth * kDepth;
  float* prow = smem;
  int* st_col = reinterpret_cast<int*>(prow + cap);
  float* st_val = reinterpret_cast<float*>(st_col + kStage);
  for (int c = threadIdx.x; c < nu_pad; c += kThreads) prow[c] = 0.f;
  __syncthreads();
  mx = red[0];
  for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, red[w]);
  for (int s0 = 0; s0 < m; s0 += kStage) {
    const int len = min(kStage, m - s0);
    for (int i = threadIdx.x; i < len; i += kThreads) {
      const float lw = __ldg(log_w + row0 + s0 + i);
      int col = -1;
      float val = 0.f;
      if (lw != -INFINITY) {
        col = __ldg(colmap + __ldg(ids + row0 + s0 + i));
        if (col >= 0) val = expf(ytok[col] + lw - mx);
      }
      st_col[i] = col;
      st_val[i] = val;
    }
    __syncthreads();
    if (warp == 0) {  // slot order: chunks in turn, a column's lanes in order
      for (int c0 = 0; c0 < len; c0 += 32) {
        const int col = c0 + lane < len ? st_col[c0 + lane] : -1;
        const unsigned grp = __match_any_sync(kFull, col);
        if (col >= 0 && lane == __ffs(grp) - 1) {
          float acc = prow[col];
          for (unsigned bits = grp; bits; bits &= bits - 1)
            acc += st_val[c0 + __ffs(bits) - 1];
          prow[col] = acc;
        }
        __syncwarp();
      }
    }
    __syncthreads();
  }
  // S_U: the row's columns summed in a fixed order; the row written out
  float su = 0.f;
  float* prow_out = pmat + static_cast<size_t>(tok) * cap;
  for (int c = threadIdx.x; c < nu_pad; c += kThreads) {
    su += prow[c];
    prow_out[c] = prow[c];
  }
  su = repro_torch::warp_butterfly(su);
  __syncthreads();  // red's max readers are done
  if (lane == 0) red[warp] = su;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int w = 0; w < kWarps; ++w) total += red[w];
    u_stat[tok] = mx;
    u_stat[t + tok] = total;
  }
}

// ------------------------------------------------------------ the stream
// The warp's fold of the slots in ``todo`` (a ballot over its lanes; lane
// l's slot names row ``id`` with weight ``lw``): F rows loaded at once (all
// of a batch's loads issued before any row is scored), each scored against
// h4 (shared memory) with explicit fmaf and the fixed xor butterfly, then
// folded in lane order into the warp's running (max, sum, d-wide sum).
// Lane l gets its slot's score in my_y. All 32 lanes call it together.
template <typename T, int C, int F>
__device__ __forceinline__ void fold_rows(unsigned todo, int id, float lw,
                                          const T* __restrict__ emb,
                                          const float4* h4, int d, int lane,
                                          float& run_m, float& run_s,
                                          float4 (&v)[C], float& my_y) {
  const int d4 = d >> 2;
  while (todo) {
    int sl[F];
#pragma unroll
    for (int f = 0; f < F; ++f) {
      sl[f] = todo ? __ffs(todo) - 1 : -1;
      todo &= todo - 1;
    }
    float4 x[F][C];
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const int rid = __shfl_sync(kFull, id, max(sl[f], 0));
      const T* row = emb + static_cast<size_t>(rid) * d;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int g = c * 32 + lane;
        x[f][c] = sl[f] >= 0 && g < d4 ? load_group(row, g)
                                       : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    float y[F];
#pragma unroll
    for (int f = 0; f < F; ++f) {
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int g = c * 32 + lane;
        if (g < d4) acc = repro_torch::fma4(acc, x[f][c], h4[g]);
      }
      y[f] = repro_torch::warp_butterfly(acc) +
             __shfl_sync(kFull, lw, max(sl[f], 0));
    }
    float m_new = run_m;
#pragma unroll
    for (int f = 0; f < F; ++f)
      if (sl[f] >= 0) m_new = fmaxf(m_new, y[f]);
    const float corr = expf(run_m - m_new);
    float p[F];
    run_s *= corr;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      p[f] = sl[f] >= 0 ? expf(y[f] - m_new) : 0.f;
      run_s += p[f];
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float4 u = v[c];
      u.x *= corr;
      u.y *= corr;
      u.z *= corr;
      u.w *= corr;
#pragma unroll
      for (int f = 0; f < F; ++f) {
        u.x = fmaf(p[f], x[f][c].x, u.x);
        u.y = fmaf(p[f], x[f][c].y, u.y);
        u.z = fmaf(p[f], x[f][c].z, u.z);
        u.w = fmaf(p[f], x[f][c].w, u.w);
      }
      v[c] = u;
    }
    run_m = m_new;
#pragma unroll
    for (int f = 0; f < F; ++f)
      if (lane == sl[f]) my_y = y[f];
  }
}


// Merges a block's W warps' running (max, sum, d-wide sum) in warp order:
// returns the block's (max, sum); sv (d,) then holds the d-wide sum scaled
// to that max. All threads call it together.
template <int W, int C>
__device__ __forceinline__ float2 merge_warps(float run_m, float run_s,
                                              const float4 (&v)[C],
                                              float* wmax, float* wsum,
                                              float* sv, int d4, int warp,
                                              int lane) {
  if (lane == 0) {
    wmax[warp] = run_m;
    wsum[warp] = run_s;
  }
  __syncthreads();
  float mx = kNeg;
  for (int w = 0; w < W; ++w) mx = fmaxf(mx, wmax[w]);
  float s = 0.f;
  for (int w = 0; w < W; ++w) s += wsum[w] * expf(wmax[w] - mx);
  const float scale = expf(run_m - mx);
  float4* sv4 = reinterpret_cast<float4*>(sv);
  for (int w = 0; w < W; ++w) {
    if (warp == w) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int g = c * 32 + lane;
        if (g < d4) {
          float4 cur = w == 0 ? make_float4(0.f, 0.f, 0.f, 0.f) : sv4[g];
          cur.x += v[c].x * scale;
          cur.y += v[c].y * scale;
          cur.z += v[c].z * scale;
          cur.w += v[c].w * scale;
          sv4[g] = cur;
        }
      }
    }
    __syncthreads();
  }
  return make_float2(mx, s);
}

// Block (range, token): the token's slots [range * span, +span), each warp
// a contiguous share of them, folded into one (max, sum, d-wide sum)
// partial. C: float4 groups per lane (C * 128 >= d); F: rows in flight a
// warp. colmap NULL: no plan (every live slot streams its row).
template <typename T, int C, int F>
__global__ void __launch_bounds__(kThreads)
    fused_estimator_stream_kernel(const T* __restrict__ emb,
                                  const int* __restrict__ ids,
                                  const float* __restrict__ h,
                                  const float* __restrict__ log_w,
                                  const int* __restrict__ colmap,
                                  float* __restrict__ y_out,
                                  float* __restrict__ part, int d, int t,
                                  int m, int span, int ranges) {
  extern __shared__ __align__(16) float smem[];
  float* sh = smem;      // (d,) the token's query
  float* sv = smem + d;  // (d,) the merged weighted row sum
  __shared__ float wmax[kWarps], wsum[kWarps];
  const int tok = blockIdx.y, range = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int d4 = d >> 2;

  repro_torch::load_query(sh, h + static_cast<size_t>(tok) * d, d);
  __syncthreads();
  const float4* h4 = reinterpret_cast<const float4*>(sh);

  const int j1 = min(m, (range + 1) * span);
  const int j0 = min(j1, range * span);
  const int share = (j1 - j0 + kWarps - 1) / kWarps;
  const int a = min(j1, j0 + warp * share), b = min(j1, a + share);
  const size_t row0 = static_cast<size_t>(tok) * m;

  float run_m = kNeg, run_s = 0.f;
  float4 v[C];
#pragma unroll
  for (int c = 0; c < C; ++c) v[c] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int base = a; base < b; base += 32) {
    const int j = base + lane;
    const bool in = j < b;
    const float lw = in ? __ldg(log_w + row0 + j) : -INFINITY;
    const bool live = lw != -INFINITY;
    const int id = live ? __ldg(ids + row0 + j) : 0;
    // popular rows are the dense kernels' (their y too)
    const bool popular = colmap != nullptr && live && __ldg(colmap + id) >= 0;
    float my_y = -INFINITY;

    // the other live slots: F rows loaded at once, then scored and folded
    fold_rows<T, C, F>(__ballot_sync(kFull, live && !popular), id, lw, emb,
                       h4, d, lane, run_m, run_s, v, my_y);
    if (y_out != nullptr && in && !popular) y_out[row0 + j] = my_y;
  }

  const float2 ms = merge_warps<kWarps, C>(run_m, run_s, v, wmax, wsum, sv,
                                          d4, warp, lane);
  const float mx = ms.x, s = ms.y;
  // partial (token, range): max at part[i], sum at part[t*ranges + i], the
  // d-wide sum at part[2*t*ranges + i*d ..], i = token * ranges + range
  const size_t i = static_cast<size_t>(tok) * ranges + range;
  float* pv = part + 2 * static_cast<size_t>(t) * ranges + i * d;
  for (int k = threadIdx.x; k < d; k += kThreads) pv[k] = sv[k];
  if (threadIdx.x == 0) {
    part[i] = mx;
    part[static_cast<size_t>(t) * ranges + i] = s;
  }
}

// The band walk, where the plan ran (rows repeat across the launch's tokens):
// a block of kBandWarps warps a token, small enough that every token's
// block is resident at once. The block sorts its live, non-popular slots
// stably by the band of their row (``bands`` equal bands of the table's
// rows, each small enough to stay in L2), then walks the bands in order,
// its warps a contiguous share of each band. The blocks sweep the table's
// rows nearly in step, so a row fetched from HBM for one token is read from
// L2 by the others that name it. One partial a token (ranges = 1).
// Shared memory: h and the merged sum (2d floats), then per slot its band
// (slot order), and the band-sorted slot, row and weight.
template <typename T, int C, int F>
__global__ void __launch_bounds__(kBandThreads)
    fused_estimator_band_kernel(const T* __restrict__ emb,
                                const int* __restrict__ ids,
                                const float* __restrict__ h,
                                const float* __restrict__ log_w,
                                const int* __restrict__ colmap,
                                float* __restrict__ y_out,
                                float* __restrict__ part, int n, int d, int t,
                                int m, int bands) {
  extern __shared__ __align__(16) float smem[];
  float* sh = smem;
  float* sv = smem + d;
  int* band_of = reinterpret_cast<int*>(sv + d);  // (m,) slot order
  int* lst_slot = band_of + m;                     // (m,) band order
  int* lst_id = lst_slot + m;
  float* lst_lw = reinterpret_cast<float*>(lst_id + m);
  __shared__ int start[kMaxBands + 1], base[kMaxBands];
  __shared__ int wcnt[kBandWarps][kMaxBands];
  __shared__ float wmax[kBandWarps], wsum[kBandWarps];
  const int tok = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d4 = d >> 2;
  const size_t row0 = static_cast<size_t>(tok) * m;

  repro_torch::load_query(sh, h + static_cast<size_t>(tok) * d, d);
  if (threadIdx.x <= kMaxBands) start[threadIdx.x] = 0;
  __syncthreads();
  // each slot's band (-1: dead, or a popular row's); the bands' sizes
  for (int j = threadIdx.x; j < m; j += kBandThreads) {
    const float lw = __ldg(log_w + row0 + j);
    int b = -1;
    if (lw != -INFINITY) {
      const int id = __ldg(ids + row0 + j);
      if (colmap == nullptr || __ldg(colmap + id) < 0)
        b = static_cast<int>(static_cast<long long>(id) * bands / n);
    } else if (y_out != nullptr) {
      y_out[row0 + j] = -INFINITY;
    }
    band_of[j] = b;
    if (b >= 0) atomicAdd(start + b + 1, 1);  // a count: order-free
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int b = 0; b < bands; ++b) start[b + 1] += start[b];
    for (int b = 0; b < bands; ++b) base[b] = start[b];
  }
  __syncthreads();
  // stable placement: 128 slots at a time, a band's slots by lane, then
  // by warp, in slot order
  for (int c0 = 0; c0 < m; c0 += kBandThreads) {
    const int j = c0 + threadIdx.x;
    const int b = j < m ? band_of[j] : -1;
    const unsigned grp = __match_any_sync(kFull, b);
    if (lane < kMaxBands) wcnt[warp][lane] = 0;
    __syncwarp();
    if (b >= 0 && lane == __ffs(grp) - 1) wcnt[warp][b] = __popc(grp);
    __syncthreads();
    if (b >= 0) {
      int pos = base[b] + __popc(grp & ((1u << lane) - 1u));
      for (int w = 0; w < warp; ++w) pos += wcnt[w][b];
      lst_slot[pos] = j;
      lst_id[pos] = __ldg(ids + row0 + j);
      lst_lw[pos] = __ldg(log_w + row0 + j);
    }
    __syncthreads();
    if (threadIdx.x < bands)
      for (int w = 0; w < kBandWarps; ++w) base[threadIdx.x] += wcnt[w][threadIdx.x];
    __syncthreads();
  }

  const float4* h4 = reinterpret_cast<const float4*>(sh);
  float run_m = kNeg, run_s = 0.f;
  float4 v[C];
#pragma unroll
  for (int c = 0; c < C; ++c) v[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int b = 0; b < bands; ++b) {
    const int share = (start[b + 1] - start[b] + kBandWarps - 1) / kBandWarps;
    const int a = start[b] + warp * share;
    const int e = min(start[b + 1], a + share);
    for (int i0 = a; i0 < e; i0 += 32) {
      const int i = i0 + lane;
      const bool in = i < e;
      const int id = in ? lst_id[i] : 0;
      const float lw = in ? lst_lw[i] : -INFINITY;
      float my_y = -INFINITY;
      fold_rows<T, C, F>(__ballot_sync(kFull, in), id, lw, emb, h4, d, lane,
                         run_m, run_s, v, my_y);
      if (y_out != nullptr && in) y_out[row0 + lst_slot[i]] = my_y;
    }
  }

  const float2 ms = merge_warps<kBandWarps, C>(run_m, run_s, v, wmax, wsum,
                                               sv, d4, warp, lane);
  float* pv = part + 2 * static_cast<size_t>(t) + static_cast<size_t>(tok) * d;
  for (int k = threadIdx.x; k < d; k += kBandThreads) pv[k] = sv[k];
  if (threadIdx.x == 0) {
    part[tok] = ms.x;
    part[t + tok] = ms.y;
  }
}

// A block a token: its ranges' partials merged in range order, then the
// popular rows' part (u_stat: M_U, S_U; eu: Σ P_U · U relative to M_U)
// where the plan found any (n_u not NULL and *n_u > 0), into log_z and expv
// = V / S.
__global__ void __launch_bounds__(kThreads)
    fused_estimator_combine_kernel(const float* __restrict__ part,
                                   const int* __restrict__ n_u,
                                   const float* __restrict__ u_stat,
                                   const float* __restrict__ eu,
                                   float* __restrict__ log_z,
                                   float* __restrict__ expv, int d, int t,
                                   int ranges) {
  extern __shared__ __align__(16) float scale[];  // (ranges,)
  __shared__ float s_m, s_s, s_u;
  const int tok = blockIdx.x;
  const bool dense = n_u != nullptr && *n_u > 0;
  const float* pm = part + static_cast<size_t>(tok) * ranges;
  const float* ps = pm + static_cast<size_t>(t) * ranges;
  const float* pv = part + 2 * static_cast<size_t>(t) * ranges +
                    static_cast<size_t>(tok) * ranges * d;
  if (threadIdx.x == 0) {
    const float mu = dense ? u_stat[tok] : kNeg;
    float mx = mu;
    for (int r = 0; r < ranges; ++r) mx = fmaxf(mx, pm[r]);
    float s = 0.f;
    for (int r = 0; r < ranges; ++r) s += ps[r] * expf(pm[r] - mx);
    const float su = expf(mu - mx);
    if (dense) s += u_stat[t + tok] * su;
    s_m = mx;
    s_s = s;
    s_u = su;
  }
  __syncthreads();
  const float mx = s_m, s = s_s, su = s_u;
  for (int r = threadIdx.x; r < ranges; r += kThreads)
    scale[r] = expf(pm[r] - mx);
  __syncthreads();
  float* out = expv + static_cast<size_t>(tok) * d;
  const float* eut = eu + static_cast<size_t>(tok) * d;
  for (int k = threadIdx.x; k < d; k += kThreads) {
    float acc = 0.f;
    for (int r = 0; r < ranges; ++r)
      acc = fmaf(pv[static_cast<size_t>(r) * d + k], scale[r], acc);
    if (dense) acc = fmaf(eut[k], su, acc);
    out[k] = acc / s;
  }
  if (threadIdx.x == 0) log_z[tok] = mx + logf(s);
}

// Row split among a slice's warps: the first row r in [0, n] whose weight
// offsets[r] + kRowCost * r reaches share b of ``parts`` of the total. The
// weight counts a row's entries and its write, so a warp of popular rows
// gets fewer of them. Each half-warp runs a 16-ary search for its own b
// (lanes 0-15 for b, 16-31 for b + 1); every lane of a half gets the
// answer.
__device__ __forceinline__ int row_split(const int* __restrict__ offsets,
                                         int n, int b, int parts, int lane) {
  const long long total = offsets[n] + static_cast<long long>(kRowCost) * n;
  const long long target = total * (b + (lane >> 4)) / parts;
  const int hl = lane & 15;
  int lo = 0, hi = n;  // the answer lies in [lo, hi]; weight(hi) >= target
  while (__any_sync(0xffffffffu, lo < hi)) {
    const int stride = (hi - lo + 15) / 16;
    const int pos = min(lo + hl * stride, hi);
    const bool reach =
        lo < hi && __ldg(offsets + pos) +
                           static_cast<long long>(kRowCost) * pos >= target;
    const unsigned ballot =
        (__ballot_sync(0xffffffffu, reach) >> (lane & 16)) & 0xffffu;
    if (lo < hi) {
      const int f = ballot ? __ffs(ballot) - 1 : 16;
      if (f == 0) {
        hi = lo;
      } else {
        const int new_hi = f < 16 ? min(lo + f * stride, hi) : hi;
        lo = lo + (f - 1) * stride + 1;
        hi = new_hi;
      }
    }
  }
  return lo;
}

// grid (d-slice of kSliceCols columns, group of kBwdWarps warps); each warp
// owns a run of whole rows of the slice. tile_t tokens of h's slice fit in
// shared memory; longer chunks are walked tile by tile.
__global__ void __launch_bounds__(kBwdThreads, 1)
    fused_estimator_bwd_spmm_kernel(const long long* __restrict__ order,
                                    const int* __restrict__ offsets,
                                    const float* __restrict__ h,
                                    const float* __restrict__ y,
                                    const float* __restrict__ log_z,
                                    const float* __restrict__ g,
                                    float* d_emb, float* __restrict__ p_out,
                                    int n, int d, int t, int m, int tile_t) {
  // h[tile, slice] as (tile_t, 32) float4 groups and a row of zeros, then
  // each warp's batch of kBatch entries (p, h offset)
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float4* sh = smem4;
  float2* batch =
      reinterpret_cast<float2*>(smem4 + (tile_t + 1) * 32) + warp * kBatch;
  const int zero_off = tile_t * 32;  // the row of zeros
  const int d4 = d >> 2;
  const int col4 = blockIdx.x * 32 + lane;  // this lane's float4 group
  const bool col_ok = col4 < d4;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  // the slice's runs of rows go to the blocks in turn, so that popular rows
  // (the first ids, in a vocabulary sorted by frequency) spread over the SMs
  const int split = row_split(offsets, n, warp * gridDim.y + blockIdx.y,
                              gridDim.y * kBwdWarps, lane);
  const int ra = __shfl_sync(0xffffffffu, split, 0);
  const int rb = __shfl_sync(0xffffffffu, split, 16);
  const int ea = __ldg(offsets + ra), eb = __ldg(offsets + rb);
  if (threadIdx.x < 32) sh[zero_off + threadIdx.x] = zero;

  int t0 = 0;
  do {  // once at least: t = 0 still writes every row's zeros
    const int t1 = min(t, t0 + tile_t);
    const bool first = t0 == 0;
    __syncthreads();  // the last tile's readers are done with sh
    for (int i = threadIdx.x; i < (t1 - t0) * 32; i += kBwdThreads) {
      const int c = blockIdx.x * 32 + (i & 31);
      sh[i] = c < d4 ? __ldg(reinterpret_cast<const float4*>(
                               h + static_cast<size_t>(t0 + (i >> 5)) * d) + c)
                     : zero;
    }
    __syncthreads();

    // the flat positions of the next batch, loaded one batch ahead
    int qn[kBatch / 32];
#pragma unroll
    for (int k = 0; k < kBatch / 32; ++k) {
      const int el = ea + k * 32 + lane;
      qn[k] = el < eb ? static_cast<int>(__ldg(order + el)) : 0;
    }
    int e = ea, base = ea - kBatch;  // batch holds entries [base, base+kBatch)
    for (int rc = ra; rc < rb; rc += 31) {  // 31 rows: 32 segment bounds
      const int nr = min(31, rb - rc);
      const int seg = lane <= nr ? __ldg(offsets + rc + lane) : 0;
      for (int i = 0; i < nr; ++i) {
        const int stop = __shfl_sync(0xffffffffu, seg, i + 1);
        float4* out =
            reinterpret_cast<float4*>(d_emb + static_cast<size_t>(rc + i) * d) +
            col4;
        if (e == stop) {  // no candidate names this row
          if (first && col_ok) *out = zero;
          continue;
        }
        // the earlier tiles' partial sum, carried through d_emb
        float4 a = first || !col_ok ? zero : __ldcg(out);
        do {
          if (e == base + kBatch) {  // p and h offsets of the next entries
            base = e;
            __syncwarp();  // every lane is done with the last batch
#pragma unroll
            for (int k = 0; k < kBatch / 32; ++k) {
              const int el = base + k * 32 + lane;
              float2 v = make_float2(0.f, __int_as_float(zero_off));
              if (el < eb) {
                // an entry of a token outside this tile folds p = 0 against
                // the row of zeros: the sum stays exactly as it was (it is
                // never -0)
                const int q = qn[k];
                const int tok = q / m;
                if (tok >= t0 && tok < t1) {
                  const float p = expf(__ldg(y + q) - __ldg(log_z + tok)) *
                                  __ldg(g + tok);
                  if (blockIdx.x == el % gridDim.x) p_out[q] = p;
                  v = make_float2(p, __int_as_float((tok - t0) * 32));
                }
              }
              batch[k * 32 + lane] = v;
              const int en = el + kBatch;
              qn[k] = en < eb ? static_cast<int>(__ldg(order + en)) : 0;
            }
            __syncwarp();
          }
          const int lim = min(stop, base + kBatch);
#pragma unroll 4
          for (; e < lim; ++e) {  // segment order, fmaf from 0: bitwise
            const float2 pe = batch[e - base];
            const float4 hv = sh[__float_as_int(pe.y) + lane];
            a.x = fmaf(pe.x, hv.x, a.x);
            a.y = fmaf(pe.x, hv.y, a.y);
            a.z = fmaf(pe.x, hv.z, a.z);
            a.w = fmaf(pe.x, hv.w, a.w);
          }
        } while (e < stop);
        if (col_ok) *out = a;
      }
    }
    t0 += tile_t;
  } while (t0 < t);
}

// The popular-row plan: colmap (n,) (zeroed counts, then columns), tiles,
// rows (cap,), n_u (1,). Returns the CUDA error code.
int launch_plan(const int* ids, const float* log_w, int* colmap, int* tiles,
                int* rows, int* n_u, int n, int t, int m, int cap,
                cudaStream_t s) {
  int sms = 0;
  const int e = repro_torch::sm_count(&sms);
  if (e) return e;
  const int total = t * m;
  const int count_blocks =
      std::max(1, std::min((total + kThreads - 1) / kThreads, sms * 8));
  fused_estimator_count_kernel<<<count_blocks, kThreads, 0, s>>>(
      ids, log_w, colmap, total);
  const int n_tiles = (n + kPlanTile - 1) / kPlanTile;
  fused_estimator_tile_kernel<<<n_tiles, kThreads, 0, s>>>(colmap, tiles, n);
  fused_estimator_compact_kernel<<<n_tiles, kThreads, 0, s>>>(
      colmap, tiles, rows, n_u, n, cap);
  return static_cast<int>(cudaGetLastError());
}

// The walk's (C, F) instances, one per width class: C float4 groups a lane,
// F rows in flight a warp, so that a warp keeps ~8 float4 loads a lane in
// flight at small d without spilling its registers at large d.
#define REPRO_WALKS(X) X(1, 8) X(2, 4) X(4, 4) X(8, 2) X(16, 1) X(32, 1)

// The kernels that run side by side (the band walk, the dense chain) ask
// for the SM's largest shared-memory carve-out, since an SM runs blocks of
// two kernels together only where its one shared memory / L1 split holds
// both (the walk reads its rows from L2), and may take up to the opt-in
// maximum of dynamic shared memory beside their static shared memory (a
// launch's own size sets its occupancy). Set once per device, at its first
// call.
template <typename K>
int share_sm(K kern, int optin) {
  const void* f = reinterpret_cast<const void*>(kern);
  cudaFuncAttributes attr;
  int e = static_cast<int>(cudaFuncGetAttributes(&attr, f));
  if (!e)
    e = static_cast<int>(cudaFuncSetAttribute(
        f, cudaFuncAttributeMaxDynamicSharedMemorySize,
        optin - static_cast<int>(attr.sharedSizeBytes)));
  if (!e)
    e = static_cast<int>(cudaFuncSetAttribute(
        f, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared));
  return e;
}

template <typename T>
int share_family(int optin) {
  int e = 0;
#define REPRO_SHARE(C, F) \
  if (!e) e = share_sm(fused_estimator_band_kernel<T, C, F>, optin);
  REPRO_WALKS(REPRO_SHARE)
#undef REPRO_SHARE
  if (!e) e = share_sm(fused_estimator_dense_score_kernel<T>, optin);
  if (!e) e = share_sm(fused_estimator_dense_sum_kernel<T>, optin);
  return e;
}

// The side stream the dense kernels run on, concurrently with the rows'
// walk (tensor cores beside a memory-bound kernel), and the two events that
// fork it from and join it to the caller's stream; made once per device, at
// the default priority (the dense blocks take the SM room the walk leaves),
// when the kernels' attributes are set. The mutex keeps one call's fork
// and join together.
struct Side {
  cudaStream_t stream = nullptr;
  cudaEvent_t fork = nullptr, join = nullptr;
  int err = 0;
};
std::mutex side_mutex;

int side_of(Side** out) {
  constexpr int kDevices = 64;
  static Side sides[kDevices];
  static std::once_flag once[kDevices];
  int dev = 0;
  const int e = static_cast<int>(cudaGetDevice(&dev));
  if (e) return e;
  if (dev >= kDevices) return static_cast<int>(cudaErrorInvalidDevice);
  Side& sd = sides[dev];
  std::call_once(once[dev], [&sd, dev] {
    int optin = 0;
    int err = static_cast<int>(cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev));
    if (!err) err = share_family<float>(optin);
    if (!err) err = share_family<__nv_bfloat16>(optin);
    if (!err) err = share_sm(fused_estimator_dense_weights_kernel, optin);
    if (!err)
      err = static_cast<int>(
          cudaStreamCreateWithFlags(&sd.stream, cudaStreamNonBlocking));
    if (!err)
      err = static_cast<int>(
          cudaEventCreateWithFlags(&sd.fork, cudaEventDisableTiming));
    if (!err)
      err = static_cast<int>(
          cudaEventCreateWithFlags(&sd.join, cudaEventDisableTiming));
    sd.err = err;
  });
  *out = &sd;
  return sd.err;
}

// bands > 0: the band walk (one partial a token); else the ranges. Shared
// memory: h and a partial's row, at most 32 KB, and for the band walk the
// band-sorted slots too, at most 96 KB in all (side_of's opt-in).
template <typename T, int C, int F>
int launch_stream(const T* emb, const int* ids, const float* h,
                  const float* log_w, const int* colmap, float* y,
                  float* part, int n, int d, int t, int m, int ranges,
                  int bands, cudaStream_t s) {
  if (bands > 0) {
    const size_t smem = sizeof(float) * (2 * static_cast<size_t>(d) +
                                         4 * static_cast<size_t>(m));
    fused_estimator_band_kernel<T, C, F><<<t, kBandThreads, smem, s>>>(
        emb, ids, h, log_w, colmap, y, part, n, d, t, m, bands);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = sizeof(float) * 2 * static_cast<size_t>(d);
  const int span = (m + ranges - 1) / ranges;
  fused_estimator_stream_kernel<T, C, F>
      <<<dim3(ranges, t), kThreads, smem, s>>>(emb, ids, h, log_w, colmap, y,
                                               part, d, t, m, span, ranges);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_stream(const T* emb, const int* ids, const float* h,
                    const float* log_w, const int* colmap, float* y,
                    float* part, int n, int d, int t, int m, int ranges,
                    int bands, cudaStream_t s) {
  const int groups = (d / 4 + 31) / 32;
#define REPRO_STREAM(C, F)                                                 \
  if (groups <= C)                                                         \
    return launch_stream<T, C, F>(emb, ids, h, log_w, colmap, y, part, n, \
                                  d, t, m, ranges, bands, s);
  REPRO_WALKS(REPRO_STREAM)
#undef REPRO_STREAM
  return static_cast<int>(cudaErrorInvalidValue);
}

// The splits of the two products' reduction axes: d for the scores, the
// cap of U for the sum (its blocks past |U| return at once).
int score_splits(int d) {
  return (d + kDepth * kSplitTiles - 1) / (kDepth * kSplitTiles);
}
int sum_splits(int cap) {
  return (cap + kDepth * kSplitTiles - 1) / (kDepth * kSplitTiles);
}

// The call's scratch, carved from one buffer in this order, each piece
// 256-byte aligned: the walk's partials (t * ranges * (d + 2)) f32; with
// the plan (cap > 0) colmap (n) and the products' tile counters
// (cap / 64 * ceil(t / 64) + ceil(d / 64) * ceil(t / 64)) i32, side by
// side so that one memset zeroes both (the kernels leave the counters
// zero), tiles (ceil(n / 2048)), rows (cap) and n_u (1) i32, Y and P_U
// (t, cap), (M_U, S_U) (2, t), P_U · U (t, d), and the products' split
// partials (ceil(d / 512), t, cap) and (ceil(cap / 512), t, d) f32.
struct Work {
  float* part = nullptr;
  int *colmap = nullptr, *counters = nullptr, *tiles = nullptr,
      *rows = nullptr, *n_u = nullptr;
  float *yd = nullptr, *pmat = nullptr, *u_stat = nullptr, *eu = nullptr,
        *ypart = nullptr, *opart = nullptr;
  size_t zero_bytes = 0;  // colmap through the counters
};

// Carves base (NULL: sizes only) into w; returns the bytes it takes.
size_t carve(unsigned char* base, int n, int d, int t, int ranges, int cap,
             Work* w) {
  size_t at = 0;
  auto take = [&](size_t elems) {
    unsigned char* p = base ? base + at : nullptr;
    at += (4 * elems + 255) / 256 * 256;
    return p;
  };
  const size_t st = t, sd = d, sc = cap;
  w->part = reinterpret_cast<float*>(take(st * ranges * (sd + 2)));
  if (cap <= 0) return at;
  const size_t tt = (st + kTile - 1) / kTile;
  const size_t zero_from = at;
  w->colmap = reinterpret_cast<int*>(take(n));
  w->counters = reinterpret_cast<int*>(
      take((sc / kTile + (sd + kTile - 1) / kTile) * tt));
  w->zero_bytes = at - zero_from;
  w->tiles = reinterpret_cast<int*>(take((n + kPlanTile - 1) / kPlanTile));
  w->rows = reinterpret_cast<int*>(take(sc));
  w->n_u = reinterpret_cast<int*>(take(1));
  w->yd = reinterpret_cast<float*>(take(st * sc));
  w->pmat = reinterpret_cast<float*>(take(st * sc));
  w->u_stat = reinterpret_cast<float*>(take(2 * st));
  w->eu = reinterpret_cast<float*>(take(st * sd));
  w->ypart = reinterpret_cast<float*>(take(score_splits(d) * st * sc));
  w->opart = reinterpret_cast<float*>(take(sum_splits(cap) * st * sd));
  return at;
}

template <typename T>
int launch_fwd(const void* emb_v, const int* ids, const float* h,
               const float* log_w, float* log_z, float* expv, float* y,
               unsigned char* work, int n, int d, int t, int m, int ranges,
               int bands, int cap, cudaStream_t s) {
  const T* emb = static_cast<const T*>(emb_v);
  Work w;
  carve(work, n, d, t, ranges, cap, &w);
  Side* side = nullptr;
  int e = side_of(&side);
  if (e) return e;
  if (cap > 0) {
    e = static_cast<int>(cudaMemsetAsync(w.colmap, 0, w.zero_bytes, s));
    if (!e)
      e = launch_plan(ids, log_w, w.colmap, w.tiles, w.rows, w.n_u, n, t, m,
                      cap, s);
    if (e) return e;
    const int tt = (t + kTile - 1) / kTile;
    const size_t wsmem =
        sizeof(float) * (cap + 2 * static_cast<size_t>(kStage));
    std::lock_guard<std::mutex> lock(side_mutex);
    e = static_cast<int>(cudaEventRecord(side->fork, s));
    // the rows' walk first, so that its blocks (all resident at once, for
    // the band walk's reuse) are dispatched before the dense chain's
    if (!e)
      e = dispatch_stream<T>(emb, ids, h, log_w, w.colmap, y, w.part, n, d, t,
                             m, ranges, bands, s);
    // fork: the dense chain on the side stream, from the plan's end
    if (!e)
      e = static_cast<int>(cudaStreamWaitEvent(side->stream, side->fork, 0));
    if (e) return e;
    fused_estimator_dense_score_kernel<T>
        <<<dim3(cap / kTile, tt, score_splits(d)), kMmaThreads, mma_smem<T>(),
           side->stream>>>(emb, h, w.rows, w.n_u, w.yd, w.ypart, w.counters,
                           d, t, cap);
    fused_estimator_dense_weights_kernel<<<t, kThreads, wsmem,
                                           side->stream>>>(
        ids, log_w, w.colmap, w.yd, w.n_u, y, w.u_stat, w.pmat, t, m, cap);
    fused_estimator_dense_sum_kernel<T>
        <<<dim3((d + kTile - 1) / kTile, tt, sum_splits(cap)), kMmaThreads,
           mma_smem<T>(), side->stream>>>(
            emb, w.pmat, w.rows, w.n_u, w.eu, w.opart,
            w.counters + (cap / kTile) * tt, d, t, cap);
    e = static_cast<int>(cudaGetLastError());
    // join: the combine waits for the dense chain
    if (!e) e = static_cast<int>(cudaEventRecord(side->join, side->stream));
    if (!e) e = static_cast<int>(cudaStreamWaitEvent(s, side->join, 0));
  } else {
    e = dispatch_stream<T>(emb, ids, h, log_w, nullptr, y, w.part, n, d, t, m,
                           ranges, bands, s);
  }
  if (e) return e;
  fused_estimator_combine_kernel<<<t, kThreads, sizeof(float) * ranges, s>>>(
      w.part, cap > 0 ? w.n_u : nullptr, w.u_stat, w.eu, log_z, expv, d, t,
      ranges);
  return static_cast<int>(cudaGetLastError());
}

int launch_bwd(const long long* order, const int* offsets, const float* h,
               const float* y, const float* log_z, const float* g,
               float* d_emb, float* p, int n, int d, int t, int m,
               cudaStream_t stream) {
  int dev = 0, sms = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t batch_bytes = sizeof(float2) * kBatch * kBwdWarps;
  const size_t row_bytes = sizeof(float) * kSliceCols;  // one token's slice
  // the tile's tokens, a row of zeros, the warps' batches, static smem
  const int fit =
      static_cast<int>((optin - batch_bytes - 1024) / row_bytes) - 1;
  const int tile_t = std::max(1, std::min(t, fit));
  const size_t smem = row_bytes * (tile_t + 1) + batch_bytes;
  auto kern = fused_estimator_bwd_spmm_kernel;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  int per_sm = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      kBwdThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  // one wave: the slices times the warp groups fill the card once
  const int slices = (d + kSliceCols - 1) / kSliceCols;
  const int groups =
      std::max(1, std::min(n, sms * std::max(per_sm, 1) / slices));
  kern<<<dim3(slices, groups), kBwdThreads, smem, stream>>>(
      order, offsets, h, y, log_z, g, d_emb, p, n, d, t, m, tile_t);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shapes: emb (n, d) fp32 (bf16 = 0) or bf16 (bf16 = 1), ids (t, m) i32 in
// [0, n), h (t, d) f32, log_w (t, m) f32 -> log_z (t,) f32, expv (t, d) f32,
// and unless y is NULL the scores y (t, m) f32, -inf on dead slots.
// Slots are cut into ``ranges`` a token (bands = 0), or walked by the
// ``bands`` of their rows (ranges = 1, m <= 4096, bands <= 32). The
// popular-row plan runs where cap > 0 (a multiple of 64: the most rows U
// takes). work: fused_estimator_workspace(n, d, t, ranges, cap) bytes,
// 256-byte aligned. Requires d % 4 == 0, d <= 4096, rows 16-byte (fp32) /
// 8-byte (bf16) aligned, h 16-byte aligned. Returns the CUDA error code of
// the launches (0 = success).
extern "C" int fused_estimator_launch(const void* emb, const int* ids,
                                      const float* h, const float* log_w,
                                      float* log_z, float* expv, float* y,
                                      void* work, int n, int d, int t, int m,
                                      int bf16, int ranges, int bands, int cap,
                                      void* stream) {
  if (t == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned char* w = static_cast<unsigned char*>(work);
  return bf16 ? launch_fwd<__nv_bfloat16>(emb, ids, h, log_w, log_z, expv, y,
                                          w, n, d, t, m, ranges, bands, cap, s)
              : launch_fwd<float>(emb, ids, h, log_w, log_z, expv, y, w, n, d,
                                  t, m, ranges, bands, cap, s);
}

// The bytes of the forward's scratch at these shapes (see carve).
extern "C" size_t fused_estimator_workspace(int n, int d, int t, int ranges,
                                            int cap) {
  Work w;
  return carve(nullptr, n, d, t, ranges, cap, &w);
}

// The forward's popular-row plan alone (its first step), for tests: ids
// (t, m) i32 in [0, n), log_w (t, m) f32 -> colmap (n,) i32 (a row's column
// in U, or -1), rows (cap,) i32 (U's rows in row order; the first n_u
// written), n_u (1,) i32; tiles (ceil(n / 2048),) i32 scratch.
extern "C" int fused_estimator_plan_launch(const int* ids, const float* log_w,
                                           int* colmap, int* tiles, int* rows,
                                           int* n_u, int n, int t, int m,
                                           int cap, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int e = static_cast<int>(
      cudaMemsetAsync(colmap, 0, sizeof(int) * static_cast<size_t>(n), s));
  if (e) return e;
  return launch_plan(ids, log_w, colmap, tiles, rows, n_u, n, t, m, cap, s);
}

// Shapes: order (t*m,) i64 flat candidate positions sorted stably by their
// (clamped) id; offsets (n+1,) i32, row r's segment is
// order[offsets[r] .. offsets[r+1]); h (t, d) f32;
// y (t, m) f32 the forward's scores (-inf on dead slots); log_z (t,) f32;
// g (t,) f32 -> d_emb (n, d) f32 (every row written), p (t, m) f32.
// Requires d % 4 == 0 and h 16-byte aligned.
extern "C" int fused_estimator_bwd_launch(
    const long long* order, const int* offsets, const float* h,
    const float* y, const float* log_z, const float* g, float* d_emb,
    float* p, int n, int d, int t, int m, void* stream) {
  if (n == 0) return 0;
  return launch_bwd(order, offsets, h, y, log_z, g, d_emb, p, n, d, t, m,
                    static_cast<cudaStream_t>(stream));
}
