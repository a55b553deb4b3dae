// The fused decode head: ivf_screen_select, pq_screen_select, rerank_select
// and tail_gather_argmax.
//
// ---------------------------------------------------------------------------
// ivf_screen_select replaces the Pallas TPU kernel
// repro/kernels/decode_fused.py::ivf_screen_select (gather-score of the
// probed clusters into a VMEM pool, pool ∪ overflow masked, top-k emitted
// by iterative first-occurrence argmax: descending values, the lower pool
// index first among ties, id -1 for every -inf pick).
//
// What bounds it on an H100: bytes. A query streams n_probe (cap, d) fp32
// cluster tiles (8 * 544 * 2048 * 4 = 36 MB at tinyllama's vocab) for half
// a flop per byte; the pool itself never leaves the SM.
//
// Design: one block of 1024 threads per query. Warps score the member rows
// with repro_torch::warp_row_dot — made of the row_dot.cuh pieces whose
// order ivf_gather_score.cu folds its sums in, so every live score is
// bitwise the unfused kernel's — and write a
// 64-bit sort key per pool slot into shared memory: the high word orders
// the fp32 score descending, the low word is the pool index, so an
// ascending sort of the keys is exactly the Pallas kernel's emission order.
// Dead slots (id < 0, or a stage at or past probe_width) are never read from
// device memory and get a -inf key. The overflow scores come from the
// caller (one matmul outside the kernel, as in the reference). The pool is
// padded to a power of two with -inf keys whose indices lie past the pool,
// bitonic-sorted in shared memory (~64 KB at the default geometry, hence the
// dynamic shared memory attribute), and the first k keys are emitted; ids
// are re-read from the member/overflow tables for the k winners only.
//
// ---------------------------------------------------------------------------
// pq_screen_select replaces the Pallas TPU kernel
// repro/kernels/decode_fused.py::pq_screen_select (the IVF-PQ analogue:
// each probed member's LUT sum from the shared lut_tile_scores plus its
// cluster's coarse score, stages at or past probe_width dead, pool ∪ exact
// overflow scores masked, top-r emitted as above).
//
// What bounds it on an H100: at 4 queries, latency — the block's sort.
// The bytes are small: per query 8 uint8 codes and an int32 id per probed
// member (8 * 544 * 12 = 52 KB), an 8 KB LUT and the overflow scores; no
// flop beyond one add per code.
//
// Design: one block of 1024 threads per query, as ivf_screen_select. The
// query's LUT goes into shared memory; each thread scores live members with
// repro_torch::lut_sum (pq_lut.cuh) — the device function pq_lut_score.cu
// uses — then adds the coarse term after the sum, as the unfused path adds
// pq_lut_score's output and the coarse scores; so every live key is bitwise
// the unfused screen's score. Keys, padding, sort and emission are
// ivf_screen_select's (8192 keys, 64 KB, at tinyllama's 6352-slot pool).
//
// ---------------------------------------------------------------------------
// rerank_select replaces the Pallas TPU kernel
// repro/kernels/decode_fused.py::rerank_select (the exact fp32 re-rank of
// the r screening survivors: their db rows streamed into VMEM by the
// prefetched candidate ids, one matvec with q, survivors with id < 0 or a
// -inf screening value dead, top-k emitted as above).
//
// What bounds it on an H100: bytes. A query reads r fp32 rows of d (1152 *
// 2048 * 4 = 9.4 MB at tinyllama's width) for half a flop per byte.
//
//   * At the serving path's 4 queries, ~38 MB of row reads: 11 us at the
//     HBM rate if the whole card streams them, where one block a query (the
//     first port) left them to 4 SMs at one SM's rate (0.22 ms). The split
//     grid below streams them on every SM; what is left is latency: the
//     score grid's ~22 us on an H100 80GB HBM3 at 700 W (one row a warp,
//     each lane's loads as warp_row_dot issues them) and the select.
//   * At the training probe's 256 queries each row is read once per query
//     that picked it: ~2.4 GB through L2 for the distinct rows (2k-32k of
//     them, 17-262 MB), so the re-reads that miss the 50 MB L2 set the
//     time. The grid keeps the blocks in flight on the same stretch of
//     many queries' screening order, so a row that many queries picked is
//     re-read while it is still in L2. Grouping the pairs by row instead (a
//     plan kernel: count, scan, fill; each row held in registers against up
//     to 16 queries read from L2) cuts the DRAM reads to the distinct rows,
//     but then every pair reads its q (8 KB) through L2, 2.4 GB again: on
//     the same card it ran 1.4x (uniform survivors) to 2.3x (piled-up
//     survivors) slower than this grid, and was left out.
//
// Design: two kernels, enqueued by one C call.
//
//   * rerank_score_kernel, grid (query, chunk): each block stages its query
//     in shared memory; its warps take kRerankRows survivors at a time,
//     one a warp, stepping over the query's survivors by the grid's chunk
//     count, and score the live ones with repro_torch::warp_row_dot (dead
//     ones are never read; an id >= n clamps as a gather would), writing
//     one 64-bit key per survivor (the low word its position among the r)
//     into a (b, r) workspace. A few queries get a block for every chunk of
//     kRerankRows survivors (4 queries of 1,152: 144 blocks), so the whole
//     card streams their rows; a batch that fills kRerankBlocksPerSM blocks
//     an SM on its own gets fewer chunks a query, each block striding over
//     the rest (256 queries: 3 a query), so the q staging and the block's
//     start are paid once per ~400 rows, not per 32. The query is the fast
//     grid index: the blocks in flight hold the same stretch of many
//     queries' survivors, as the one-block-a-query kernel's warps did.
//   * rerank_select_kernel, one block a query, a programmatic dependent
//     launch (pdl.cuh): scheduled while the scores run, it waits for them
//     on the device, then takes the query's first k keys by rank
//     (select_by_rank, select_keys.cuh): each warp sorts 64-key runs in
//     registers, and a key's rank is its place in its run plus a binary
//     search in each other run: one block barrier, where a bitonic sort of
//     the 2,048 padded keys took 66 (~25 us at 4 queries). The same sort
//     with its strides below 64 in registers (21 barriers) measured as
//     this does, ~16 us, so what the select costs is not its barriers. It
//     emits value, then cand[key index], id -1 for a -inf pick.
//
// Every score is one warp_row_dot in its fixed order, whichever block
// computes it, and the keys are unique and ordered as before, so the
// outputs equal the one-block-per-query kernel's bit for bit; no float
// atomics, and two launches agree. The unfused IVF-PQ probe on the card
// re-ranks through this kernel too, so the fused and unfused paths agree
// bit for bit.
//
// ---------------------------------------------------------------------------
// tail_gather_argmax replaces the Pallas TPU kernel
// repro/kernels/decode_fused.py::tail_gather_argmax (the Algorithm-2 finish:
// gather the m_cap tail rows, fp32 dot with h, add the truncated-Gumbel
// heights to the first m_used slots, -inf for the rest, concatenate with the
// perturbed top-k stratum and take the first-occurrence argmax).
//
// What bounds it on an H100: bytes. A token gathers m_used rows of the
// output embedding (about 576 * 2048 * 4 = 4.7 MB at tinyllama's vocab) for
// half a flop per byte.
//
// Design: one block of 1024 threads per token. h sits in shared memory;
// warps take the live tail slots only (slots at or past m_used are -inf and
// never read) and score each gathered row with warp_row_dot; the perturbed
// tail values stay in shared memory, and a block-wide argmax with the
// (value, lower index) order picks the winner over [pert_s, pert_t].
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "pdl.cuh"
#include "pq_lut.cuh"
#include "row_dot.cuh"
#include "select_keys.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

using repro_torch::bitonic_sort;
using repro_torch::key_index;
using repro_torch::key_value;
using repro_torch::make_key;

// Keys of a screen pool's overflow slots (n_mem .. n_mem + o_cap: the
// caller's exact scores, -inf where the id is dead) and of the padding up
// to pool_pow2 (-inf, indices past the pool).
__device__ void fill_overflow_keys(unsigned long long* keys,
                                   const float* __restrict__ os,
                                   const int* __restrict__ overflow_ids,
                                   int n_mem, int o_cap, int pool_pow2) {
  for (int o = threadIdx.x; o < o_cap; o += blockDim.x)
    keys[n_mem + o] =
        make_key(overflow_ids[o] >= 0 ? os[o] : -INFINITY, n_mem + o);
  for (int p = n_mem + o_cap + threadIdx.x; p < pool_pow2; p += blockDim.x)
    keys[p] = make_key(-INFINITY, p);
}

// The first k keys of a sorted screen pool -> values and ids; the ids are
// read back from the member / overflow tables for the winners only, and a
// -inf pick emits id -1.
__device__ void emit_pool(const unsigned long long* keys, int k,
                          const int* __restrict__ pr,
                          const int* __restrict__ member_ids,
                          const int* __restrict__ overflow_ids, int n_c,
                          int cap, int n_mem, float* __restrict__ vals,
                          int* __restrict__ ids) {
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    const int p = key_index(keys[i]);
    const float v = key_value(keys[i]);
    int id = -1;
    if (v != -INFINITY) {
      if (p < n_mem) {
        const int j = p / cap;
        const int cl = min(max(pr[j], 0), n_c - 1);
        id = member_ids[static_cast<size_t>(cl) * cap + (p - j * cap)];
      } else {
        id = overflow_ids[p - n_mem];
      }
    }
    vals[i] = v;
    ids[i] = id;
  }
}

__global__ void __launch_bounds__(kThreads) ivf_screen_select_kernel(
    const float* __restrict__ member_vecs, const int* __restrict__ member_ids,
    const float* __restrict__ overflow_scores,
    const int* __restrict__ overflow_ids, const int* __restrict__ probe,
    const int* __restrict__ probe_width, const float* __restrict__ q,
    float* __restrict__ out_vals, int* __restrict__ out_ids, int n_c, int cap,
    int d, int n_probe, int o_cap, int k, int d_pad, int pool_pow2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sq = reinterpret_cast<float*>(smem_raw);
  unsigned long long* keys =
      reinterpret_cast<unsigned long long*>(sq + d_pad);
  const int bi = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int width =
      probe_width ? min(max(probe_width[bi], 0), n_probe) : n_probe;
  const int n_mem = n_probe * cap;
  const int* pr = probe + static_cast<size_t>(bi) * n_probe;

  repro_torch::load_query(sq, q + static_cast<size_t>(bi) * d, d);
  __syncthreads();

  for (int row = warp; row < n_mem; row += kWarps) {
    const int j = row / cap;
    const int r = row - j * cap;
    float s = -INFINITY;
    if (j < width) {
      const int cl = min(max(pr[j], 0), n_c - 1);
      const size_t slot = static_cast<size_t>(cl) * cap + r;
      if (member_ids[slot] >= 0)  // uniform across the warp
        s = repro_torch::warp_row_dot(member_vecs + slot * d, sq, d, lane);
    }
    if (lane == 0) keys[row] = make_key(s, row);
  }
  fill_overflow_keys(keys, overflow_scores + static_cast<size_t>(bi) * o_cap,
                     overflow_ids, n_mem, o_cap, pool_pow2);
  __syncthreads();
  bitonic_sort(keys, pool_pow2);
  emit_pool(keys, k, pr, member_ids, overflow_ids, n_c, cap, n_mem,
            out_vals + static_cast<size_t>(bi) * k,
            out_ids + static_cast<size_t>(bi) * k);
}

__global__ void __launch_bounds__(kThreads) pq_screen_select_kernel(
    const uint8_t* __restrict__ member_codes,
    const int* __restrict__ member_ids, const float* __restrict__ coarse,
    const float* __restrict__ overflow_scores,
    const int* __restrict__ overflow_ids, const int* __restrict__ probe,
    const int* __restrict__ probe_width, const float* __restrict__ lut,
    float* __restrict__ out_vals, int* __restrict__ out_ids, int n_c, int cap,
    int m_sub, int ksub, int n_probe, int o_cap, int r, int pool_pow2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem_raw);
  float* slut = reinterpret_cast<float*>(keys + pool_pow2);
  const int bi = blockIdx.x;
  const int tid = threadIdx.x;
  const int width =
      probe_width ? min(max(probe_width[bi], 0), n_probe) : n_probe;
  const int n_mem = n_probe * cap;
  const int lut_n = m_sub * ksub;
  const int* pr = probe + static_cast<size_t>(bi) * n_probe;
  const float* cq = coarse + static_cast<size_t>(bi) * n_probe;

  repro_torch::load_query(slut, lut + static_cast<size_t>(bi) * lut_n, lut_n);
  __syncthreads();

  for (int row = tid; row < n_mem; row += kThreads) {
    const int j = row / cap;
    float s = -INFINITY;
    if (j < width) {
      const int cl = min(max(pr[j], 0), n_c - 1);
      const size_t slot = static_cast<size_t>(cl) * cap + (row - j * cap);
      // the LUT sum, then the coarse term: pq_lut_score + coarse, as the
      // unfused screen adds them
      if (member_ids[slot] >= 0)
        s = repro_torch::lut_sum(member_codes + slot * m_sub, slut, m_sub,
                                 ksub) +
            cq[j];
    }
    keys[row] = make_key(s, row);
  }
  fill_overflow_keys(keys, overflow_scores + static_cast<size_t>(bi) * o_cap,
                     overflow_ids, n_mem, o_cap, pool_pow2);
  __syncthreads();
  bitonic_sort(keys, pool_pow2);
  emit_pool(keys, r, pr, member_ids, overflow_ids, n_c, cap, n_mem,
            out_vals + static_cast<size_t>(bi) * r,
            out_ids + static_cast<size_t>(bi) * r);
}

// rerank_select's score kernel: survivors a block scores at once, one a
// warp, and the blocks per SM the grid aims at (4 measured best of 1, 2
// and 4: 1 left a 4-query call a second wave, and 4 was the fastest at
// 256 queries).
constexpr int kRerankRows = 32;
constexpr int kRerankThreads = 32 * kRerankRows;
constexpr int kRerankBlocksPerSM = 4;

__global__ void __launch_bounds__(kRerankThreads, 1) rerank_score_kernel(
    const float* __restrict__ db, const int* __restrict__ cand,
    const float* __restrict__ lut_vals, const float* __restrict__ q,
    unsigned long long* __restrict__ keys, int n, int d, int r) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sq = reinterpret_cast<float*>(smem_raw);
  // the select kernel may be scheduled now; it waits for this grid's end
  repro_torch::allow_dependent_launch();
  const int bi = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const size_t base = static_cast<size_t>(bi) * r;

  repro_torch::load_query(sq, q + static_cast<size_t>(bi) * d, d);
  __syncthreads();
  for (int c = blockIdx.y * kRerankRows + (threadIdx.x >> 5); c < r;
       c += gridDim.y * kRerankRows) {
    // dead survivors (id < 0, a -inf screening value) are never read; an
    // id >= n clamps as a gather would
    const int id = cand[base + c];
    float s = -INFINITY;
    if (id >= 0 && lut_vals[base + c] != -INFINITY)  // warp-uniform
      s = repro_torch::warp_row_dot(
          db + static_cast<size_t>(min(id, n - 1)) * d, sq, d, lane);
    if (lane == 0) keys[base + c] = make_key(s, c);
  }
}

__global__ void __launch_bounds__(kThreads) rerank_select_kernel(
    const unsigned long long* __restrict__ ws, const int* __restrict__ cand,
    float* __restrict__ out_vals, int* __restrict__ out_ids, int r, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem_raw);
  const int bi = blockIdx.x;
  const int* cb = cand + static_cast<size_t>(bi) * r;
  float* vals = out_vals + static_cast<size_t>(bi) * k;
  int* ids = out_ids + static_cast<size_t>(bi) * k;
  // launched early (programmatic dependent launch): wait until the score
  // grid has finished and its keys are visible
  repro_torch::wait_for_previous_grid();
  repro_torch::select_by_rank(
      keys, ws + static_cast<size_t>(bi) * r, r, (r + 63) / 64, k,
      [&](int i, unsigned long long key) {
        const float v = key_value(key);
        vals[i] = v;
        ids[i] = v != -INFINITY ? cb[key_index(key)] : -1;
      });
}

// (value, index) order of a first-occurrence argmax: larger value, then
// lower index.
__device__ __forceinline__ void argmax_merge(float& bv, int& bi, float v,
                                             int i) {
  if (v > bv || (v == bv && i < bi)) {
    bv = v;
    bi = i;
  }
}

__global__ void __launch_bounds__(kThreads) tail_gather_argmax_kernel(
    const float* __restrict__ emb, const int* __restrict__ pos,
    const int* __restrict__ m_used, const float* __restrict__ pert_s,
    const int* __restrict__ s_ids, const float* __restrict__ heights,
    const float* __restrict__ h, int* __restrict__ out_idx,
    float* __restrict__ out_max, int n, int d, int m_cap, int k, int d_pad) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sh = reinterpret_cast<float*>(smem_raw);
  float* spert = sh + d_pad;                       // m_cap
  float* red_v = spert + m_cap;                    // kWarps
  int* red_i = reinterpret_cast<int*>(red_v + kWarps);  // kWarps
  const int ti = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int mu = min(max(m_used[ti], 0), m_cap);
  const int* tp = pos + static_cast<size_t>(ti) * m_cap;
  const float* th = heights + static_cast<size_t>(ti) * m_cap;

  repro_torch::load_query(sh, h + static_cast<size_t>(ti) * d, d);
  __syncthreads();

  for (int j = warp; j < m_cap; j += kWarps) {
    float pt = -INFINITY;
    if (j < mu) {
      const int row = min(max(tp[j], 0), n - 1);
      const float y = repro_torch::warp_row_dot(
          emb + static_cast<size_t>(row) * d, sh, d, lane);
      pt = y + th[j];
    }
    if (lane == 0) spert[j] = pt;
  }
  __syncthreads();

  const float* ps = pert_s + static_cast<size_t>(ti) * k;
  float bv = -INFINITY;
  int bi = 0x7fffffff;
  for (int e = tid; e < k + m_cap; e += kThreads)
    argmax_merge(bv, bi, e < k ? ps[e] : spert[e - k], e);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    argmax_merge(bv, bi, ov, oi);
  }
  if (lane == 0) {
    red_v[warp] = bv;
    red_i[warp] = bi;
  }
  __syncthreads();
  if (warp == 0) {
    bv = red_v[lane];  // kWarps == 32
    bi = red_i[lane];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      argmax_merge(bv, bi, ov, oi);
    }
    if (lane == 0) {
      out_idx[ti] = bi < k ? s_ids[static_cast<size_t>(ti) * k + bi]
                           : tp[bi - k];
      out_max[ti] = bv;
    }
  }
}

int set_smem(const void* fn, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

int round_up4(int d) { return (d + 3) & ~3; }

}  // namespace

// Shared memory a launch of ivf_screen_select needs, in bytes; the caller
// checks it against the card's per-block limit before launching.
extern "C" long long ivf_screen_select_smem(int d, int pool_pow2) {
  return static_cast<long long>(sizeof(float)) * round_up4(d) +
         static_cast<long long>(sizeof(unsigned long long)) * pool_pow2;
}

// Shapes: member_vecs (n_c, cap, d) f32, member_ids (n_c, cap) i32,
// overflow_scores (b, o_cap) f32, overflow_ids (o_cap,) i32,
// probe (b, n_probe) i32, probe_width (b,) i32 or NULL (full width),
// q (b, d) f32 -> out_vals (b, k) f32, out_ids (b, k) i32.
// pool_pow2 is a power of two >= max(n_probe * cap + o_cap, k).
// Returns the CUDA error code of the launch (0 = success).
extern "C" int ivf_screen_select_launch(
    const float* member_vecs, const int* member_ids,
    const float* overflow_scores, const int* overflow_ids, const int* probe,
    const int* probe_width, const float* q, float* out_vals, int* out_ids,
    int n_c, int cap, int d, int b, int n_probe, int o_cap, int k,
    int pool_pow2, void* stream) {
  if (b == 0 || k == 0) return 0;
  const size_t smem = static_cast<size_t>(ivf_screen_select_smem(d, pool_pow2));
  const int e = set_smem(reinterpret_cast<const void*>(ivf_screen_select_kernel),
                         smem);
  if (e) return e;
  ivf_screen_select_kernel<<<b, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      member_vecs, member_ids, overflow_scores, overflow_ids, probe,
      probe_width, q, out_vals, out_ids, n_c, cap, d, n_probe, o_cap, k,
      round_up4(d), pool_pow2);
  return static_cast<int>(cudaGetLastError());
}

// Shapes: emb (n, d) f32, pos (t, m_cap) i32, m_used (t,) i32,
// pert_s (t, k) f32, s_ids (t, k) i32, heights (t, m_cap) f32, h (t, d) f32
// -> out_idx (t,) i32, out_max (t,) f32.
// Returns the CUDA error code of the launch (0 = success).
extern "C" int tail_gather_argmax_launch(
    const float* emb, const int* pos, const int* m_used, const float* pert_s,
    const int* s_ids, const float* heights, const float* h, int* out_idx,
    float* out_max, int n, int d, int t, int m_cap, int k, void* stream) {
  if (t == 0) return 0;
  const size_t smem = sizeof(float) * (round_up4(d) + m_cap + kWarps) +
                      sizeof(int) * kWarps;
  const int e = set_smem(
      reinterpret_cast<const void*>(tail_gather_argmax_kernel), smem);
  if (e) return e;
  tail_gather_argmax_kernel<<<t, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      emb, pos, m_used, pert_s, s_ids, heights, h, out_idx, out_max, n, d,
      m_cap, k, round_up4(d));
  return static_cast<int>(cudaGetLastError());
}

// Shared memory a launch of pq_screen_select needs, in bytes.
extern "C" long long pq_screen_select_smem(int m_sub, int ksub,
                                           int pool_pow2) {
  return static_cast<long long>(sizeof(unsigned long long)) * pool_pow2 +
         static_cast<long long>(sizeof(float)) * m_sub * ksub;
}

// Shapes: member_codes (n_c, cap, m_sub) u8, member_ids (n_c, cap) i32,
// coarse (b, n_probe) f32, overflow_scores (b, o_cap) f32,
// overflow_ids (o_cap,) i32, probe (b, n_probe) i32, probe_width (b,) i32
// or NULL (full width), lut (b, m_sub, ksub) f32
// -> out_vals (b, r) f32, out_ids (b, r) i32.
// pool_pow2 is a power of two >= max(n_probe * cap + o_cap, r).
// Returns the CUDA error code of the launch (0 = success).
extern "C" int pq_screen_select_launch(
    const uint8_t* member_codes, const int* member_ids, const float* coarse,
    const float* overflow_scores, const int* overflow_ids, const int* probe,
    const int* probe_width, const float* lut, float* out_vals, int* out_ids,
    int n_c, int cap, int m_sub, int ksub, int b, int n_probe, int o_cap,
    int r, int pool_pow2, void* stream) {
  if (b == 0 || r == 0) return 0;
  const size_t smem =
      static_cast<size_t>(pq_screen_select_smem(m_sub, ksub, pool_pow2));
  const int e = set_smem(reinterpret_cast<const void*>(pq_screen_select_kernel),
                         smem);
  if (e) return e;
  pq_screen_select_kernel<<<b, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      member_codes, member_ids, coarse, overflow_scores, overflow_ids, probe,
      probe_width, lut, out_vals, out_ids, n_c, cap, m_sub, ksub, n_probe,
      o_cap, r, pool_pow2);
  return static_cast<int>(cudaGetLastError());
}

// Shared memory one block of a rerank_select launch needs at most, in
// bytes: the score kernel's staged query or the select kernel's keys (r
// rounded up to 64-key runs).
extern "C" long long rerank_select_smem(int d, int r) {
  const long long q = static_cast<long long>(sizeof(float)) * round_up4(d);
  const long long keys = static_cast<long long>(sizeof(unsigned long long)) *
                         64 * ((r + 63) / 64);
  return q > keys ? q : keys;
}

// Shapes: db (n, d) f32, cand (b, r) i32, lut_vals (b, r) f32, q (b, d) f32
// -> out_vals (b, k) f32, out_ids (b, k) i32; ws: b * r 64-bit keys of
// workspace, 8-byte aligned; k <= r.
// Enqueues the score and select kernels; returns the CUDA error code of the
// launches (0 = success).
extern "C" int rerank_select_launch(const float* db, const int* cand,
                                    const float* lut_vals, const float* q,
                                    float* out_vals, int* out_ids,
                                    unsigned long long* ws, int n, int d,
                                    int b, int r, int k, void* stream) {
  if (b == 0 || k == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0;
  int sms = 0;
  int e = static_cast<int>(cudaGetDevice(&dev));
  if (!e)
    e = static_cast<int>(
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  if (e) return e;
  // chunks of a query's survivors that run as blocks of their own: all of
  // them for a few queries, fewer (each block then strides over the rest)
  // once the batch alone fills kRerankBlocksPerSM blocks on every SM
  const int chunks = (r + kRerankRows - 1) / kRerankRows;
  const int per_query = (kRerankBlocksPerSM * sms + b - 1) / b;
  const size_t smem_q = sizeof(float) * round_up4(d);
  e = set_smem(reinterpret_cast<const void*>(rerank_score_kernel), smem_q);
  if (e) return e;
  rerank_score_kernel<<<dim3(b, chunks < per_query ? chunks : per_query),
                        kRerankThreads, smem_q, s>>>(db, cand, lut_vals, q,
                                                     ws, n, d, r);
  e = static_cast<int>(cudaGetLastError());
  if (e) return e;
  const size_t smem_k = sizeof(unsigned long long) * 64 * ((r + 63) / 64);
  e = set_smem(reinterpret_cast<const void*>(rerank_select_kernel), smem_k);
  if (e) return e;
  return repro_torch::launch_dependent(
      rerank_select_kernel, dim3(b), dim3(kThreads), smem_k, s,
      static_cast<const unsigned long long*>(ws), cand, out_vals, out_ids, r,
      k);
}
