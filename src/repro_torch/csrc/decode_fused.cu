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
// What bounds it on an H100: bytes. A query streams its probed clusters'
// live (cap, d) fp32 rows (~1,350 of the 8 * 544 slots, 11 MB, at
// tinyllama's vocab; 44 MB of distinct rows for 4 queries) for half a flop
// per byte. One block a query (the first port) left them to 4 SMs at one
// SM's rate and then bitonic-sorted 8,192 keys in shared memory (91 block
// barriers): 0.436 ms at 4 queries on an H100 80GB HBM3 at 700 W.
//
// Design: two stages, enqueued by one C call.
//
//   * The score pass is ivf_gather_score's cluster-major code
//     (ivf_score.cuh: the small kernel for at most 4 queries, the plan and
//     its score kernel beyond), on every SM, each live row read once per
//     chunk of queries that probe its cluster, with a sink (KeySink) that
//     writes one 64-bit sort key per pool slot into a (b, n_probe * cap)
//     workspace: the high word orders the fp32 score descending, the low
//     word is the pool index, so the keys are unique and an ascending order
//     of them is exactly the Pallas kernel's emission order. Dead members
//     (id < 0) are never read and get a -inf key; stages at or past a
//     query's probe_width are never listed, written or read. Its scores are
//     ivf_gather_score's bit for bit: the same code computes them.
//   * ivf_screen_topk_kernel, one block a query, a programmatic dependent
//     launch (pdl.cuh): before it waits for the scores it builds the keys
//     that do not need them — the overflow slots (the caller's exact
//     scores, one matmul outside the kernel as in the reference; -inf where
//     the id is dead), dead stages, and the padding up to pool_pow2 (-inf,
//     indices past the pool) — holding up to 16 keys a thread in
//     registers; then it loads the members' keys and radix-selects the k-th
//     smallest key, 8 bits a pass from the top, with a shared histogram per
//     pass (two block barriers a pass; a pass ends the search once the k-th
//     key's bucket holds exactly the keys still wanted — 3-4 passes on
//     random float scores; a tie at the k-th value takes the index's two
//     live bytes as well). The keys are unique, so exactly k keys lie at or
//     below it: they are compacted into shared memory and ordered by rank
//     (select_by_rank: 64-key runs sorted in registers, binary searches; 9
//     runs at k 576), and the winners' ids are read back from the member /
//     overflow tables, id -1 for a -inf pick.
//
// Every key is the one the one-block kernel built, and any exact selection
// of unique keys emits the same values and ids, so the outputs equal that
// kernel's bit for bit; no float atomics, and two launches agree.
//
// ---------------------------------------------------------------------------
// pq_screen_select replaces the Pallas TPU kernel
// repro/kernels/decode_fused.py::pq_screen_select (the IVF-PQ analogue:
// each probed member's LUT sum from the shared lut_tile_scores plus its
// cluster's coarse score, stages at or past probe_width dead, pool ∪ exact
// overflow scores masked, top-r emitted as above).
//
// What bounds it on an H100: at 4 queries, latency. The bytes are small:
// per query 8 uint8 codes and an int32 id per probed member (8 * 544 * 12 =
// 52 KB), an 8 KB LUT and the overflow scores; no flop beyond one add per
// code. One block a query (the first port) scored its pool and then
// bitonic-sorted the 8,192 padded keys in shared memory: 0.087 ms at 4
// queries on an H100 80GB HBM3 at 700 W, most of it the sort.
//
// Design: ivf_screen_select's two stages, enqueued by one C call.
//
//   * pq_screen_score_kernel: pq_lut_score's grid and loop (pq::score_part,
//     pq_lut.cuh) with a sink (PqKeySink) that adds the coarse term after
//     the LUT sum, as the unfused path adds pq_lut_score's output and the
//     coarse scores, so every live key is bitwise the unfused screen's
//     score; dead members get a -inf key unread, and stages at or past
//     probe_width are not read.
//   * pq_screen_topk_kernel: ivf_screen_topk_kernel's body under a name of
//     its own (a profile tells the two apart), with k = r.
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
// Design: two kernels, enqueued by one C call. One block a token (the
// first port) left the rows to 4 SMs at one SM's rate: 0.10 ms at 4 tokens.
//
//   * tail_score_kernel, grid (token, chunk of kTailRows slots), the token
//     the fast index: each warp scores one live slot j < m_used at a time
//     with warp_row_dot plus its height against h staged in shared memory
//     (later slots are -inf, never read); the block folds its slots into
//     one (value, index) pair of a (t, chunks) workspace. A batch that fills
//     kTailWarpsPerSM warps an SM gets fewer chunks a token, each block
//     striding over the rest.
//   * tail_argmax_kernel, one block a token, a programmatic dependent
//     launch: it folds the token's k S values (indices 0..k-1) before it
//     waits, then the chunk winners, and emits s_ids[i] or pos[i - k].
//
// argmax_merge is a strict total order on (value, unique index) (+0 == -0,
// the lower index wins ties, a NaN never wins), and every index is folded
// once, so any reduction tree picks the one-block kernel's winner and value
// (an all -inf token: index 0); a 64-bit key minimum would rank +0 above -0.
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "ivf_score.cuh"
#include "pdl.cuh"
#include "pq_lut.cuh"
#include "row_dot.cuh"
#include "select_keys.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

using repro_torch::argmax_merge;
using repro_torch::block_argmax;
using repro_torch::key_index;
using repro_torch::key_value;
using repro_torch::make_key;

// The key of screen pool slot p >= n_mem: an overflow slot's (n_mem ..
// n_mem + o_cap: the caller's exact score, -inf where the id is dead) or
// the padding's up to pool_pow2 (-inf, an index past the pool).
__device__ __forceinline__ unsigned long long tail_key(
    int p, const float* __restrict__ os, const int* __restrict__ overflow_ids,
    int n_mem, int o_cap) {
  const int o = p - n_mem;
  return make_key(o < o_cap && overflow_ids[o] >= 0 ? os[o] : -INFINITY, p);
}

// Slot p's id in a screen pool: the member id of its stage's (clamped)
// cluster, or an overflow id.
__device__ __forceinline__ int pool_id(int p, const int* __restrict__ pr,
                                       const int* __restrict__ member_ids,
                                       const int* __restrict__ overflow_ids,
                                       int n_c, int cap, int n_mem) {
  if (p >= n_mem) return overflow_ids[p - n_mem];
  const int j = p / cap;
  const int cl = min(max(pr[j], 0), n_c - 1);
  return member_ids[static_cast<size_t>(cl) * cap + (p - j * cap)];
}

// The screens' score passes write through this sink: one sort key per
// pool slot of a live stage, at (query * n_probe + stage) * cap + row of the
// (b, n_probe * cap) workspace, its low word the pool index stage * cap +
// row; a dead member's key is -inf.
struct KeySink {
  static constexpr bool kSkipDead = true;
  unsigned long long* keys;
  int cap;
  int n_probe;

  __device__ __forceinline__ void copy_ids(const int*, int, const int*, int,
                                           int) const {}
  __device__ __forceinline__ void store(int pair, int row, float s,
                                        bool live) const {
    keys[static_cast<size_t>(pair) * cap + row] =
        make_key(live ? s : -INFINITY, (pair % n_probe) * cap + row);
  }
};

__global__ void __launch_bounds__(repro_torch::ivf::kPlanThreads)
    ivf_screen_plan_kernel(const int* __restrict__ probe,
                           const int* __restrict__ width, int P, int n_c,
                           int n_probe, int qc, int* __restrict__ count,
                           int* __restrict__ pairs, int* __restrict__ items,
                           int* __restrict__ n_items) {
  repro_torch::ivf::plan_body(probe, width, P, n_c, n_probe, qc, count,
                              pairs, items, n_items);
}

__global__ void __launch_bounds__(repro_torch::ivf::kThreads, 1)
    ivf_screen_score_kernel(const float* __restrict__ member_vecs,
                            const int* __restrict__ member_ids,
                            const float* __restrict__ q,
                            const int* __restrict__ pairs,
                            const int* __restrict__ items,
                            const int* __restrict__ n_items, KeySink sink,
                            int cap, int d, int n_probe) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  repro_torch::ivf::item_body(member_vecs, member_ids, q, pairs, items,
                              n_items, sink, cap, d, n_probe,
                              reinterpret_cast<float*>(smem_raw));
}

__global__ void __launch_bounds__(repro_torch::ivf::kThreads, 2)
    ivf_screen_score_small_kernel(const float* __restrict__ member_vecs,
                                  const int* __restrict__ member_ids,
                                  const int* __restrict__ probe,
                                  const int* __restrict__ width,
                                  const float* __restrict__ q, KeySink sink,
                                  int n_c, int cap, int d, int n_probe, int P,
                                  int qc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  repro_torch::ivf::small_body(member_vecs, member_ids, probe, width, q, sink,
                               n_c, cap, d, n_probe, P, qc,
                               reinterpret_cast<float*>(smem_raw));
}

// The screens' select (ivf_screen_topk_kernel, pq_screen_topk_kernel):
// pool keys a thread holds in registers, so a pool of up to kTopkKeys *
// kThreads = 16,384 slots.
constexpr int kTopkKeys = 16;
constexpr unsigned long long kNoKey = ~0ull;  // a register past the pool

__device__ __forceinline__ void screen_topk_body(
    const unsigned long long* __restrict__ ws,
    const int* __restrict__ member_ids,
    const float* __restrict__ overflow_scores,
    const int* __restrict__ overflow_ids, const int* __restrict__ probe,
    const int* __restrict__ probe_width, float* __restrict__ out_vals,
    int* __restrict__ out_ids, int n_c, int cap, int n_probe, int o_cap,
    int k, int pool_pow2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned long long* sel = reinterpret_cast<unsigned long long*>(smem_raw);
  __shared__ int hist[2][256];
  __shared__ int s_digit, s_before, s_count, s_taken;
  const unsigned full = 0xffffffffu;
  const int bi = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int width =
      probe_width ? min(max(probe_width[bi], 0), n_probe) : n_probe;
  const int n_mem = n_probe * cap;
  const int* pr = probe + static_cast<size_t>(bi) * n_probe;
  const float* os = overflow_scores + static_cast<size_t>(bi) * o_cap;
  const unsigned long long* wk = ws + static_cast<size_t>(bi) * n_mem;

  // the keys that need no score: overflow, dead stages, padding (thread t
  // holds slots t, t + kThreads, ...)
  for (int i = tid; i < 2 * 256; i += kThreads) (&hist[0][0])[i] = 0;
  if (tid == 0) s_taken = 0;
  unsigned long long key[kTopkKeys];
#pragma unroll
  for (int t = 0; t < kTopkKeys; ++t) {
    const int p = tid + t * kThreads;
    key[t] = p >= pool_pow2 ? kNoKey
             : p < n_mem    ? make_key(-INFINITY, p)
                            : tail_key(p, os, overflow_ids, n_mem, o_cap);
  }
  // launched early (programmatic dependent launch): wait until the score
  // grid has finished and its keys are visible
  repro_torch::wait_for_previous_grid();
#pragma unroll
  for (int t = 0; t < kTopkKeys; ++t) {
    const int p = tid + t * kThreads;
    if (p < n_mem && p / cap < width) key[t] = wk[p];
  }
  __syncthreads();

  // radix select of the k-th smallest key, 8 bits a pass from the top:
  // prefix holds the bits fixed so far, kk the k-th key's rank among the
  // keys that share them. Bits 16-31 of every key are 0 (a pool index
  // below 2^14), so after the value's four passes the index's start at 8.
  unsigned long long prefix = 0;
  int kk = k;
  int shift = 56;
  for (int pass = 0;; ++pass, shift = shift == 32 ? 8 : shift - 8) {
    int* h = hist[pass & 1];
    const unsigned long long fixed = shift == 56 ? 0ull : ~0ull << (shift + 8);
#pragma unroll
    for (int t = 0; t < kTopkKeys; ++t) {
      if (t * kThreads < pool_pow2) {  // block-uniform
        const bool in =
            key[t] != kNoKey && ((key[t] ^ prefix) & fixed) == 0;
        const int dg = in ? static_cast<int>((key[t] >> shift) & 255) : -1;
        const unsigned peers = __match_any_sync(full, dg);
        if (in && lane == __ffs(peers) - 1) atomicAdd(h + dg, __popc(peers));
      }
    }
    __syncthreads();
    if (warp == 0) {  // the bucket of the kk-th key: lane l scans 8l..8l+7
      int c[8];
      int sum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[j] = h[8 * lane + j];
        sum += c[j];
      }
      int incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(full, incl, o);
        if (lane >= o) incl += v;
      }
      int run = incl - sum;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (run < kk && kk <= run + c[j]) {
          s_digit = 8 * lane + j;
          s_before = run;
          s_count = c[j];
        }
        run += c[j];
      }
    } else {  // the next pass's histogram
      int* nh = hist[(pass + 1) & 1];
      for (int i = tid - 32; i < 256; i += kThreads - 32) nh[i] = 0;
    }
    __syncthreads();
    kk -= s_before;
    prefix |= static_cast<unsigned long long>(s_digit) << shift;
    // the bucket's keys are exactly the ones still wanted: all are taken
    if (s_count == kk || shift == 0) break;  // block-uniform
  }

  // the k keys at or below the k-th (unique keys: exactly k) into sel, in
  // any order, then sel padded to 64-key runs with keys above them all
  const unsigned long long last = prefix >> shift;
#pragma unroll
  for (int t = 0; t < kTopkKeys; ++t) {
    if (t * kThreads < pool_pow2) {  // block-uniform
      const bool take = key[t] != kNoKey && (key[t] >> shift) <= last;
      const unsigned m = __ballot_sync(full, take);
      int at = 0;
      if (lane == 0 && m) at = atomicAdd(&s_taken, __popc(m));
      at = __shfl_sync(full, at, 0) + __popc(m & ((1u << lane) - 1u));
      if (take) sel[at] = key[t];
    }
  }
  const int runs = (k + 63) / 64;
  for (int i = k + tid; i < 64 * runs; i += kThreads) sel[i] = kNoKey - i;
  __syncthreads();

  float* vals = out_vals + static_cast<size_t>(bi) * k;
  int* ids = out_ids + static_cast<size_t>(bi) * k;
  repro_torch::select_by_rank(
      sel, sel, 64 * runs, runs, k, [&](int i, unsigned long long x) {
        const float v = key_value(x);
        vals[i] = v;
        ids[i] = v != -INFINITY ? pool_id(key_index(x), pr, member_ids,
                                          overflow_ids, n_c, cap, n_mem)
                                : -1;
      });
}

#define SCREEN_TOPK_KERNEL(name)                                            \
  __global__ void __launch_bounds__(kThreads) name(                         \
      const unsigned long long* __restrict__ ws,                            \
      const int* __restrict__ member_ids,                                   \
      const float* __restrict__ overflow_scores,                            \
      const int* __restrict__ overflow_ids, const int* __restrict__ probe,  \
      const int* __restrict__ probe_width, float* __restrict__ out_vals,    \
      int* __restrict__ out_ids, int n_c, int cap, int n_probe, int o_cap,  \
      int k, int pool_pow2) {                                               \
    screen_topk_body(ws, member_ids, overflow_scores, overflow_ids, probe,  \
                     probe_width, out_vals, out_ids, n_c, cap, n_probe,     \
                     o_cap, k, pool_pow2);                                  \
  }
SCREEN_TOPK_KERNEL(ivf_screen_topk_kernel)
SCREEN_TOPK_KERNEL(pq_screen_topk_kernel)
#undef SCREEN_TOPK_KERNEL

// pq_screen_select's score pass writes through this sink: a stage at or
// past the query's probe_width is skipped whole; a live member's key holds
// its LUT sum plus the stage's coarse score (the sum first, as the unfused
// screen adds them), a dead member's -inf, unread.
struct PqKeySink {
  KeySink keys;
  const int* __restrict__ member_ids;
  const float* __restrict__ coarse;
  const int* __restrict__ probe_width;  // or null: every stage live

  __device__ __forceinline__ bool stage_live(int q, int j) const {
    return j < (probe_width ? min(max(probe_width[q], 0), keys.n_probe)
                            : keys.n_probe);
  }
  template <typename Sum>
  __device__ __forceinline__ void store(int pair, size_t slot, int row,
                                        Sum sum) const {
    const bool live = member_ids[slot] >= 0;
    keys.store(pair, row, live ? sum() + coarse[pair] : 0.f, live);
  }
};

__global__ void __launch_bounds__(repro_torch::pq::kRows)
    pq_screen_score_kernel(const uint8_t* __restrict__ member_codes,
                           const int* __restrict__ probe,
                           const float* __restrict__ lut, PqKeySink sink,
                           int n_c, int cap, int m_sub, int ksub, int n_probe,
                           int parts) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the select kernel may be scheduled now; it waits for this grid's end
  repro_torch::allow_dependent_launch();
  repro_torch::pq::score_part(member_codes, probe, lut,
                              reinterpret_cast<float*>(smem_raw), sink, n_c,
                              cap, m_sub, ksub, n_probe, parts);
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

// tail_score_kernel: tail slots a block takes, one a warp, and the warps
// per SM the grid aims at before it gives a token fewer chunks, each block
// then striding over the rest. Of 8, 16 and 32 slots a block, 32 was the
// fastest at 4 tokens on an H100 (fewer blocks stage h).
constexpr int kTailRows = kWarps;
constexpr int kTailWarpsPerSM = 128;
constexpr int kTailArgmaxThreads = 256;

__global__ void __launch_bounds__(kThreads) tail_score_kernel(
    const float* __restrict__ emb, const int* __restrict__ pos,
    const int* __restrict__ m_used, const float* __restrict__ heights,
    const float* __restrict__ h, int2* __restrict__ ws, int n, int d,
    int m_cap, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sh = reinterpret_cast<float*>(smem_raw);
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  // the argmax kernel may be scheduled now; it waits for this grid's end
  repro_torch::allow_dependent_launch();
  const int ti = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int first = blockIdx.y * kTailRows;
  const int mu = min(max(m_used[ti], 0), m_cap);
  const int* tp = pos + static_cast<size_t>(ti) * m_cap;
  const float* th = heights + static_cast<size_t>(ti) * m_cap;

  if (first < mu) {  // block-uniform: a block with no live slot reads no h
    repro_torch::load_query(sh, h + static_cast<size_t>(ti) * d, d);
    __syncthreads();
  }
  float bv = -INFINITY;
  int bi = 0x7fffffff;
  for (int j = first + (threadIdx.x >> 5); j < m_cap;
       j += gridDim.y * kTailRows) {
    float pt = -INFINITY;
    if (j < mu) {  // warp-uniform
      const int row = min(max(tp[j], 0), n - 1);
      const float y = repro_torch::warp_row_dot(
          emb + static_cast<size_t>(row) * d, sh, d, lane);
      pt = y + th[j];
    }
    argmax_merge(bv, bi, pt, k + j);
  }
  block_argmax(bv, bi, red_v, red_i);
  if (threadIdx.x == 0)
    ws[static_cast<size_t>(ti) * gridDim.y + blockIdx.y] =
        make_int2(__float_as_int(bv), bi);
}

__global__ void __launch_bounds__(kTailArgmaxThreads) tail_argmax_kernel(
    const int2* __restrict__ ws, const float* __restrict__ pert_s,
    const int* __restrict__ s_ids, const int* __restrict__ pos,
    int* __restrict__ out_idx, float* __restrict__ out_max, int m_cap, int k,
    int chunks) {
  __shared__ float red_v[kTailArgmaxThreads / 32];
  __shared__ int red_i[kTailArgmaxThreads / 32];
  const int ti = blockIdx.x;
  const float* ps = pert_s + static_cast<size_t>(ti) * k;
  float bv = -INFINITY;
  int bi = 0x7fffffff;
  for (int e = threadIdx.x; e < k; e += blockDim.x)
    argmax_merge(bv, bi, ps[e], e);
  // launched early (programmatic dependent launch): wait until the score
  // grid has finished and its pairs are visible
  repro_torch::wait_for_previous_grid();
  const int2* w = ws + static_cast<size_t>(ti) * chunks;
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
    const int2 p = w[c];
    argmax_merge(bv, bi, __int_as_float(p.x), p.y);
  }
  block_argmax(bv, bi, red_v, red_i);
  if (threadIdx.x == 0) {
    out_idx[ti] = bi < k ? s_ids[static_cast<size_t>(ti) * k + bi]
                         : pos[static_cast<size_t>(ti) * m_cap + bi - k];
    out_max[ti] = bv;
  }
}

int set_smem(const void* fn, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

int round_up4(int d) { return (d + 3) & ~3; }

// Enqueues a screen's select (ivf_screen_topk_kernel or
// pq_screen_topk_kernel) after its score pass: a programmatic dependent of
// it where one ran (scored), an ordinary launch where none did.
template <typename Kernel, typename... Args>
int launch_screen_topk(Kernel kern, bool scored, int b, int k, cudaStream_t s,
                       Args... args) {
  const size_t smem = sizeof(unsigned long long) * 64 * ((k + 63) / 64);
  const int e = set_smem(reinterpret_cast<const void*>(kern), smem);
  if (e) return e;
  if (!scored) {
    kern<<<b, kThreads, smem, s>>>(args...);
    return static_cast<int>(cudaGetLastError());
  }
  return repro_torch::launch_dependent(kern, dim3(b), dim3(kThreads), smem,
                                       s, args...);
}

}  // namespace

// Shared memory of one screen topk block (ivf_screen_select,
// pq_screen_select), in bytes: the k selected keys in 64-key runs and the
// two histograms; the caller checks it against the card's per-block limit
// before launching.
extern "C" long long screen_topk_smem(int k) {
  return static_cast<long long>(sizeof(unsigned long long)) * 64 *
             ((k + 63) / 64) +
         static_cast<long long>(sizeof(int)) * (2 * 256 + 4);
}

// Shapes: member_vecs (n_c, cap, d) f32, member_ids (n_c, cap) i32,
// overflow_scores (b, o_cap) f32, overflow_ids (o_cap,) i32,
// probe (b, n_probe) i32, probe_width (b,) i32 or NULL (full width),
// q (b, d) f32 -> out_vals (b, k) f32, out_ids (b, k) i32.
// keys: b * n_probe * cap 64-bit keys of workspace, 8-byte aligned; ws:
// ws_len int32 of the score pass's plan workspace (ivf::workspace_ints).
// pool_pow2 is a power of two >= max(n_probe * cap + o_cap, k), at most
// kTopkKeys * 1024.
// Enqueues the score pass and the topk kernel; returns the CUDA error code
// of the launches (0 = success).
extern "C" int ivf_screen_select_launch(
    const float* member_vecs, const int* member_ids,
    const float* overflow_scores, const int* overflow_ids, const int* probe,
    const int* probe_width, const float* q, float* out_vals, int* out_ids,
    unsigned long long* keys, int* ws, long long ws_len, int n_c, int cap,
    int d, int b, int n_probe, int o_cap, int k, int pool_pow2,
    void* stream) {
  if (b == 0 || k == 0) return 0;
  if (pool_pow2 > kTopkKeys * kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool scored = n_probe > 0 && cap > 0;
  int e = repro_torch::ivf::launch_scores(
      ivf_screen_score_small_kernel, ivf_screen_plan_kernel,
      ivf_screen_score_kernel, KeySink{keys, cap, n_probe}, member_vecs,
      member_ids, probe, probe_width, q, ws, ws_len, n_c, cap, d, b, n_probe,
      s);
  if (e) return e;
  return launch_screen_topk(
      ivf_screen_topk_kernel, scored, b, k, s,
      static_cast<const unsigned long long*>(keys), member_ids,
      overflow_scores, overflow_ids, probe, probe_width, out_vals, out_ids,
      n_c, cap, n_probe, o_cap, k, pool_pow2);
}

// Shapes: emb (n, d) f32, pos (t, m_cap) i32, m_used (t,) i32,
// pert_s (t, k) f32, s_ids (t, k) i32, heights (t, m_cap) f32, h (t, d) f32
// -> out_idx (t,) i32, out_max (t,) f32; ws: t * max(1, ceil(m_cap / 32))
// (value, index) pairs of workspace, 8-byte aligned.
// Enqueues the score and argmax kernels; returns the CUDA error code of the
// launches (0 = success).
extern "C" int tail_gather_argmax_launch(
    const float* emb, const int* pos, const int* m_used, const float* pert_s,
    const int* s_ids, const float* heights, const float* h, int* out_idx,
    float* out_max, int2* ws, int n, int d, int t, int m_cap, int k,
    void* stream) {
  if (t == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int sms = 0;
  int e = repro_torch::sm_count(&sms);
  if (e) return e;
  // chunks of a token's slots that run as blocks of their own: all of them
  // for a few tokens, fewer once the batch fills kTailWarpsPerSM warps an SM
  const int chunks = m_cap > kTailRows ? (m_cap + kTailRows - 1) / kTailRows : 1;
  const int per_token = (kTailWarpsPerSM * sms / kTailRows + t - 1) / t;
  const int g = chunks < per_token ? chunks : per_token;
  const size_t smem = sizeof(float) * round_up4(d);
  e = set_smem(reinterpret_cast<const void*>(tail_score_kernel), smem);
  if (e) return e;
  tail_score_kernel<<<dim3(t, g), kThreads, smem, s>>>(
      emb, pos, m_used, heights, h, ws, n, d, m_cap, k);
  e = static_cast<int>(cudaGetLastError());
  if (e) return e;
  return repro_torch::launch_dependent(
      tail_argmax_kernel, dim3(t), dim3(kTailArgmaxThreads), 0, s,
      static_cast<const int2*>(ws), pert_s, s_ids, pos, out_idx, out_max,
      m_cap, k, g);
}

// Shapes: member_codes (n_c, cap, m_sub) u8, member_ids (n_c, cap) i32,
// coarse (b, n_probe) f32, overflow_scores (b, o_cap) f32,
// overflow_ids (o_cap,) i32, probe (b, n_probe) i32, probe_width (b,) i32
// or NULL (full width), lut (b, m_sub, ksub) f32
// -> out_vals (b, r) f32, out_ids (b, r) i32; keys: b * n_probe * cap
// 64-bit keys of workspace, 8-byte aligned. pool_pow2 is a power of two
// >= max(n_probe * cap + o_cap, r), at most kTopkKeys * 1024.
// Enqueues the score and topk kernels; returns the CUDA error code of the
// launches (0 = success).
extern "C" int pq_screen_select_launch(
    const uint8_t* member_codes, const int* member_ids, const float* coarse,
    const float* overflow_scores, const int* overflow_ids, const int* probe,
    const int* probe_width, const float* lut, float* out_vals, int* out_ids,
    unsigned long long* keys, int n_c, int cap, int m_sub, int ksub, int b,
    int n_probe, int o_cap, int r, int pool_pow2, void* stream) {
  if (b == 0 || r == 0) return 0;
  if (pool_pow2 > kTopkKeys * kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool scored = n_probe > 0 && cap > 0;
  if (scored) {
    int parts = 0;
    int e = repro_torch::pq::score_parts(b, n_probe, cap, &parts);
    if (e) return e;
    const size_t smem = sizeof(float) * m_sub * ksub;
    e = set_smem(reinterpret_cast<const void*>(pq_screen_score_kernel), smem);
    if (e) return e;
    pq_screen_score_kernel<<<dim3(b, n_probe * parts), repro_torch::pq::kRows,
                             smem, s>>>(
        member_codes, probe, lut,
        PqKeySink{KeySink{keys, cap, n_probe}, member_ids, coarse,
                  probe_width},
        n_c, cap, m_sub, ksub, n_probe, parts);
    e = static_cast<int>(cudaGetLastError());
    if (e) return e;
  }
  return launch_screen_topk(
      pq_screen_topk_kernel, scored, b, r, s,
      static_cast<const unsigned long long*>(keys), member_ids,
      overflow_scores, overflow_ids, probe, probe_width, out_vals, out_ids,
      n_c, cap, n_probe, o_cap, r, pool_pow2);
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
  int sms = 0;
  int e = repro_torch::sm_count(&sms);
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
