// Cluster-major scoring of IVF probes, shared by ivf_gather_score.cu (which
// writes each (query, probe slot) pair's member scores and ids) and
// decode_fused.cu's ivf_screen_select (which writes one 64-bit sort key per
// pool slot). Both run this code with their own sink, so the fused screen's
// scores are the unfused probe's bit for bit by construction.
//
// A batch of more than kSmallQ queries takes two kernels:
//
//   * a plan kernel (one block, plan_body) counts the live (query, probe
//     slot) pairs of each cluster with integer atomics, scans the counts in
//     cluster order, cuts each cluster's list into work items of at most qc
//     = 16 pairs — so a cluster probed by the whole batch spreads over many
//     blocks — and files every pair into its cluster's list;
//   * the score kernel's grid is (work item, chunk of kRows member rows;
//     item_body); blocks past the plan's item count exit at once. It is a
//     programmatic dependent launch (pdl.cuh): scheduled while the plan
//     runs, it waits for the plan on the device.
//
// A batch of at most kSmallQ queries (the serving probe) skips the plan: the
// grid is (pair, row chunk; small_body), and each block scans the few probe
// ids for the live pairs naming its pair's cluster; the block of the first
// pair of each chunk of qc = 4 such pairs scores the chunk, the others exit.
//
// Either way a block scores one chunk of one cluster's rows against up to
// qc queries (score_rows): it stages the queries in shared memory (qc * d
// floats; 128 KB at d 2048 and qc 16) and lets the sink copy what it needs
// of the member ids; each warp then holds two member rows' float4 chunks in
// registers, kSeg chunk steps at a time, and folds them into one running
// sum per (row, query), so one q float4 read from shared memory feeds both
// rows. Sums are carried across the loop over d, so any d fits the
// registers. Probe ids clamp into [0, n_c) as an XLA gather does; a query
// naming a cluster twice is two pairs and gets both slots filled.
//
// A pair is live when its probe slot lies below its query's probe width
// (all slots when the width pointer is NULL); dead pairs are never listed
// and never read. A sink with kSkipDead reads no dead member row (id < 0):
// a chunk with no live row is skipped whole, and a warp whose two rows are
// both dead loads nothing; the sink stores such a row's result as dead.
//
// The order of the sums: every (row, query) sum folds the lane's chunks l,
// l+32, ... in increasing order with repro_torch::fma4 from 0, then
// repro_torch::warp_butterfly — the pieces warp_row_dot is made of
// (row_dot.cuh); when d % 4 != 0 it is warp_row_dot's scalar path. No float
// atomics: the pair order inside an item changes nothing, each score is a
// function of its row and query only, and two launches agree bit for bit.
#pragma once

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "pdl.cuh"
#include "row_dot.cuh"

namespace repro_torch {
namespace ivf {

constexpr int kWarps = 16;               // score kernels: 512 threads
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 2 * kWarps;        // member rows per block
constexpr int kQSmemBytes = 200 * 1024;  // budget of the staged queries
constexpr int kPlanThreads = 1024;
// Queries scored at once: up to 16 (batches above kSmallQ), or, for
// batches of at most kSmallQ (the small kernel), 4 — a quarter of the
// accumulators, so two blocks share an SM and keep twice the rows in flight.
constexpr int kMaxQ = 16;
constexpr int kSmallQ = 4;

__device__ __forceinline__ int clamp_cluster(int c, int n_c) {
  return min(max(c, 0), n_c - 1);
}

// Whether pair p (query p / n_probe, probe slot p % n_probe) lies below its
// query's probe width; a NULL width keeps every slot.
__device__ __forceinline__ bool pair_live(const int* __restrict__ width,
                                          int p, int n_probe) {
  if (width == nullptr) return true;
  const int w = min(max(width[p / n_probe], 0), n_probe);
  return p % n_probe < w;
}

// The plan, by one block of kPlanThreads. Workspace (int32): count[n_c]
// (then each cluster's cursor), pairs[P], items[3 * max_items] as
// (cluster, first pair, pairs), n_items[1].
__device__ __forceinline__ void plan_body(const int* __restrict__ probe,
                                          const int* __restrict__ width,
                                          int P, int n_c, int n_probe, int qc,
                                          int* __restrict__ count,
                                          int* __restrict__ pairs,
                                          int* __restrict__ items,
                                          int* __restrict__ n_items) {
  __shared__ int warp_k[kPlanThreads / 32];
  __shared__ int warp_m[kPlanThreads / 32];
  __shared__ int carry[2];
  // the score kernel may be scheduled now; it waits for this grid's end
  allow_dependent_launch();
  const unsigned full = 0xffffffffu;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int c = tid; c < n_c; c += kPlanThreads) count[c] = 0;
  if (tid < 2) carry[tid] = 0;
  __syncthreads();
  for (int p = tid; p < P; p += kPlanThreads)
    if (pair_live(width, p, n_probe))
      atomicAdd(count + clamp_cluster(probe[p], n_c), 1);
  __syncthreads();

  // exclusive scans, in cluster order, of the pair counts (each cluster's
  // first pair) and of the item counts (its first item)
  for (int c0 = 0; c0 < n_c; c0 += kPlanThreads) {
    const int c = c0 + tid;
    const int k = c < n_c ? count[c] : 0;
    const int m = (k + qc - 1) / qc;
    int ks = k;
    int ms = m;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int a = __shfl_up_sync(full, ks, o);
      const int e = __shfl_up_sync(full, ms, o);
      if (lane >= o) {
        ks += a;
        ms += e;
      }
    }
    if (lane == 31) {
      warp_k[warp] = ks;
      warp_m[warp] = ms;
    }
    __syncthreads();
    if (warp == 0) {  // kPlanThreads / 32 == 32 warp sums
      const int a0 = warp_k[lane];
      const int e0 = warp_m[lane];
      int a = a0;
      int e = e0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int x = __shfl_up_sync(full, a, o);
        const int y = __shfl_up_sync(full, e, o);
        if (lane >= o) {
          a += x;
          e += y;
        }
      }
      warp_k[lane] = a - a0;
      warp_m[lane] = e - e0;
    }
    __syncthreads();
    const int p0 = carry[0] + warp_k[warp] + ks - k;
    const int i0 = carry[1] + warp_m[warp] + ms - m;
    for (int t = 0; t < m; ++t) {
      items[3 * (i0 + t)] = c;
      items[3 * (i0 + t) + 1] = p0 + t * qc;
      items[3 * (i0 + t) + 2] = min(qc, k - t * qc);
    }
    if (c < n_c) count[c] = p0;  // the cluster's cursor into pairs
    __syncthreads();
    if (tid == kPlanThreads - 1) {
      carry[0] = p0 + k;
      carry[1] = i0 + m;
    }
    __syncthreads();
  }
  if (tid == 0) *n_items = carry[1];

  // each live pair into its cluster's list; the order inside a list is the
  // atomics' (it decides only which block of the cluster scores a pair,
  // never a value)
  for (int p = tid; p < P; p += kPlanThreads)
    if (pair_live(width, p, n_probe))
      pairs[atomicAdd(count + clamp_cluster(probe[p], n_c), 1)] = p;
}

// Scores rows [r0, r0 + kRows) of cluster cl against the nq <= kQ queries
// of the pairs in s_pair (the whole block calls it): stages those queries
// in sq, lets the sink copy the chunk's member ids, and hands it every
// (pair, row) result: sink.store(pair, row of the cluster, score, live).
// Ends with a block barrier, so sq and s_pair may be refilled after it.
// kQ: the most queries staged at once (one register accumulator each per
// row); kSeg: float4 chunk steps per lane loaded per pass over d.
template <int kQ, int kSeg, typename Sink>
__device__ __forceinline__ void score_rows(
    const float* __restrict__ member_vecs, const int* __restrict__ member_ids,
    const float* __restrict__ q, const int* s_pair, int nq, int cl, int r0,
    const Sink& sink, int cap, int d, int n_probe, float* sq) {
  const int rows = min(kRows, cap - r0);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int* mid = member_ids + static_cast<size_t>(cl) * cap + r0;

  if (Sink::kSkipDead) {
    // a chunk with no live member: every result dead, no row or query read
    if (!__syncthreads_or(tid < rows && mid[tid] >= 0)) {
      for (int i = tid; i < nq * rows; i += blockDim.x) {
        const int j = i / rows;
        sink.store(s_pair[j], r0 + i - j * rows, -INFINITY, false);
      }
      __syncthreads();
      return;  // block-uniform
    }
  }

  // the queries into shared memory, and the member ids the sink keeps
  const bool vec = (d & 3) == 0;
  if (vec && (reinterpret_cast<uintptr_t>(q) & 15) == 0) {
    const int d4 = d >> 2;
    float4* s4 = reinterpret_cast<float4*>(sq);
    const float4* q4 = reinterpret_cast<const float4*>(q);
    for (int i = tid; i < nq * d4; i += blockDim.x) {
      const int j = i / d4;
      s4[i] = __ldg(q4 + static_cast<size_t>(s_pair[j] / n_probe) * d4 +
                    (i - j * d4));
    }
  } else {
    for (int i = tid; i < nq * d; i += blockDim.x) {
      const int j = i / d;
      sq[i] = __ldg(q + static_cast<size_t>(s_pair[j] / n_probe) * d +
                    (i - j * d));
    }
  }
  sink.copy_ids(s_pair, nq, mid, r0, rows);
  __syncthreads();

  const int ra = 2 * warp;  // this warp's rows ra, ra + 1 of the chunk
  const bool has_b = ra + 1 < rows;
  const bool live_a = ra < rows && (!Sink::kSkipDead || mid[ra] >= 0);
  const bool live_b = has_b && (!Sink::kSkipDead || mid[ra + 1] >= 0);
  const float* tile =
      member_vecs + (static_cast<size_t>(cl) * cap + r0) * d;
  if (ra < rows && !live_a && !live_b) {  // warp-uniform: nothing to read
    if (lane < nq) {
      sink.store(s_pair[lane], r0 + ra, -INFINITY, false);
      if (has_b) sink.store(s_pair[lane], r0 + ra + 1, -INFINITY, false);
    }
  } else if (ra < rows && !vec) {  // warp_row_dot's scalar path, one at a time
    for (int j = 0; j < nq; ++j) {
      for (int r = ra; r < ra + (has_b ? 2 : 1); ++r) {
        const bool live = r == ra ? live_a : live_b;
        const float s =
            live ? repro_torch::warp_row_dot(tile + static_cast<size_t>(r) * d,
                                             sq + j * d, d, lane)
                 : -INFINITY;
        if (lane == 0) sink.store(s_pair[j], r0 + r, s, live);
      }
    }
  } else if (ra < rows) {  // warp-uniform
    const int d4 = d >> 2;
    // a dead row of the two is never read: its slot reads the live one
    // again, and its sums are dropped
    const float4* row_a = reinterpret_cast<const float4*>(
        tile + static_cast<size_t>(live_a ? ra : ra + 1) * d);
    const float4* row_b =
        live_b ? reinterpret_cast<const float4*>(
                     tile + static_cast<size_t>(ra + 1) * d)
               : row_a;
    const float4* s4 = reinterpret_cast<const float4*>(sq);
    float acc_a[kQ];
    float acc_b[kQ];
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
      acc_a[j] = 0.f;
      acc_b[j] = 0.f;
    }
    for (int i0 = lane; i0 < d4; i0 += 32 * kSeg) {
      float4 va[kSeg];
      float4 vb[kSeg];
#pragma unroll
      for (int t = 0; t < kSeg; ++t) {
        const int i = i0 + 32 * t;
        if (i < d4) {
          va[t] = __ldg(row_a + i);
          vb[t] = __ldg(row_b + i);
        }
      }
#pragma unroll
      for (int j = 0; j < kQ; ++j) {
        if (j < nq) {
#pragma unroll
          for (int t = 0; t < kSeg; ++t) {
            const int i = i0 + 32 * t;
            if (i < d4) {  // chunks in increasing order, as warp_row_dot
              const float4 qv = s4[j * d4 + i];
              acc_a[j] = repro_torch::fma4(acc_a[j], va[t], qv);
              acc_b[j] = repro_torch::fma4(acc_b[j], vb[t], qv);
            }
          }
        }
      }
    }
    // every lane gets every sum; lane j stores query j's two results
    float wa = 0.f;
    float wb = 0.f;
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
      if (j < nq) {
        const float sa = repro_torch::warp_butterfly(acc_a[j]);
        const float sb = repro_torch::warp_butterfly(acc_b[j]);
        if (lane == j) {
          wa = sa;
          wb = sb;
        }
      }
    }
    if (lane < nq) {
      sink.store(s_pair[lane], r0 + ra, live_a ? wa : -INFINITY, live_a);
      if (has_b)
        sink.store(s_pair[lane], r0 + ra + 1, live_b ? wb : -INFINITY,
                   live_b);
    }
  }
  __syncthreads();
}

// The score kernel of a plan (batches above kSmallQ): grid (work item of
// the plan, row chunk). sq: the kernel's dynamic shared memory, nq * d.
template <typename Sink>
__device__ __forceinline__ void item_body(
    const float* __restrict__ member_vecs, const int* __restrict__ member_ids,
    const float* __restrict__ q, const int* __restrict__ pairs,
    const int* __restrict__ items, const int* __restrict__ n_items,
    const Sink& sink, int cap, int d, int n_probe, float* sq) {
  __shared__ int s_pair[kMaxQ];
  // launched early (programmatic dependent launch): wait until the plan
  // grid has finished and its lists are visible; a kernel enqueued as this
  // one's dependent may be scheduled from then on
  wait_for_previous_grid();
  allow_dependent_launch();
  const int item = blockIdx.x;
  if (item >= *n_items) return;  // block-uniform
  const int nq = items[3 * item + 2];
  if (threadIdx.x < nq)
    s_pair[threadIdx.x] = pairs[items[3 * item + 1] + threadIdx.x];
  __syncthreads();
  score_rows<kMaxQ, 4>(member_vecs, member_ids, q, s_pair, nq,
                       items[3 * item], blockIdx.y * kRows, sink, cap, d,
                       n_probe, sq);
}

// Batches of at most kSmallQ queries, no plan: grid (pair, row chunk). A
// block's warp 0 lists the live pairs naming its pair's cluster, in
// increasing order (the P probe ids are few); the pairs at ranks 0, qc,
// 2 qc, ... of that list lead a chunk of qc, and only their blocks score:
// so each cluster tile is read once per qc queries, and the other blocks
// exit at once. smem: the kernel's dynamic shared memory, qc * d floats
// then P ints.
template <typename Sink>
__device__ __forceinline__ void small_body(
    const float* __restrict__ member_vecs, const int* __restrict__ member_ids,
    const int* __restrict__ probe, const int* __restrict__ width,
    const float* __restrict__ q, const Sink& sink, int n_c, int cap, int d,
    int n_probe, int P, int qc, float* sq) {
  int* s_list = reinterpret_cast<int*>(sq + static_cast<size_t>(qc) * d);
  __shared__ int s_first;
  __shared__ int s_nq;
  // a kernel enqueued as this one's dependent may be scheduled now
  allow_dependent_launch();
  const int p = blockIdx.x;
  if (!pair_live(width, p, n_probe)) return;  // block-uniform
  const int cl = clamp_cluster(probe[p], n_c);
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int n = 0;
    int rank = 0;
    for (int base = 0; base < P; base += 32) {
      const int i = base + lane;
      const bool hit = i < P && pair_live(width, i, n_probe) &&
                       clamp_cluster(probe[i], n_c) == cl;
      const unsigned m = __ballot_sync(0xffffffffu, hit);
      const int at = n + __popc(m & ((1u << lane) - 1u));
      if (hit) s_list[at] = i;
      if (hit && i == p) rank = at;
      n += __popc(m);
    }
    rank = __reduce_max_sync(0xffffffffu, rank);
    if (lane == 0) {
      s_first = rank;
      s_nq = rank % qc == 0 ? min(qc, n - rank) : 0;
    }
  }
  __syncthreads();
  const int nq = s_nq;
  if (nq == 0) return;  // block-uniform: another block scores this pair
  score_rows<kSmallQ, 4>(member_vecs, member_ids, q, s_list + s_first, nq,
                         cl, blockIdx.y * kRows, sink, cap, d, n_probe, sq);
}

// Queries an item stages: the variant's kQ, or fewer where d is wide.
inline int queries_per_item(int d, int b) {
  const int kq = b <= kSmallQ ? kSmallQ : kMaxQ;
  const int fit = kQSmemBytes / (static_cast<int>(sizeof(float)) * d);
  return fit < kq ? fit : kq;
}

inline long long max_items(int n_c, long long P, int qc) {
  return (n_c < P ? n_c : P) + (P + qc - 1) / qc;
}

// Workspace ints a call needs (the caller may pass more: the wrappers pass
// the bound at qc = 1, n_c + P + 3 * (min(n_c, P) + P) + 1).
inline long long workspace_ints(int n_c, long long P, int qc) {
  return n_c + P + 3 * max_items(n_c, P, qc) + 1;
}

inline int set_max_smem(const void* kern, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

// Enqueues the scores of every live (query, probe slot) pair into the sink:
// the small kernel for at most kSmallQ queries, else the plan and the score
// kernel. The kernels are the caller's __global__ wrappers of small_body,
// plan_body and item_body (each source names its own, so a profile tells
// them apart). ws: ws_len int32 of workspace (workspace_ints; the small
// kernel does not use it). Returns the CUDA error code of the launches
// (0 = success); enqueues nothing when no pair exists.
template <typename Sink>
int launch_scores(
    void (*small)(const float*, const int*, const int*, const int*,
                  const float*, Sink, int, int, int, int, int, int),
    void (*plan)(const int*, const int*, int, int, int, int, int*, int*,
                 int*, int*),
    void (*item)(const float*, const int*, const float*, const int*,
                 const int*, const int*, Sink, int, int, int),
    Sink sink, const float* member_vecs, const int* member_ids,
    const int* probe, const int* width, const float* q, int* ws,
    long long ws_len, int n_c, int cap, int d, int b, int n_probe,
    cudaStream_t s) {
  if (b == 0 || n_probe == 0 || cap == 0) return 0;
  const int qc = queries_per_item(d, b);
  const long long P = static_cast<long long>(b) * n_probe;
  if (qc < 1 || n_c < 1 || workspace_ints(n_c, P, qc) > ws_len)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long items_max = max_items(n_c, P, qc);
  int* count = ws;
  int* pairs = count + n_c;
  int* items = pairs + P;
  int* n_items = items + 3 * items_max;

  const int row_chunks = (cap + kRows - 1) / kRows;
  const size_t smem_q = sizeof(float) * static_cast<size_t>(qc) * d;
  if (b <= kSmallQ) {  // no plan: each cluster's first pair finds the rest
    const size_t smem = smem_q + sizeof(int) * static_cast<size_t>(P);
    const int e = set_max_smem(reinterpret_cast<const void*>(small), smem);
    if (e) return e;
    small<<<dim3(static_cast<unsigned>(P), row_chunks), kThreads, smem, s>>>(
        member_vecs, member_ids, probe, width, q, sink, n_c, cap, d, n_probe,
        static_cast<int>(P), qc);
    return static_cast<int>(cudaGetLastError());
  }
  plan<<<1, kPlanThreads, 0, s>>>(probe, width, static_cast<int>(P), n_c,
                                  n_probe, qc, count, pairs, items, n_items);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int e2 = set_max_smem(reinterpret_cast<const void*>(item), smem_q);
  if (e2) return e2;
  return launch_dependent(
      item, dim3(static_cast<unsigned>(items_max), row_chunks),
      dim3(kThreads), smem_q, s, member_vecs, member_ids, q,
      static_cast<const int*>(pairs), static_cast<const int*>(items),
      static_cast<const int*>(n_items), sink, cap, d, n_probe);
}

}  // namespace ivf
}  // namespace repro_torch
