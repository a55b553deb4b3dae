// ivf_gather_score: score every member of each query's probed IVF clusters.
//
// Replaces the Pallas TPU kernel
// repro/kernels/ivf_gather_score.py::ivf_gather_score (grid (b, n_probe,
// d/d_block): the scalar-prefetched probe ids pick one (cap, d_block)
// cluster tile per step, accumulated in fp32 over d; the cluster's id row is
// copied alongside).
//
// What bounds it on an H100: bytes — the distinct probed cluster tiles,
// (cap, d) fp32 each, read once, and the (b, n_probe, cap) scores and ids
// written. A kernel that streams one tile per (query, probe) pair instead
// reads each tile as many times as queries probe it: at the training
// probe's 256 queries, 9.1 GB through L2 for 793 MB of distinct tiles, and
// trained hidden states pile onto popular clusters.
//
// Design: cluster-major, each member row read from device memory once per
// chunk of up to qc queries that probe its cluster. A batch of more than
// kSmallQ queries takes two kernels, enqueued by one C call:
//
//   * a plan kernel (one block) counts the (query, probe slot) pairs of each
//     cluster with integer atomics, scans the counts in cluster order, cuts
//     each cluster's list into work items of at most qc = 16 pairs — so a
//     cluster probed by the whole batch spreads over many blocks — and
//     files every pair into its cluster's list;
//   * the score kernel's grid is (work item, chunk of kRows member rows);
//     blocks past the plan's item count exit at once. It is a programmatic
//     dependent launch (pdl.cuh): scheduled while the plan runs, it waits
//     for the plan on the device.
//
// A batch of at most kSmallQ queries (the serving probe) skips the plan:
// the grid is (pair, row chunk), and each block scans the few probe ids
// for the pairs naming its pair's cluster; the block of the first pair of
// each chunk of qc = 4 such pairs scores the chunk, the others exit.
//
// Either way a block scores one chunk of one cluster's rows against up to
// qc queries (score_rows): it stages the queries in shared memory (qc * d
// floats; 128 KB at d 2048 and qc 16) and writes the member ids of every
// pair; each warp then holds two member rows' float4 chunks in registers,
// kSeg chunk steps at a time, and folds them into one running sum per
// (row, query), so one q float4 read from shared memory feeds both rows.
// Sums are carried across the loop over d, so any d fits the registers.
// Probe ids clamp into [0, n_c) as an XLA gather does; a query naming a
// cluster twice is two pairs and gets both slots filled.
//
// The bitwise contract: ivf_screen_select (decode_fused.cu) scores a member
// with repro_torch::warp_row_dot, and must get this kernel's score bit for
// bit. Every (row, query) sum here folds the lane's chunks l, l+32, ... in
// increasing order with repro_torch::fma4 from 0, then repro_torch::
// warp_butterfly — the pieces warp_row_dot is made of (row_dot.cuh); when
// d % 4 != 0 both take warp_row_dot's scalar path. No float atomics: the
// pair order inside an item changes nothing, each score is a function of its
// row and query only, and two launches agree bit for bit.
#include <cuda_runtime.h>

#include <stdint.h>

#include "pdl.cuh"
#include "row_dot.cuh"

namespace {

constexpr int kWarps = 16;               // score kernel: 512 threads
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

// Workspace (int32): count[n_c] (then each cluster's cursor), pairs[P],
// items[3 * max_items] as (cluster, first pair, pairs), n_items[1].
__global__ void __launch_bounds__(kPlanThreads)
    ivf_gather_score_plan_kernel(const int* __restrict__ probe, int P,
                                 int n_c, int qc, int* __restrict__ count,
                                 int* __restrict__ pairs,
                                 int* __restrict__ items,
                                 int* __restrict__ n_items) {
  __shared__ int warp_k[kPlanThreads / 32];
  __shared__ int warp_m[kPlanThreads / 32];
  __shared__ int carry[2];
  // the score kernel may be scheduled now; it waits for this grid's end
  repro_torch::allow_dependent_launch();
  const unsigned full = 0xffffffffu;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int c = tid; c < n_c; c += kPlanThreads) count[c] = 0;
  if (tid < 2) carry[tid] = 0;
  __syncthreads();
  for (int p = tid; p < P; p += kPlanThreads)
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

  // each pair into its cluster's list; the order inside a list is the
  // atomics' (it decides only which block of the cluster scores a pair,
  // never a value)
  for (int p = tid; p < P; p += kPlanThreads)
    pairs[atomicAdd(count + clamp_cluster(probe[p], n_c), 1)] = p;
}

// Scores rows [r0, r0 + kRows) of cluster cl against the nq <= kQ queries
// of the pairs in s_pair (the whole block calls it): stages those queries
// in sq, writes each pair's member ids and scores. Ends with a block
// barrier, so sq and s_pair may be refilled after it.
// kQ: the most queries staged at once (one register accumulator each per
// row); kSeg: float4 chunk steps per lane loaded per pass over d.
template <int kQ, int kSeg>
__device__ __forceinline__ void score_rows(
    const float* __restrict__ member_vecs, const int* __restrict__ member_ids,
    const float* __restrict__ q, const int* s_pair, int nq, int cl, int r0,
    float* __restrict__ scores, int* __restrict__ ids, int cap, int d,
    int n_probe, float* sq) {
  const int rows = min(kRows, cap - r0);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // the queries into shared memory, and the member ids of each pair
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
  const int* mid = member_ids + static_cast<size_t>(cl) * cap + r0;
  for (int i = tid; i < nq * rows; i += blockDim.x) {
    const int j = i / rows;
    const int r = i - j * rows;
    ids[static_cast<size_t>(s_pair[j]) * cap + r0 + r] = mid[r];
  }
  __syncthreads();

  const int ra = 2 * warp;  // this warp's rows ra, ra + 1 of the chunk
  const bool has_b = ra + 1 < rows;
  const float* tile =
      member_vecs + (static_cast<size_t>(cl) * cap + r0) * d;
  float* out = scores + r0;  // + pair * cap + row
  if (ra < rows && !vec) {  // warp_row_dot's scalar path, one at a time
    for (int j = 0; j < nq; ++j) {
      for (int r = ra; r < ra + (has_b ? 2 : 1); ++r) {
        const float s = repro_torch::warp_row_dot(
            tile + static_cast<size_t>(r) * d, sq + j * d, d, lane);
        if (lane == 0) out[static_cast<size_t>(s_pair[j]) * cap + r] = s;
      }
    }
  } else if (ra < rows) {  // warp-uniform
    const int d4 = d >> 2;
    const float4* row_a =
        reinterpret_cast<const float4*>(tile + static_cast<size_t>(ra) * d);
    const float4* row_b = has_b ? row_a + d4 : row_a;
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
    // every lane gets every sum; lane j writes query j's two scores
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
      float* o = out + static_cast<size_t>(s_pair[lane]) * cap;
      o[ra] = wa;
      if (has_b) o[ra + 1] = wb;
    }
  }
  __syncthreads();
}

// Batches above kSmallQ queries: grid (work item of the plan, row chunk).
__global__ void __launch_bounds__(kWarps * 32, 1)
    ivf_gather_score_kernel(const float* __restrict__ member_vecs,
                            const int* __restrict__ member_ids,
                            const float* __restrict__ q,
                            const int* __restrict__ pairs,
                            const int* __restrict__ items,
                            const int* __restrict__ n_items,
                            float* __restrict__ scores, int* __restrict__ ids,
                            int cap, int d, int n_probe) {
  extern __shared__ __align__(16) float sq[];  // nq * d
  __shared__ int s_pair[kMaxQ];
  // launched early (programmatic dependent launch): wait until the plan
  // grid has finished and its lists are visible
  repro_torch::wait_for_previous_grid();
  const int item = blockIdx.x;
  if (item >= *n_items) return;  // block-uniform
  const int nq = items[3 * item + 2];
  if (threadIdx.x < nq)
    s_pair[threadIdx.x] = pairs[items[3 * item + 1] + threadIdx.x];
  __syncthreads();
  score_rows<kMaxQ, 4>(member_vecs, member_ids, q, s_pair, nq,
                       items[3 * item], blockIdx.y * kRows, scores, ids, cap,
                       d, n_probe, sq);
}

// Batches of at most kSmallQ queries, no plan: grid (pair, row chunk). A
// block's warp 0 lists the pairs naming its pair's cluster, in increasing
// order (the P probe ids are few); the pairs at ranks 0, qc, 2 qc, ... of
// that list lead a chunk of qc, and only their blocks score: so each
// cluster tile is read once per qc queries, and the other blocks exit at
// once.
__global__ void __launch_bounds__(kWarps * 32, 2)
    ivf_gather_score_small_kernel(const float* __restrict__ member_vecs,
                                  const int* __restrict__ member_ids,
                                  const int* __restrict__ probe,
                                  const float* __restrict__ q,
                                  float* __restrict__ scores,
                                  int* __restrict__ ids, int n_c, int cap,
                                  int d, int n_probe, int P, int qc) {
  extern __shared__ __align__(16) float sq[];  // qc * d, then P pair ids
  int* s_list = reinterpret_cast<int*>(sq + static_cast<size_t>(qc) * d);
  __shared__ int s_first;
  __shared__ int s_nq;
  const int p = blockIdx.x;
  const int cl = clamp_cluster(probe[p], n_c);
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int n = 0;
    int rank = 0;
    for (int base = 0; base < P; base += 32) {
      const int i = base + lane;
      const bool hit = i < P && clamp_cluster(probe[i], n_c) == cl;
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
                         cl, blockIdx.y * kRows, scores, ids, cap, d,
                         n_probe, sq);
}

// Queries an item stages: the variant's kQ, or fewer where d is wide.
int queries_per_item(int d, int b) {
  const int kq = b <= kSmallQ ? kSmallQ : kMaxQ;
  const int fit = kQSmemBytes / (static_cast<int>(sizeof(float)) * d);
  return fit < kq ? fit : kq;
}

long long max_items(int n_c, long long P, int qc) {
  return (n_c < P ? n_c : P) + (P + qc - 1) / qc;
}

int set_smem(const void* kern, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

// Workspace ints a call needs (the caller may pass more: the wrapper passes
// the bound at qc = 1, n_c + P + 3 * (min(n_c, P) + P) + 1).
long long workspace_ints(int n_c, long long P, int qc) {
  return n_c + P + 3 * max_items(n_c, P, qc) + 1;
}

}  // namespace

// Shapes: member_vecs (n_c, cap, d) f32, member_ids (n_c, cap) i32,
// probe (b, n_probe) i32, q (b, d) f32 -> scores, ids (b, n_probe, cap);
// ws: ws_len int32 of workspace (workspace_ints; the small kernel does not
// use it). Enqueues the kernels; returns the CUDA error code
// of the launches (0 = success).
extern "C" int ivf_gather_score_launch(const float* member_vecs,
                                       const int* member_ids,
                                       const int* probe, const float* q,
                                       float* scores, int* ids, int* ws,
                                       long long ws_len, int n_c, int cap,
                                       int d, int b, int n_probe,
                                       void* stream) {
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  const int row_chunks = (cap + kRows - 1) / kRows;
  const size_t smem_q = sizeof(float) * static_cast<size_t>(qc) * d;
  if (b <= kSmallQ) {  // no plan: each cluster's first pair finds the rest
    const size_t smem = smem_q + sizeof(int) * static_cast<size_t>(P);
    const int e = set_smem(
        reinterpret_cast<const void*>(ivf_gather_score_small_kernel), smem);
    if (e) return e;
    ivf_gather_score_small_kernel<<<dim3(static_cast<unsigned>(P),
                                         row_chunks),
                                    kWarps * 32, smem, s>>>(
        member_vecs, member_ids, probe, q, scores, ids, n_c, cap, d, n_probe,
        static_cast<int>(P), qc);
    return static_cast<int>(cudaGetLastError());
  }
  ivf_gather_score_plan_kernel<<<1, kPlanThreads, 0, s>>>(
      probe, static_cast<int>(P), n_c, qc, count, pairs, items, n_items);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int e2 = set_smem(
      reinterpret_cast<const void*>(ivf_gather_score_kernel), smem_q);
  if (e2) return e2;
  return repro_torch::launch_dependent(
      ivf_gather_score_kernel,
      dim3(static_cast<unsigned>(items_max), row_chunks), dim3(kWarps * 32),
      smem_q, s, member_vecs, member_ids, q,
      static_cast<const int*>(pairs), static_cast<const int*>(items),
      static_cast<const int*>(n_items), scores, ids, cap, d, n_probe);
}
