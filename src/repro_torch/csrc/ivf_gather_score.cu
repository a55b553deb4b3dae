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
// chunk of up to qc queries that probe its cluster: a plan kernel and a
// score kernel for batches above kSmallQ = 4 queries, a plan-free small
// kernel for the serving probe's few (ivf_score.cuh holds the design and
// the order of the sums). This file adds the sink that writes each pair's
// scores and member ids, dead rows included (the caller masks them).
//
// The bitwise contract: ivf_screen_select (decode_fused.cu) runs the same
// ivf_score.cuh code with a sink that writes sort keys, so every live
// member score of the fused screen is this kernel's bit for bit; both fold
// each (row, query) sum in warp_row_dot's order (row_dot.cuh).
#include <cuda_runtime.h>

#include <stdint.h>

#include "ivf_score.cuh"

namespace {

namespace ivf = repro_torch::ivf;

// Writes each pair's member scores and ids, (b, n_probe, cap) each: the
// sums of every row, dead ones too (the caller masks them).
struct GatherSink {
  static constexpr bool kSkipDead = false;
  float* scores;
  int* ids;
  int cap;

  __device__ __forceinline__ void copy_ids(const int* s_pair, int nq,
                                           const int* mid, int r0,
                                           int rows) const {
    for (int i = threadIdx.x; i < nq * rows; i += blockDim.x) {
      const int j = i / rows;
      const int r = i - j * rows;
      ids[static_cast<size_t>(s_pair[j]) * cap + r0 + r] = mid[r];
    }
  }
  __device__ __forceinline__ void store(int pair, int row, float s, bool) const {
    scores[static_cast<size_t>(pair) * cap + row] = s;
  }
};

__global__ void __launch_bounds__(ivf::kPlanThreads)
    ivf_gather_score_plan_kernel(const int* __restrict__ probe,
                                 const int* __restrict__ width, int P,
                                 int n_c, int n_probe, int qc,
                                 int* __restrict__ count,
                                 int* __restrict__ pairs,
                                 int* __restrict__ items,
                                 int* __restrict__ n_items) {
  ivf::plan_body(probe, width, P, n_c, n_probe, qc, count, pairs, items,
                 n_items);
}

// Batches above kSmallQ queries: grid (work item of the plan, row chunk).
__global__ void __launch_bounds__(ivf::kThreads, 1)
    ivf_gather_score_kernel(const float* __restrict__ member_vecs,
                            const int* __restrict__ member_ids,
                            const float* __restrict__ q,
                            const int* __restrict__ pairs,
                            const int* __restrict__ items,
                            const int* __restrict__ n_items, GatherSink sink,
                            int cap, int d, int n_probe) {
  extern __shared__ __align__(16) float sq[];  // nq * d
  ivf::item_body(member_vecs, member_ids, q, pairs, items, n_items, sink,
                 cap, d, n_probe, sq);
}

// Batches of at most kSmallQ queries, no plan: grid (pair, row chunk).
__global__ void __launch_bounds__(ivf::kThreads, 2)
    ivf_gather_score_small_kernel(const float* __restrict__ member_vecs,
                                  const int* __restrict__ member_ids,
                                  const int* __restrict__ probe,
                                  const int* __restrict__ width,
                                  const float* __restrict__ q,
                                  GatherSink sink, int n_c, int cap, int d,
                                  int n_probe, int P, int qc) {
  extern __shared__ __align__(16) float sq[];  // qc * d, then P pair ids
  ivf::small_body(member_vecs, member_ids, probe, width, q, sink, n_c, cap,
                  d, n_probe, P, qc, sq);
}

}  // namespace

// Shapes: member_vecs (n_c, cap, d) f32, member_ids (n_c, cap) i32,
// probe (b, n_probe) i32, q (b, d) f32 -> scores, ids (b, n_probe, cap);
// ws: ws_len int32 of workspace (ivf::workspace_ints; the small kernel does
// not use it). Enqueues the kernels; returns the CUDA error code
// of the launches (0 = success).
extern "C" int ivf_gather_score_launch(const float* member_vecs,
                                       const int* member_ids,
                                       const int* probe, const float* q,
                                       float* scores, int* ids, int* ws,
                                       long long ws_len, int n_c, int cap,
                                       int d, int b, int n_probe,
                                       void* stream) {
  return ivf::launch_scores(
      ivf_gather_score_small_kernel, ivf_gather_score_plan_kernel,
      ivf_gather_score_kernel, GatherSink{scores, ids, cap}, member_vecs,
      member_ids, probe, static_cast<const int*>(nullptr), q, ws, ws_len,
      n_c, cap, d, b, n_probe, static_cast<cudaStream_t>(stream));
}
