// ivf_gather_score: score every member of each query's probed IVF clusters.
//
// Replaces the Pallas TPU kernel
// repro/kernels/ivf_gather_score.py::ivf_gather_score (grid (b, n_probe,
// d/d_block): the scalar-prefetched probe ids pick one (cap, d_block)
// cluster tile per step, accumulated in fp32 over d; the cluster's id row is
// copied alongside).
//
// What bounds it on an H100: bytes. Each (query, probe) pair streams one
// (cap, d) fp32 cluster tile, cap * d * 4 bytes, for 2 * cap * d flops:
// half a flop per byte.
//
// Design: grid (n_probe, b, row chunks). A block loads q into shared memory
// once, then each of its warps scores whole member rows with
// repro_torch::warp_row_dot (row_dot.cuh) — 16-byte loads, neighbouring
// lanes on neighbouring addresses, fp32 accumulation — and writes the score
// and the member id. The row chunks spread one cluster tile over several
// SMs so that a small batch still keeps many SMs streaming. decode_fused.cu
// scores members with the same device function, which keeps the fused
// screen bitwise equal to this kernel's scores.
#include <cuda_runtime.h>

#include "row_dot.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerBlock = 64;

__global__ void __launch_bounds__(kWarps * 32)
    ivf_gather_score_kernel(const float* __restrict__ member_vecs,
                            const int* __restrict__ member_ids,
                            const int* __restrict__ probe,
                            const float* __restrict__ q,
                            float* __restrict__ scores, int* __restrict__ ids,
                            int n_c, int cap, int d, int n_probe) {
  extern __shared__ __align__(16) float sq[];
  const int j = blockIdx.x;
  const int bi = blockIdx.y;
  const int r0 = blockIdx.z * kRowsPerBlock;
  const int r1 = min(cap, r0 + kRowsPerBlock);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // out-of-range cluster ids clamp, as an XLA gather does
  const int cl = min(max(probe[bi * n_probe + j], 0), n_c - 1);

  repro_torch::load_query(sq, q + static_cast<size_t>(bi) * d, d);
  __syncthreads();

  const float* tile = member_vecs + static_cast<size_t>(cl) * cap * d;
  const size_t out0 = (static_cast<size_t>(bi) * n_probe + j) * cap;
  for (int r = r0 + warp; r < r1; r += kWarps) {
    const float s =
        repro_torch::warp_row_dot(tile + static_cast<size_t>(r) * d, sq, d,
                                  lane);
    if (lane == 0) scores[out0 + r] = s;
  }
  for (int r = r0 + threadIdx.x; r < r1; r += blockDim.x)
    ids[out0 + r] = member_ids[static_cast<size_t>(cl) * cap + r];
}

}  // namespace

// Shapes: member_vecs (n_c, cap, d) f32, member_ids (n_c, cap) i32,
// probe (b, n_probe) i32, q (b, d) f32 -> scores, ids (b, n_probe, cap).
// Returns the CUDA error code of the launch (0 = success).
extern "C" int ivf_gather_score_launch(const float* member_vecs,
                                       const int* member_ids,
                                       const int* probe, const float* q,
                                       float* scores, int* ids, int n_c,
                                       int cap, int d, int b, int n_probe,
                                       void* stream) {
  if (b == 0 || n_probe == 0 || cap == 0) return 0;
  const size_t smem = sizeof(float) * static_cast<size_t>(d);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ivf_gather_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(n_probe, b, (cap + kRowsPerBlock - 1) / kRowsPerBlock);
  ivf_gather_score_kernel<<<grid, kWarps * 32, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      member_vecs, member_ids, probe, q, scores, ids, n_c, cap, d, n_probe);
  return static_cast<int>(cudaGetLastError());
}
