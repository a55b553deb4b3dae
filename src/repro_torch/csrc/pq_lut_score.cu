// pq_lut_score: the IVF-PQ screen of every member of each query's probed
// clusters, Σ_m lut[b, m, codes[probe, c, m]].
//
// Replaces the Pallas TPU kernel
// repro/kernels/pq_lut_score.py::pq_lut_score (grid (b, n_probe): the
// scalar-prefetched probe ids pick one (cap, m_sub) uint8 code tile per
// step, and per subspace a (cap, ksub) one-hot of the codes multiplies the
// query's LUT row on the MXU — gathers by vector index do not vectorize on
// a TPU).
//
// What bounds it on an H100: at the serving path's 4 queries, launch
// latency (the probed tiles are 4 * 8 * 544 * 8 bytes = 139 KB); at the
// training probe's 256 queries, the code tiles and the per-query LUTs
// (8 KB each) — a few MB, microseconds at the card's memory rate. The work
// is m_sub table lookups and adds per member, no multiply.
//
// Design: grid (query, part of a probed stage), 256 threads
// (pq::score_part, pq_lut.cuh, the loop decode_fused.cu's pq_screen_select
// runs too): a stage splits into parts until the grid fills the card (4
// queries: 96 blocks). A block loads its query's (m_sub, ksub) LUT into
// shared memory once; a GPU gathers by index natively, so there is no
// one-hot product: each thread scores whole members with
// repro_torch::lut_sum, which reads a member's 8 codes in one 8-byte load
// at m_sub = 8 and adds the looked-up entries in subspace order; the
// fused screen's keys therefore hold this kernel's scores plus the coarse
// term, bit for bit.
#include <cuda_runtime.h>

#include <stdint.h>

#include "pq_lut.cuh"

namespace {

// Writes every member's score, at (query * n_probe + stage) * cap + row.
struct ScoreSink {
  float* scores;
  int cap;

  __device__ __forceinline__ bool stage_live(int, int) const { return true; }
  template <typename Sum>
  __device__ __forceinline__ void store(int pair, size_t, int row,
                                        Sum sum) const {
    scores[static_cast<size_t>(pair) * cap + row] = sum();
  }
};

__global__ void __launch_bounds__(repro_torch::pq::kRows)
    pq_lut_score_kernel(const uint8_t* __restrict__ member_codes,
                        const int* __restrict__ probe,
                        const float* __restrict__ lut, ScoreSink sink,
                        int n_c, int cap, int m_sub, int ksub, int n_probe,
                        int parts) {
  extern __shared__ __align__(16) float slut[];
  repro_torch::pq::score_part(member_codes, probe, lut, slut, sink, n_c, cap,
                              m_sub, ksub, n_probe, parts);
}

}  // namespace

// Shapes: member_codes (n_c, cap, m_sub) u8, probe (b, n_probe) i32,
// lut (b, m_sub, ksub) f32 -> scores (b, n_probe, cap) f32.
// Returns the CUDA error code of the launch (0 = success).
extern "C" int pq_lut_score_launch(const uint8_t* member_codes,
                                   const int* probe, const float* lut,
                                   float* scores, int n_c, int cap, int m_sub,
                                   int ksub, int b, int n_probe,
                                   void* stream) {
  if (b == 0 || n_probe == 0 || cap == 0) return 0;
  const size_t smem = sizeof(float) * static_cast<size_t>(m_sub) * ksub;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pq_lut_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int parts = 0;
  const int e = repro_torch::pq::score_parts(b, n_probe, cap, &parts);
  if (e) return e;
  pq_lut_score_kernel<<<dim3(b, n_probe * parts), repro_torch::pq::kRows,
                        smem, static_cast<cudaStream_t>(stream)>>>(
      member_codes, probe, lut, ScoreSink{scores, cap}, n_c, cap, m_sub, ksub,
      n_probe, parts);
  return static_cast<int>(cudaGetLastError());
}
