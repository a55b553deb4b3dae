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
// Design: grid (n_probe, b), 256 threads. A block loads its query's
// (m_sub, ksub) LUT into shared memory once; a GPU gathers by index
// natively, so there is no one-hot product: each thread scores whole
// members with repro_torch::lut_sum (pq_lut.cuh), which reads a member's 8
// codes in one 8-byte load at m_sub = 8 and adds the looked-up entries in
// subspace order. decode_fused.cu's pq_screen_select scores members with
// the same device function, which keeps the fused screen bitwise equal to
// this kernel's scores plus the coarse term.
#include <cuda_runtime.h>

#include <stdint.h>

#include "pq_lut.cuh"
#include "row_dot.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    pq_lut_score_kernel(const uint8_t* __restrict__ member_codes,
                        const int* __restrict__ probe,
                        const float* __restrict__ lut,
                        float* __restrict__ scores, int n_c, int cap,
                        int m_sub, int ksub, int n_probe) {
  extern __shared__ __align__(16) float slut[];
  const int j = blockIdx.x;
  const int bi = blockIdx.y;
  // out-of-range cluster ids clamp, as an XLA gather does
  const int cl = min(max(probe[bi * n_probe + j], 0), n_c - 1);
  const int lut_n = m_sub * ksub;

  repro_torch::load_query(slut, lut + static_cast<size_t>(bi) * lut_n, lut_n);
  __syncthreads();

  const uint8_t* tile = member_codes + static_cast<size_t>(cl) * cap * m_sub;
  float* out = scores + (static_cast<size_t>(bi) * n_probe + j) * cap;
  for (int r = threadIdx.x; r < cap; r += kThreads)
    out[r] = repro_torch::lut_sum(tile + static_cast<size_t>(r) * m_sub, slut,
                                  m_sub, ksub);
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
  const dim3 grid(n_probe, b);
  pq_lut_score_kernel<<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      member_codes, probe, lut, scores, n_c, cap, m_sub, ksub, n_probe);
  return static_cast<int>(cudaGetLastError());
}
