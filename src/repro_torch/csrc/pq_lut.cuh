// The IVF-PQ LUT sum and score loop shared by pq_lut_score.cu and
// decode_fused.cu's pq_screen_select.
//
// pq_screen_select must score a coded member bit for bit as pq_lut_score
// does: that is what makes IVFPQIndex.screen_select equal
// IVFPQIndex.topk_batch on the card. Both call this one function, so the
// order of operations is fixed here: the m_sub table entries are added one
// at a time in subspace order m = 0 .. m_sub-1, starting from 0.f — the
// order of the Pallas kernel's one-hot accumulation
// (repro/kernels/pq_lut_score.py::lut_tile_scores) and of the plain version
// (repro_torch/core/quant/pq.py::lut_scores), which therefore agree with it
// bit for bit too.
//
// Both kernels also share their grid and loop (score_part): blocks over
// (query, part of a probed stage), so a few queries' 8 stages still fill
// the card, each block with its query's LUT in shared memory and one member
// a thread; they differ only in what they write (a sink).
#pragma once

#include <cuda_runtime.h>

#include <stdint.h>

#include "pdl.cuh"
#include "row_dot.cuh"

namespace repro_torch {

// Σ_m lut[m * ksub + codes[m]] for one coded row. lut is the query's
// (m_sub, ksub) table, usually in shared memory; every code is < ksub.
// Requires codes 8-byte aligned when m_sub == 8: the row's codes then come
// in as one 8-byte load.
__device__ __forceinline__ float lut_sum(const uint8_t* __restrict__ codes,
                                         const float* __restrict__ lut,
                                         int m_sub, int ksub) {
  float acc = 0.f;
  if (m_sub == 8) {
    const uint2 c = __ldg(reinterpret_cast<const uint2*>(codes));
#pragma unroll
    for (int m = 0; m < 4; ++m) acc += lut[m * ksub + ((c.x >> (8 * m)) & 0xffu)];
#pragma unroll
    for (int m = 0; m < 4; ++m)
      acc += lut[(m + 4) * ksub + ((c.y >> (8 * m)) & 0xffu)];
  } else {
    for (int m = 0; m < m_sub; ++m) acc += lut[m * ksub + __ldg(codes + m)];
  }
  return acc;
}

namespace pq {

// Members a score block takes, one a thread, and the blocks an SM the grid
// aims at before it splits stages no further.
constexpr int kRows = 256;
constexpr int kBlocksPerSM = 4;

// The parts each of the b * n_probe (query, stage) pairs' cap members are
// split into, a block each: as many as fill kBlocksPerSM blocks an SM, at
// most one per kRows members (4 queries of 8 stages of 544: 3). Returns the
// CUDA error code (0 = success).
inline int score_parts(int b, int n_probe, int cap, int* parts) {
  int sms = 0;
  const int e = sm_count(&sms);
  if (e) return e;
  const int most = (cap + kRows - 1) / kRows;
  const int fill = (kBlocksPerSM * sms + b * n_probe - 1) / (b * n_probe);
  *parts = most < fill ? most : fill;
  return 0;
}

// A score kernel's body: grid (b, n_probe * parts), kRows threads, slut
// m_sub * ksub floats of shared memory. Block (q, j * parts + part) scores
// members part * kRows + thread, stepping by parts * kRows, of query q's
// stage j's cluster (out-of-range ids clamp, as an XLA gather does). A stage
// the sink calls dead (sink.stage_live(q, j) false) is not read at all;
// sink.store(pair, slot, row, sum) gets each member's pair q * n_probe + j,
// its slot in the code table, its row in the cluster and a functor that
// returns its lut_sum, which the sink calls only for members it scores.
template <typename Sink>
__device__ __forceinline__ void score_part(
    const uint8_t* __restrict__ member_codes, const int* __restrict__ probe,
    const float* __restrict__ lut, float* slut, const Sink& sink, int n_c,
    int cap, int m_sub, int ksub, int n_probe, int parts) {
  const int q = blockIdx.x;
  const int j = blockIdx.y / parts;
  if (!sink.stage_live(q, j)) return;
  const int lut_n = m_sub * ksub;
  load_query(slut, lut + static_cast<size_t>(q) * lut_n, lut_n);
  __syncthreads();
  const int pair = q * n_probe + j;
  const int cl = min(max(probe[pair], 0), n_c - 1);
  for (int row = (blockIdx.y - j * parts) * kRows + threadIdx.x; row < cap;
       row += parts * kRows) {
    const size_t slot = static_cast<size_t>(cl) * cap + row;
    sink.store(pair, slot, row, [&] {
      return lut_sum(member_codes + slot * m_sub, slut, m_sub, ksub);
    });
  }
}

}  // namespace pq
}  // namespace repro_torch
