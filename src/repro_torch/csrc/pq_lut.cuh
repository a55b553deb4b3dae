// The IVF-PQ LUT sum shared by pq_lut_score.cu and decode_fused.cu's
// pq_screen_select.
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
#pragma once

#include <cuda_runtime.h>

#include <stdint.h>

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

}  // namespace repro_torch
