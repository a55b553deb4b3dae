// Warp-level fp32 row · query dot product shared by every IVF and tail
// kernel of the port (ivf_gather_score.cu, decode_fused.cu).
//
// ivf_screen_select must score a member row bit for bit as ivf_gather_score
// does: that is what makes IVFIndex.screen_select equal IVFIndex.topk_batch
// with the kernel probe (DESIGN.md §10). The order of operations is fixed
// here, in three pieces that every such kernel is built from:
//
//   * lane l takes the float4 chunks l, l+32, l+64, ... of the row in
//     increasing order (scalars l, l+32, ... when d % 4 != 0) and folds each
//     into its running sum, starting from 0, with fma4 / fmaf: the four
//     products x, y, z, w in that order, explicit fmaf, no contraction left
//     to the compiler;
//   * warp_butterfly then sums the 32 lane partials with a fixed xor
//     butterfly (offsets 16, 8, 4, 2, 1), after which every lane holds the
//     same sum.
//
// warp_row_dot is the two pieces in one call, for one row and one query.
// ivf_gather_score scores one row against many queries at once (register
// blocking): it keeps one running sum per (row, query), folds the same
// chunks in the same order with fma4, and carries each sum across its loop
// over d, so every score is bitwise warp_row_dot's. The result depends on
// the row, q and d only — not on which warp, block or kernel computes it,
// nor on where q lives.
#pragma once

#include <cuda_runtime.h>

namespace repro_torch {

// One float4 chunk folded into a lane's running sum: x, y, z, w in order.
__device__ __forceinline__ float fma4(float acc, float4 a, float4 b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  acc = fmaf(a.w, b.w, acc);
  return acc;
}

// The warp's 32 lane partials summed in the fixed xor order; every lane
// gets the sum. All 32 lanes must call it together.
__device__ __forceinline__ float warp_butterfly(float acc) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return acc;
}

// Lane ``lane``'s partial of row · q: its chunks in increasing order.
// Requires row and q 16-byte aligned when d % 4 == 0.
__device__ __forceinline__ float lane_row_partial(
    const float* __restrict__ row, const float* __restrict__ q, int d,
    int lane) {
  float acc = 0.f;
  if ((d & 3) == 0) {
    const float4* r4 = reinterpret_cast<const float4*>(row);
    const float4* q4 = reinterpret_cast<const float4*>(q);
    const int d4 = d >> 2;
    for (int i = lane; i < d4; i += 32) acc = fma4(acc, __ldg(r4 + i), q4[i]);
  } else {
    for (int i = lane; i < d; i += 32) acc = fmaf(__ldg(row + i), q[i], acc);
  }
  return acc;
}

// Requires: all 32 lanes of the warp call it together with the same row and
// q; row and q 16-byte aligned when d % 4 == 0. Every lane gets the sum.
__device__ __forceinline__ float warp_row_dot(const float* __restrict__ row,
                                              const float* __restrict__ q,
                                              int d, int lane) {
  return warp_butterfly(lane_row_partial(row, q, d, lane));
}

// Loads q (d floats) into shared memory with the whole block.
__device__ __forceinline__ void load_query(float* __restrict__ dst,
                                           const float* __restrict__ src,
                                           int d) {
  for (int i = threadIdx.x; i < d; i += blockDim.x) dst[i] = src[i];
}

}  // namespace repro_torch
