// Warp-level fp32 row · query dot product shared by every IVF and tail
// kernel of the port (ivf_gather_score.cu, decode_fused.cu).
//
// ivf_screen_select must score a member row bit for bit as ivf_gather_score
// does: that is what makes IVFIndex.screen_select equal IVFIndex.topk_batch
// with the kernel probe (DESIGN.md §10). Both call this one function, so the
// order of operations is fixed here: lane l takes the float4 chunks
// l, l+32, l+64, ... in order, folds each chunk's four products into its
// running sum with explicit fmaf (no contraction left to the compiler), and
// the warp then sums the 32 partials with a fixed xor butterfly. The result
// depends on the row, q and d only — not on which warp, block or kernel
// computes it, nor on where q lives.
#pragma once

#include <cuda_runtime.h>

namespace repro_torch {

// Requires: all 32 lanes of the warp call it together with the same row and
// q; row and q 16-byte aligned when d % 4 == 0. Every lane gets the sum.
__device__ __forceinline__ float warp_row_dot(const float* __restrict__ row,
                                              const float* __restrict__ q,
                                              int d, int lane) {
  float acc = 0.f;
  if ((d & 3) == 0) {
    const float4* r4 = reinterpret_cast<const float4*>(row);
    const float4* q4 = reinterpret_cast<const float4*>(q);
    const int d4 = d >> 2;
    for (int i = lane; i < d4; i += 32) {
      const float4 a = __ldg(r4 + i);
      const float4 b = q4[i];
      acc = fmaf(a.x, b.x, acc);
      acc = fmaf(a.y, b.y, acc);
      acc = fmaf(a.z, b.z, acc);
      acc = fmaf(a.w, b.w, acc);
    }
  } else {
    for (int i = lane; i < d; i += 32) acc = fmaf(__ldg(row + i), q[i], acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return acc;
}

// Loads q (d floats) into shared memory with the whole block.
__device__ __forceinline__ void load_query(float* __restrict__ dst,
                                           const float* __restrict__ src,
                                           int d) {
  for (int i = threadIdx.x; i < d; i += blockDim.x) dst[i] = src[i];
}

}  // namespace repro_torch
