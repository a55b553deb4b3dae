// Top-k selection by sorting 64-bit keys in shared memory, shared by the
// fused screens and the exact re-rank (decode_fused.cu).
//
// A key's high word orders the fp32 score descending and its low word is
// the slot's pool index, so an ascending sort of the keys puts the larger
// value first and, among equal values, the lower pool index first: the
// order of jax.lax.top_k and of the Pallas kernels' iterative
// first-occurrence argmax. The order is total and fixed, so a selection
// depends on the scores alone, never on which thread wrote which key.
#pragma once

#include <cuda_runtime.h>

#include <stdint.h>

namespace repro_torch {

// fp32 -> uint32 whose ascending order is the float's descending order.
__device__ __forceinline__ uint32_t desc_bits(float v) {
  const uint32_t u = __float_as_uint(v);
  const uint32_t ordered = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ~ordered;
}

__device__ __forceinline__ float from_desc_bits(uint32_t d) {
  const uint32_t ordered = ~d;
  const uint32_t u =
      (ordered & 0x80000000u) ? (ordered & 0x7fffffffu) : ~ordered;
  return __uint_as_float(u);
}

__device__ __forceinline__ unsigned long long make_key(float v, int idx) {
  return (static_cast<unsigned long long>(desc_bits(v)) << 32) |
         static_cast<uint32_t>(idx);
}

__device__ __forceinline__ int key_index(unsigned long long key) {
  return static_cast<int>(key & 0xffffffffu);
}

__device__ __forceinline__ float key_value(unsigned long long key) {
  return from_desc_bits(static_cast<uint32_t>(key >> 32));
}

// Ascending bitonic sort of n keys (n a power of two) by the whole block.
// The caller synchronizes the block after writing the keys; the sort ends
// synchronized.
__device__ inline void bitonic_sort(unsigned long long* keys, int n) {
  const int half = n >> 1;
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < half; i += blockDim.x) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const bool asc = (lo & size) == 0;
        const unsigned long long a = keys[lo];
        const unsigned long long b = keys[hi];
        if ((a > b) == asc) {
          keys[lo] = b;
          keys[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

}  // namespace repro_torch
