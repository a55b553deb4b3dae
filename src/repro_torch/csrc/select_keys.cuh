// Selection in decode_fused.cu: top-k over 64-bit keys (the screens' radix
// select orders its winners here, the exact re-rank all its keys), and the
// (value, index) argmax of the Algorithm-2 finish.
//
// A key's high word orders the fp32 score descending and its low word is
// the slot's pool index, so an ascending sort of the keys puts the larger
// value first and, among equal values, the lower pool index first: the
// order of jax.lax.top_k and of the Pallas kernels' iterative
// first-occurrence argmax. The order is total and fixed, so a selection
// depends on the scores alone, never on which thread wrote which key.
#pragma once

#include <cuda_runtime.h>

#include <math.h>
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

// One merge step (``size``) of a bitonic sorting network on the 64 keys a
// warp holds in registers: lane l holds keys l (a) and l + 32 (b). Stride
// 32 pairs a lane's two keys; strides 16 .. 1 pair lanes l and l ^ stride.
// A key is kept as min or max by its pair's direction (ascending where the
// key's position has bit ``size`` clear). All 32 lanes call it together.
__device__ __forceinline__ void merge_step64(unsigned long long& a,
                                             unsigned long long& b, int lane,
                                             int size) {
  int stride = min(size >> 1, 32);
  if (stride == 32) {
    if ((a > b) == ((lane & size) == 0)) {
      const unsigned long long t = a;
      a = b;
      b = t;
    }
    stride = 16;
  }
  for (; stride > 0; stride >>= 1) {
    const bool lower = (lane & stride) == 0;
    const unsigned long long oa = __shfl_xor_sync(0xffffffffu, a, stride);
    const unsigned long long ob = __shfl_xor_sync(0xffffffffu, b, stride);
    const bool min_a = lower == ((lane & size) == 0);
    const bool min_b = lower == (((lane + 32) & size) == 0);
    a = (a < oa) == min_a ? a : oa;
    b = (b < ob) == min_b ? b : ob;
  }
}

// Sorts the 64 keys a warp holds (lane l: keys l and l + 32) ascending, in
// registers, with no block barrier.
__device__ __forceinline__ void warp_sort64(unsigned long long& a,
                                            unsigned long long& b,
                                            int lane) {
#pragma unroll
  for (int size = 2; size <= 64; size <<= 1) merge_step64(a, b, lane, size);
}

// How many of the 64 ascending keys of run lie below x (a binary search).
__device__ __forceinline__ int count_below64(const unsigned long long* run,
                                             unsigned long long x) {
  int c = 0;
#pragma unroll
  for (int step = 32; step > 0; step >>= 1)
    if (run[c + step - 1] < x) c += step;
  return c + (run[c] < x);
}

// The first k of n keys in ascending order, by rank. The keys are unique
// (their low word is a slot index), so a key's rank — how many keys lie
// below it — is its place in the sorted order: each warp sorts 64-key runs
// of src in registers, padded past n with -inf keys whose indices lie past
// the n, and a key's rank is its place in its run plus, for every other
// run, how many of that run's keys lie below it. One block barrier, not
// one per stride of a sort. keys: n_runs * 64 slots of shared memory,
// n_runs = ceil(n / 64).
// Calls emit(rank, key) for every key ranked below k. Ends synchronized.
template <typename Emit>
__device__ inline void select_by_rank(unsigned long long* keys,
                                      const unsigned long long* src, int n,
                                      int n_runs, int k, Emit emit) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int base = warp * 64; base < n_runs * 64;
       base += (blockDim.x >> 5) * 64) {
    unsigned long long a =
        base + lane < n ? src[base + lane] : make_key(-INFINITY, base + lane);
    unsigned long long b = base + lane + 32 < n
                               ? src[base + lane + 32]
                               : make_key(-INFINITY, base + lane + 32);
    warp_sort64(a, b, lane);
    keys[base + lane] = a;
    keys[base + lane + 32] = b;
  }
  __syncthreads();
  for (int p = threadIdx.x; p < n_runs * 64; p += blockDim.x) {
    const unsigned long long x = keys[p];
    const int own = p >> 6;
    int rank = p & 63;
    for (int j = 0; j < n_runs; ++j)
      if (j != own) rank += count_below64(keys + 64 * j, x);
    if (rank < k) emit(rank, x);
  }
  __syncthreads();
}

// (value, index) order of a first-occurrence argmax: the larger value, then
// the lower index. A strict total order on pairs of unique indices: +0 ==
// -0 (the lower index wins), and a NaN never wins, so a fold that starts
// from (-inf, INT_MAX) and sees every pair once picks one winner whatever
// its order.
__device__ __forceinline__ void argmax_merge(float& bv, int& bi, float v,
                                             int i) {
  if (v > bv || (v == bv && i < bi)) {
    bv = v;
    bi = i;
  }
}

// The block's (value, index) pairs folded into thread 0's (argmax_merge):
// each warp by a butterfly, then warp 0 over the warps' winners. red_v and
// red_i: one entry a warp in shared memory.
__device__ __forceinline__ void block_argmax(float& bv, int& bi, float* red_v,
                                             int* red_i) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    argmax_merge(bv, bi, __shfl_xor_sync(0xffffffffu, bv, o),
                 __shfl_xor_sync(0xffffffffu, bi, o));
  if (lane == 0) {
    red_v[warp] = bv;
    red_i[warp] = bi;
  }
  __syncthreads();
  if (warp == 0) {
    const bool in = lane < static_cast<int>(blockDim.x >> 5);
    bv = in ? red_v[lane] : -INFINITY;
    bi = in ? red_i[lane] : 0x7fffffff;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      argmax_merge(bv, bi, __shfl_xor_sync(0xffffffffu, bv, o),
                   __shfl_xor_sync(0xffffffffu, bi, o));
  }
}

}  // namespace repro_torch
