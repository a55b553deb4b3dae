// fused_estimator: the stratified estimator of Algorithms 3 + 4 in one pass
// per token, and its backward.
//
// Replaces the Pallas TPU kernel
// repro/kernels/fused_estimator.py::fused_estimator (grid (t, m): the
// scalar-prefetched candidate ids pick one embedding row per grid step, and a
// running max / sum / d-wide weighted row sum in scratch carries over the m
// axis — the online softmax of flash attention) and the backward of its custom
// VJP (repro/core/estimators.py::_fused_logz_bwd, which gathers the (t, m, d)
// candidate rows in HBM again and scatter-adds p·h into d_emb).
//
//   forward:  log_z[t] = log Σ_j exp(y_tj),  expv[t] = Σ_j softmax_j · E[ids_tj]
//             with y_tj = E[ids_tj] · h_t + log_w_tj
//   backward: p_tj = exp(y_tj - log_z[t]) · g[t]
//             d_emb[r] = Σ_{(t,j): ids_tj = r} p_tj · h_t
//
// What bounds them on an H100: bytes. The forward reads t·m candidate rows
// of d values and does 4·d flops per row (dot + weighted sum): one flop per
// byte for fp32 rows. The backward reads each distinct row once and h_t once
// per candidate, and writes the dense (n, d) fp32 d_emb.
//
// Forward design: one block per token, 8 warps striding over the token's m
// candidates. A warp loads a whole row into registers (lane l holds the
// float4 groups l, l+32, ... — fp32 rows as 16-byte loads, bf16 rows as
// 8-byte loads upcast exactly), scores it against h in shared memory with
// explicit fmaf and a fixed xor butterfly (the order of row_dot.cuh's
// warp_row_dot), and folds it into its own running (max, sum, d-wide sum)
// kept in registers. Slots of weight -inf are skipped unread: they add
// exactly nothing. The running max starts at -1e30, as the Pallas kernel's
// does, so an all-dead token gives log_z = -inf and expv = NaN, as there.
// The warps merge in shared memory in warp order, so a result depends on the
// inputs alone. The (t, m, d) gather never exists in device memory.
//
// Backward design: deterministic, no float atomics. The wrapper sorts the
// flat candidate ids once (stable) and finds each table row's segment with a
// binary search. One block per table row: it loads its row once into shared
// memory, its warps recompute y for the segment's candidates (with
// warp_row_dot, bitwise the forward's y for fp32 rows) and write p, then each
// thread folds p·h_t into its elements of the row's gradient in segment
// order. Every row of d_emb, touched or not, is written by exactly one block;
// rows no candidate touches are written as zeros.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "row_dot.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 256;  // backward: segment entries scored per pass
constexpr float kNeg = -1e30f;  // the Pallas kernel's running-max sentinel

// Float4 group g of a row, upcast to fp32 (bf16 -> fp32 is exact).
__device__ __forceinline__ float4 load_group(const float* row, int g) {
  return __ldg(reinterpret_cast<const float4*>(row) + g);
}

__device__ __forceinline__ float4 load_group(const __nv_bfloat16* row, int g) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(row) + g);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// C: float4 groups per lane, C * 128 >= d.
template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
    fused_estimator_fwd_kernel(const T* __restrict__ emb,
                               const int* __restrict__ ids,
                               const float* __restrict__ h,
                               const float* __restrict__ log_w,
                               float* __restrict__ log_z,
                               float* __restrict__ expv, int n, int d, int m) {
  extern __shared__ __align__(16) float smem[];
  float* sh = smem;      // (d,) the token's query
  float* sv = smem + d;  // (d,) the merged weighted row sum
  __shared__ float wmax[kWarps], wsum[kWarps];
  const int t = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int d4 = d >> 2;

  repro_torch::load_query(sh, h + static_cast<size_t>(t) * d, d);
  __syncthreads();
  const float4* h4 = reinterpret_cast<const float4*>(sh);

  float run_m = kNeg, run_s = 0.f;
  float4 v[C];
#pragma unroll
  for (int c = 0; c < C; ++c) v[c] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int* tids = ids + static_cast<size_t>(t) * m;
  const float* tlw = log_w + static_cast<size_t>(t) * m;
  for (int j = warp; j < m; j += kWarps) {
    const float lw = tlw[j];
    if (lw == -INFINITY) continue;  // p = 0: the row adds exactly nothing
    const int r = min(max(tids[j], 0), n - 1);  // clamp, as a gather does
    const T* row = emb + static_cast<size_t>(r) * d;
    float4 x[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int g = c * 32 + lane;
      x[c] = g < d4 ? load_group(row, g) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int g = c * 32 + lane;
      if (g < d4) {
        const float4 q = h4[g];
        acc = fmaf(x[c].x, q.x, acc);
        acc = fmaf(x[c].y, q.y, acc);
        acc = fmaf(x[c].z, q.z, acc);
        acc = fmaf(x[c].w, q.w, acc);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    const float y = acc + lw;
    const float m_new = fmaxf(run_m, y);
    const float corr = expf(run_m - m_new);
    const float p = expf(y - m_new);
    run_m = m_new;
    run_s = run_s * corr + p;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      v[c].x = v[c].x * corr + p * x[c].x;
      v[c].y = v[c].y * corr + p * x[c].y;
      v[c].z = v[c].z * corr + p * x[c].z;
      v[c].w = v[c].w * corr + p * x[c].w;
    }
  }

  // merge the warps' partials in warp order
  if (lane == 0) {
    wmax[warp] = run_m;
    wsum[warp] = run_s;
  }
  __syncthreads();
  float mx = kNeg;
  for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wmax[w]);
  float s = 0.f;
  for (int w = 0; w < kWarps; ++w) s += wsum[w] * expf(wmax[w] - mx);
  const float scale = expf(run_m - mx);
  float4* sv4 = reinterpret_cast<float4*>(sv);
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int g = c * 32 + lane;
        if (g < d4) {
          float4 cur = w == 0 ? make_float4(0.f, 0.f, 0.f, 0.f) : sv4[g];
          cur.x += v[c].x * scale;
          cur.y += v[c].y * scale;
          cur.z += v[c].z * scale;
          cur.w += v[c].w * scale;
          sv4[g] = cur;
        }
      }
    }
    __syncthreads();
  }
  float* out = expv + static_cast<size_t>(t) * d;
  for (int i = threadIdx.x; i < d; i += kThreads) out[i] = sv[i] / s;
  if (threadIdx.x == 0) log_z[t] = mx + logf(s);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_estimator_bwd_kernel(const T* __restrict__ emb,
                               const int* __restrict__ order,
                               const int* __restrict__ offsets,
                               const float* __restrict__ h,
                               const float* __restrict__ log_w,
                               const float* __restrict__ log_z,
                               const float* __restrict__ g,
                               float* __restrict__ d_emb,
                               float* __restrict__ p_out, int d, int m) {
  extern __shared__ __align__(16) float smem[];
  float* srow = smem;          // (d,) this block's table row, fp32
  float* sacc = smem + d;      // (d,) its gradient
  float* sp = sacc + d;        // (kTile,) p of the current tile
  int* stok = reinterpret_cast<int*>(sp + kTile);  // (kTile,) their tokens
  const int r = blockIdx.x;
  const int beg = offsets[r];
  const int end = offsets[r + 1];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* out = d_emb + static_cast<size_t>(r) * d;
  if (beg == end) {
    for (int i = threadIdx.x; i < d; i += kThreads) out[i] = 0.f;
    return;
  }
  const T* row = emb + static_cast<size_t>(r) * d;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    srow[i] = to_float(row[i]);
    sacc[i] = 0.f;
  }
  __syncthreads();
  for (int t0 = beg; t0 < end; t0 += kTile) {
    const int len = min(kTile, end - t0);
    for (int jj = warp; jj < len; jj += kWarps) {
      const int q = order[t0 + jj];
      const int tt = q / m;
      const float lw = log_w[q];
      float y = -INFINITY;  // a dead slot's score, whatever the row holds
      if (lw != -INFINITY)
        y = repro_torch::warp_row_dot(h + static_cast<size_t>(tt) * d, srow,
                                      d, lane) + lw;
      const float p = expf(y - log_z[tt]) * g[tt];
      if (lane == 0) {
        sp[jj] = p;
        stok[jj] = tt;
        p_out[q] = p;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < d; i += kThreads) {
      float a = sacc[i];
      for (int jj = 0; jj < len; ++jj)
        a = fmaf(sp[jj], __ldg(h + static_cast<size_t>(stok[jj]) * d + i), a);
      sacc[i] = a;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < d; i += kThreads) out[i] = sacc[i];
}

template <typename T, int C>
int launch_fwd(const void* emb, const int* ids, const float* h,
               const float* log_w, float* log_z, float* expv, int n, int d,
               int t, int m, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 2 * static_cast<size_t>(d);
  auto kern = fused_estimator_fwd_kernel<T, C>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<t, kThreads, smem, stream>>>(static_cast<const T*>(emb), ids, h,
                                      log_w, log_z, expv, n, d, m);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_fwd(const void* emb, const int* ids, const float* h,
                 const float* log_w, float* log_z, float* expv, int n, int d,
                 int t, int m, cudaStream_t s) {
  const int groups = (d / 4 + 31) / 32;
  if (groups <= 1) return launch_fwd<T, 1>(emb, ids, h, log_w, log_z, expv, n, d, t, m, s);
  if (groups <= 2) return launch_fwd<T, 2>(emb, ids, h, log_w, log_z, expv, n, d, t, m, s);
  if (groups <= 4) return launch_fwd<T, 4>(emb, ids, h, log_w, log_z, expv, n, d, t, m, s);
  if (groups <= 8) return launch_fwd<T, 8>(emb, ids, h, log_w, log_z, expv, n, d, t, m, s);
  if (groups <= 16) return launch_fwd<T, 16>(emb, ids, h, log_w, log_z, expv, n, d, t, m, s);
  if (groups <= 32) return launch_fwd<T, 32>(emb, ids, h, log_w, log_z, expv, n, d, t, m, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_bwd(const void* emb, const int* order, const int* offsets,
               const float* h, const float* log_w, const float* log_z,
               const float* g, float* d_emb, float* p, int n, int d, int m,
               cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (2 * static_cast<size_t>(d) + kTile) + sizeof(int) * kTile;
  auto kern = fused_estimator_bwd_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<n, kThreads, smem, stream>>>(static_cast<const T*>(emb), order,
                                      offsets, h, log_w, log_z, g, d_emb, p,
                                      d, m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shapes: emb (n, d) fp32 (bf16 = 0) or bf16 (bf16 = 1), ids (t, m) i32,
// h (t, d) f32, log_w (t, m) f32 -> log_z (t,) f32, expv (t, d) f32.
// Requires d % 4 == 0, d <= 4096, rows 16-byte (fp32) / 8-byte (bf16)
// aligned. Returns the CUDA error code of the launch (0 = success).
extern "C" int fused_estimator_launch(const void* emb, const int* ids,
                                      const float* h, const float* log_w,
                                      float* log_z, float* expv, int n, int d,
                                      int t, int m, int bf16, void* stream) {
  if (t == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch_fwd<__nv_bfloat16>(emb, ids, h, log_w, log_z, expv,
                                            n, d, t, m, s)
              : dispatch_fwd<float>(emb, ids, h, log_w, log_z, expv, n, d, t,
                                    m, s);
}

// Shapes: emb (n, d) as above; order (t*m,) i32 flat candidate positions
// sorted stably by their (clamped) id; offsets (n+1,) i32, row r's segment
// is order[offsets[r] .. offsets[r+1]); h (t, d) f32; log_w (t, m) f32;
// log_z (t,) f32; g (t,) f32 -> d_emb (n, d) f32 (every row written),
// p (t, m) f32. Same requirements as the forward.
extern "C" int fused_estimator_bwd_launch(
    const void* emb, const int* order, const int* offsets, const float* h,
    const float* log_w, const float* log_z, const float* g, float* d_emb,
    float* p, int n, int d, int m, int bf16, void* stream) {
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_bwd<__nv_bfloat16>(emb, order, offsets, h, log_w,
                                          log_z, g, d_emb, p, n, d, m, s)
              : launch_bwd<float>(emb, order, offsets, h, log_w, log_z, g,
                                  d_emb, p, n, d, m, s);
}
