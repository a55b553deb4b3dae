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
// byte for fp32 rows. The backward writes the dense (n, d) fp32 d_emb (262
// MB at n 32,000, d 2,048) and reads p's inputs and h once (~0.08 ms); its
// (row, token) pairs read h_t from shared memory, 8 KB a pair at d 2,048
// (~2.4 GB at a 256-token head chunk, ~0.1 ms on 132 SMs), beside the
// writes. On an H100 it runs at about twice that, bound by latency.
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
// inputs alone. The (t, m, d) gather never exists in device memory. On
// request lane 0 of the scoring warp stores each score y (-inf for a dead
// slot) for the backward.
//
// Backward design: an SpMM, d_emb = Pᵀ·H, deterministic, no float atomics.
// y comes from the forward, not from a re-score: the training path runs the
// backward right after the checkpoint's recompute of the same forward, and
// re-scoring read every candidate row and h_t once more through L2 (~4.8 GB
// a chunk, what bounded the earlier one-block-a-row kernel at 0.74 ms). The
// wrapper sorts the flat candidate ids once (stable) and finds each table
// row's segment with a binary search. Grid (d-slice of 128 columns, group of
// 32 warps): a block stages h[:, slice] in shared memory (128 KB at t 256).
// Each warp of a slice owns a run of whole rows, split by entries + a row's
// write cost (a 16-ary search over the offsets per half-warp, no atomics);
// the runs are dealt to the blocks in turn, so popular rows spread over the
// SMs. A warp walks its rows in order: 128 entries at a time it computes p
// = exp(y - log_z) · g, the positions loaded one batch ahead (each entry's
// p is written by one slice, e % slices), then lane l folds p · h[tok,
// 4l..4l+3] into registers entry by entry in segment order with fmaf, from
// 0 — the order of the one-block-a-row kernel, so d_emb keeps its bits —
// and writes the row's slice once. Rows no candidate touches are written as
// zeros. The kernel is latency-bound: 32 warps an SM, one float4 a lane.
// Where h's slice outgrows shared memory the block walks the tokens in
// tiles: a segment's tokens ascend, each partial row is carried through
// d_emb between tiles (a float store and load are exact), and an entry of
// another tile folds p = 0 against zeros, which leaves the sum as it was.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

#include "row_dot.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr float kNeg = -1e30f;  // the Pallas kernel's running-max sentinel

// backward: 32 warps share one slice of h; lane l owns the slice's columns
// 4l..4l+3; each warp owns a run of whole rows
constexpr int kBwdWarps = 32;
constexpr int kBwdThreads = kBwdWarps * 32;
constexpr int kSliceCols = 128;
constexpr int kRowCost = 4;  // a row's write, in segment entries' work
constexpr int kBatch = 128;  // entries whose p a warp computes at once

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

// C: float4 groups per lane, C * 128 >= d.
template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
    fused_estimator_fwd_kernel(const T* __restrict__ emb,
                               const int* __restrict__ ids,
                               const float* __restrict__ h,
                               const float* __restrict__ log_w,
                               float* __restrict__ log_z,
                               float* __restrict__ expv,
                               float* __restrict__ y_out, int n, int d,
                               int m) {
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
  float* ty = y_out ? y_out + static_cast<size_t>(t) * m : nullptr;
  for (int j = warp; j < m; j += kWarps) {
    const float lw = tlw[j];
    if (lw == -INFINITY) {  // p = 0: the row adds exactly nothing
      if (ty && lane == 0) ty[j] = -INFINITY;
      continue;
    }
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
    if (ty && lane == 0) ty[j] = y;
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

// Row split among a slice's warps: the first row r in [0, n] whose weight
// offsets[r] + kRowCost * r reaches share b of ``parts`` of the total. The
// weight counts a row's entries and its write, so a warp of popular rows
// gets fewer of them. Each half-warp runs a 16-ary search for its own b
// (lanes 0-15 for b, 16-31 for b + 1); every lane of a half gets the
// answer.
__device__ __forceinline__ int row_split(const int* __restrict__ offsets,
                                         int n, int b, int parts, int lane) {
  const long long total = offsets[n] + static_cast<long long>(kRowCost) * n;
  const long long target = total * (b + (lane >> 4)) / parts;
  const int hl = lane & 15;
  int lo = 0, hi = n;  // the answer lies in [lo, hi]; weight(hi) >= target
  while (__any_sync(0xffffffffu, lo < hi)) {
    const int stride = (hi - lo + 15) / 16;
    const int pos = min(lo + hl * stride, hi);
    const bool reach =
        lo < hi && __ldg(offsets + pos) +
                           static_cast<long long>(kRowCost) * pos >= target;
    const unsigned ballot =
        (__ballot_sync(0xffffffffu, reach) >> (lane & 16)) & 0xffffu;
    if (lo < hi) {
      const int f = ballot ? __ffs(ballot) - 1 : 16;
      if (f == 0) {
        hi = lo;
      } else {
        const int new_hi = f < 16 ? min(lo + f * stride, hi) : hi;
        lo = lo + (f - 1) * stride + 1;
        hi = new_hi;
      }
    }
  }
  return lo;
}

// grid (d-slice of kSliceCols columns, group of kBwdWarps warps); each warp
// owns a run of whole rows of the slice. tile_t tokens of h's slice fit in
// shared memory; longer chunks are walked tile by tile.
__global__ void __launch_bounds__(kBwdThreads, 1)
    fused_estimator_bwd_spmm_kernel(const long long* __restrict__ order,
                                    const int* __restrict__ offsets,
                                    const float* __restrict__ h,
                                    const float* __restrict__ y,
                                    const float* __restrict__ log_z,
                                    const float* __restrict__ g,
                                    float* d_emb, float* __restrict__ p_out,
                                    int n, int d, int t, int m, int tile_t) {
  // h[tile, slice] as (tile_t, 32) float4 groups and a row of zeros, then
  // each warp's batch of kBatch entries (p, h offset)
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float4* sh = smem4;
  float2* batch =
      reinterpret_cast<float2*>(smem4 + (tile_t + 1) * 32) + warp * kBatch;
  const int zero_off = tile_t * 32;  // the row of zeros
  const int d4 = d >> 2;
  const int col4 = blockIdx.x * 32 + lane;  // this lane's float4 group
  const bool col_ok = col4 < d4;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  // the slice's runs of rows go to the blocks in turn, so that popular rows
  // (the first ids, in a vocabulary sorted by frequency) spread over the SMs
  const int split = row_split(offsets, n, warp * gridDim.y + blockIdx.y,
                              gridDim.y * kBwdWarps, lane);
  const int ra = __shfl_sync(0xffffffffu, split, 0);
  const int rb = __shfl_sync(0xffffffffu, split, 16);
  const int ea = __ldg(offsets + ra), eb = __ldg(offsets + rb);
  if (threadIdx.x < 32) sh[zero_off + threadIdx.x] = zero;

  int t0 = 0;
  do {  // once at least: t = 0 still writes every row's zeros
    const int t1 = min(t, t0 + tile_t);
    const bool first = t0 == 0;
    __syncthreads();  // the last tile's readers are done with sh
    for (int i = threadIdx.x; i < (t1 - t0) * 32; i += kBwdThreads) {
      const int c = blockIdx.x * 32 + (i & 31);
      sh[i] = c < d4 ? __ldg(reinterpret_cast<const float4*>(
                               h + static_cast<size_t>(t0 + (i >> 5)) * d) + c)
                     : zero;
    }
    __syncthreads();

    // the flat positions of the next batch, loaded one batch ahead
    int qn[kBatch / 32];
#pragma unroll
    for (int k = 0; k < kBatch / 32; ++k) {
      const int el = ea + k * 32 + lane;
      qn[k] = el < eb ? static_cast<int>(__ldg(order + el)) : 0;
    }
    int e = ea, base = ea - kBatch;  // batch holds entries [base, base+kBatch)
    for (int rc = ra; rc < rb; rc += 31) {  // 31 rows: 32 segment bounds
      const int nr = min(31, rb - rc);
      const int seg = lane <= nr ? __ldg(offsets + rc + lane) : 0;
      for (int i = 0; i < nr; ++i) {
        const int stop = __shfl_sync(0xffffffffu, seg, i + 1);
        float4* out =
            reinterpret_cast<float4*>(d_emb + static_cast<size_t>(rc + i) * d) +
            col4;
        if (e == stop) {  // no candidate names this row
          if (first && col_ok) *out = zero;
          continue;
        }
        // the earlier tiles' partial sum, carried through d_emb
        float4 a = first || !col_ok ? zero : __ldcg(out);
        do {
          if (e == base + kBatch) {  // p and h offsets of the next entries
            base = e;
            __syncwarp();  // every lane is done with the last batch
#pragma unroll
            for (int k = 0; k < kBatch / 32; ++k) {
              const int el = base + k * 32 + lane;
              float2 v = make_float2(0.f, __int_as_float(zero_off));
              if (el < eb) {
                // an entry of a token outside this tile folds p = 0 against
                // the row of zeros: the sum stays exactly as it was (it is
                // never -0)
                const int q = qn[k];
                const int tok = q / m;
                if (tok >= t0 && tok < t1) {
                  const float p = expf(__ldg(y + q) - __ldg(log_z + tok)) *
                                  __ldg(g + tok);
                  if (blockIdx.x == el % gridDim.x) p_out[q] = p;
                  v = make_float2(p, __int_as_float((tok - t0) * 32));
                }
              }
              batch[k * 32 + lane] = v;
              const int en = el + kBatch;
              qn[k] = en < eb ? static_cast<int>(__ldg(order + en)) : 0;
            }
            __syncwarp();
          }
          const int lim = min(stop, base + kBatch);
#pragma unroll 4
          for (; e < lim; ++e) {  // segment order, fmaf from 0: bitwise
            const float2 pe = batch[e - base];
            const float4 hv = sh[__float_as_int(pe.y) + lane];
            a.x = fmaf(pe.x, hv.x, a.x);
            a.y = fmaf(pe.x, hv.y, a.y);
            a.z = fmaf(pe.x, hv.z, a.z);
            a.w = fmaf(pe.x, hv.w, a.w);
          }
        } while (e < stop);
        if (col_ok) *out = a;
      }
    }
    t0 += tile_t;
  } while (t0 < t);
}

template <typename T, int C>
int launch_fwd(const void* emb, const int* ids, const float* h,
               const float* log_w, float* log_z, float* expv, float* y,
               int n, int d, int t, int m, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 2 * static_cast<size_t>(d);
  auto kern = fused_estimator_fwd_kernel<T, C>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<t, kThreads, smem, stream>>>(static_cast<const T*>(emb), ids, h,
                                      log_w, log_z, expv, y, n, d, m);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_fwd(const void* emb, const int* ids, const float* h,
                 const float* log_w, float* log_z, float* expv, float* y,
                 int n, int d, int t, int m, cudaStream_t s) {
  const int groups = (d / 4 + 31) / 32;
  if (groups <= 1) return launch_fwd<T, 1>(emb, ids, h, log_w, log_z, expv, y, n, d, t, m, s);
  if (groups <= 2) return launch_fwd<T, 2>(emb, ids, h, log_w, log_z, expv, y, n, d, t, m, s);
  if (groups <= 4) return launch_fwd<T, 4>(emb, ids, h, log_w, log_z, expv, y, n, d, t, m, s);
  if (groups <= 8) return launch_fwd<T, 8>(emb, ids, h, log_w, log_z, expv, y, n, d, t, m, s);
  if (groups <= 16) return launch_fwd<T, 16>(emb, ids, h, log_w, log_z, expv, y, n, d, t, m, s);
  if (groups <= 32) return launch_fwd<T, 32>(emb, ids, h, log_w, log_z, expv, y, n, d, t, m, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

int launch_bwd(const long long* order, const int* offsets, const float* h,
               const float* y, const float* log_z, const float* g,
               float* d_emb, float* p, int n, int d, int t, int m,
               cudaStream_t stream) {
  int dev = 0, sms = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t batch_bytes = sizeof(float2) * kBatch * kBwdWarps;
  const size_t row_bytes = sizeof(float) * kSliceCols;  // one token's slice
  // the tile's tokens, a row of zeros, the warps' batches, static smem
  const int fit =
      static_cast<int>((optin - batch_bytes - 1024) / row_bytes) - 1;
  const int tile_t = std::max(1, std::min(t, fit));
  const size_t smem = row_bytes * (tile_t + 1) + batch_bytes;
  auto kern = fused_estimator_bwd_spmm_kernel;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  int per_sm = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      kBwdThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  // one wave: the slices times the warp groups fill the card once
  const int slices = (d + kSliceCols - 1) / kSliceCols;
  const int groups =
      std::max(1, std::min(n, sms * std::max(per_sm, 1) / slices));
  kern<<<dim3(slices, groups), kBwdThreads, smem, stream>>>(
      order, offsets, h, y, log_z, g, d_emb, p, n, d, t, m, tile_t);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shapes: emb (n, d) fp32 (bf16 = 0) or bf16 (bf16 = 1), ids (t, m) i32,
// h (t, d) f32, log_w (t, m) f32 -> log_z (t,) f32, expv (t, d) f32, and
// unless y is NULL the scores y (t, m) f32, -inf on dead slots.
// Requires d % 4 == 0, d <= 4096, rows 16-byte (fp32) / 8-byte (bf16)
// aligned. Returns the CUDA error code of the launch (0 = success).
extern "C" int fused_estimator_launch(const void* emb, const int* ids,
                                      const float* h, const float* log_w,
                                      float* log_z, float* expv, float* y,
                                      int n, int d, int t, int m, int bf16,
                                      void* stream) {
  if (t == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch_fwd<__nv_bfloat16>(emb, ids, h, log_w, log_z, expv,
                                            y, n, d, t, m, s)
              : dispatch_fwd<float>(emb, ids, h, log_w, log_z, expv, y, n, d,
                                    t, m, s);
}

// Shapes: order (t*m,) i64 flat candidate positions sorted stably by their
// (clamped) id; offsets (n+1,) i32, row r's segment is
// order[offsets[r] .. offsets[r+1]); h (t, d) f32;
// y (t, m) f32 the forward's scores (-inf on dead slots); log_z (t,) f32;
// g (t,) f32 -> d_emb (n, d) f32 (every row written), p (t, m) f32.
// Requires d % 4 == 0 and h 16-byte aligned.
extern "C" int fused_estimator_bwd_launch(
    const long long* order, const int* offsets, const float* h,
    const float* y, const float* log_z, const float* g, float* d_emb,
    float* p, int n, int d, int t, int m, void* stream) {
  if (n == 0) return 0;
  return launch_bwd(order, offsets, h, y, log_z, g, d_emb, p, n, d, t, m,
                    static_cast<cudaStream_t>(stream));
}
