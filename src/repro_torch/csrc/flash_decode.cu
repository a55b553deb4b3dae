// flash_decode: one-token GQA decode attention against a dense KV ring.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_decode.py::flash_decode
// (grid (B, Hq, S/s_blk), online softmax over s_blk tiles, positions at or
// past lengths[b] masked with -1e30, fp32 output).
//
// What bounds it on an H100: bytes. Each decoded token reads the K and V
// rows of its sequence once, 2 * len * Hkv * hd * sizeof(T) bytes, and does
// 4 * len * Hq * hd flops on them: Hq / Hkv flops per bf16 byte (8 for
// tinyllama), far below the card's ~295 flops/byte ridge.
//
// Design: one block per (sequence, KV head). The block serves all
// G = Hq / Hkv query heads of that KV head, so every K/V row is read from
// device memory once, not G times: the block stages 64-row K/V tiles in
// shared memory (as fp32, K rows padded to hd+1 floats so a warp reading 32
// different rows hits 32 banks), and warp g runs the online softmax of
// query head g over the tile (running max, running sum, accumulator; each
// lane owns hd/32 output dims). Rows at or past lengths[b] are never read:
// their -1e30 scores contribute exp(-1e30 - m) = 0 exactly. A sequence with
// lengths[b] == 0 attends uniformly over all S rows, as the -1e30 mask of
// the reference does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kTile = 64;        // cache rows per shared-memory tile
constexpr int kMaxDimsPerLane = 8;  // hd <= 256

template <typename T>
__device__ __forceinline__ float to_float(T x);
template <>
__device__ __forceinline__ float to_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void flash_decode_kernel(const T* __restrict__ q,
                                    const T* __restrict__ k,
                                    const T* __restrict__ v,
                                    const int* __restrict__ lengths,
                                    float* __restrict__ out, int S, int Hq,
                                    int Hkv, int hd, float scale) {
  extern __shared__ float smem[];
  const int G = Hq / Hkv;
  const int b = blockIdx.x / Hkv;
  const int kvh = blockIdx.x % Hkv;
  const int ldk = hd + 1;
  float* sQ = smem;                  // G * hd
  float* sK = sQ + G * hd;           // kTile * (hd + 1)
  float* sV = sK + kTile * ldk;      // kTile * hd
  float* sP = sV + kTile * hd;       // G * kTile
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  const int len = min(lengths[b], S);
  const int rows_end = len > 0 ? len : S;
  const size_t row_stride = static_cast<size_t>(Hkv) * hd;
  const size_t base = (static_cast<size_t>(b) * S * Hkv + kvh) * hd;
  const T* kb = k + base;
  const T* vb = v + base;

  const T* qb = q + (static_cast<size_t>(b) * Hq + kvh * G) * hd;
  for (int i = tid; i < G * hd; i += nthr) sQ[i] = to_float(qb[i]);

  float m_run = -1e30f;
  float l_run = 0.f;
  float acc[kMaxDimsPerLane];
#pragma unroll
  for (int j = 0; j < kMaxDimsPerLane; ++j) acc[j] = 0.f;

  for (int t0 = 0; t0 < rows_end; t0 += kTile) {
    const int nrows = min(kTile, rows_end - t0);
    __syncthreads();  // previous tile fully consumed (and sQ loaded)
    for (int i = tid; i < nrows * hd; i += nthr) {
      const int r = i / hd;
      const int c = i - r * hd;
      const size_t off = static_cast<size_t>(t0 + r) * row_stride + c;
      sK[r * ldk + c] = to_float(kb[off]);
      sV[r * hd + c] = to_float(vb[off]);
    }
    __syncthreads();
    if (warp < G) {
      const float* qg = sQ + warp * hd;
      float s_loc[2];
      float tmax = -INFINITY;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = lane + 32 * i;
        float s = -INFINITY;
        if (r < nrows) {
          const float* kr = sK + r * ldk;
          float dot = 0.f;
          for (int c = 0; c < hd; ++c) dot = fmaf(qg[c], kr[c], dot);
          s = (t0 + r < len) ? dot * scale : -1e30f;
        }
        s_loc[i] = s;
        tmax = fmaxf(tmax, s);
      }
      tmax = warp_max(tmax);
      const float m_new = fmaxf(m_run, tmax);
      const float corr = expf(m_run - m_new);
      float psum = 0.f;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = lane + 32 * i;
        const float p = (r < nrows) ? expf(s_loc[i] - m_new) : 0.f;
        sP[warp * kTile + r] = p;
        psum += p;
      }
      psum = warp_sum(psum);
      l_run = l_run * corr + psum;
      m_run = m_new;
      __syncwarp();
      const float* pg = sP + warp * kTile;
#pragma unroll
      for (int j = 0; j < kMaxDimsPerLane; ++j) {
        const int c = lane + 32 * j;
        if (c < hd) {
          float a = acc[j] * corr;
          for (int r = 0; r < nrows; ++r) a = fmaf(pg[r], sV[r * hd + c], a);
          acc[j] = a;
        }
      }
    }
  }
  if (warp < G) {
    float* ob = out + (static_cast<size_t>(b) * Hq + kvh * G + warp) * hd;
#pragma unroll
    for (int j = 0; j < kMaxDimsPerLane; ++j) {
      const int c = lane + 32 * j;
      if (c < hd) ob[c] = acc[j] / l_run;
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           float* out, int B, int S, int Hq, int Hkv, int hd,
           cudaStream_t stream) {
  const int G = Hq / Hkv;
  const int threads = 32 * (G < 4 ? 4 : G);
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(G) * hd + kTile * (hd + 1) +
                       kTile * hd + G * kTile);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const float scale = 1.0f / sqrtf(static_cast<float>(hd));
  flash_decode_kernel<T><<<B * Hkv, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, out, S, Hq, Hkv, hd, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k and v share it). Returns the CUDA
// error code of the launch (0 = success). The caller validates shapes:
// Hq % Hkv == 0, Hq / Hkv <= 32, hd <= 256.
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const int* lengths,
                                   float* out, int B, int S, int Hq, int Hkv,
                                   int hd, int dtype, void* stream) {
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, lengths, out, B, S, Hq, Hkv, hd, s);
  return launch<float>(q, k, v, lengths, out, B, S, Hq, Hkv, hd, s);
}
