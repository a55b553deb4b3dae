// flash_decode: one-token GQA decode attention against a KV ring, dense
// per sequence or paged in a shared block pool.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_decode.py::flash_decode
// (grid (B, Hq, S/s_blk), online softmax over s_blk tiles, positions at or
// past lengths[b] masked with -1e30, fp32 output).
//
// Two row addressings share one body (the RowAddr template below):
//   * dense: sequence b's ring is (S, Hkv, hd) at k + b * S * Hkv * hd;
//   * paged: the cache is a pool of (n_pool, block_len, Hkv, hd) blocks and
//     sequence b's page table pages[b, :n_pages] maps ring row r to block
//     pages[b, r / block_len], offset r % block_len (S = n_pages *
//     block_len). Each block stages the page ids its 64-row split spans in
//     shared memory once; a row's address is then one shared-memory read,
//     a divide and a multiply-add. The reference gathers the ring view
//     first; here the pool is read in place, so the bytes moved are the
//     dense kernel's. Rows at or past lengths[b] are never read, so the
//     pages past a sequence's length (the sentinel) are never dereferenced;
//     their ids are clamped into the pool anyway.
//
// What bounds it on an H100: bytes. Each decoded token reads the K and V
// rows of its sequence once, 2 * len * Hkv * hd * sizeof(T) bytes, and does
// 4 * len * Hq * hd flops on them: Hq / Hkv flops per bf16 byte (8 for
// tinyllama), far below the card's ~295 flops/byte ridge. At decode batch
// sizes the bytes are few (1 MB at 4 slots x 512 positions), so what sets
// the time is how many SMs stream at once and how much of each load's
// latency is hidden.
//
// Design (flash-decoding): the KV sequence is split across blocks. The grid
// is (split, KV head, sequence); a split covers kSplit = 64 cache rows, a
// compile-time constant never chosen from the batch, the card or other
// sequences' lengths, so 4 slots x 4 KV heads x 512 positions give 128
// blocks and 2,048 positions 512. A block serves all G = Hq / Hkv query
// heads of its KV head, so every K/V row is read from device memory once.
// It stages its rows in 32-row tiles in their own dtype (bf16 stays bf16 in
// shared memory) with 16-byte cp.async copies, two tiles in flight, so a
// tile's load overlaps the math on the one before; rows are padded by 16
// bytes, which makes the 16-byte row reads of a warp conflict-free. Warp g
// runs query head g's online softmax over the tile: lane r scores row r
// (fp32 dot with q, which sits in shared memory as fp32), then each lane
// folds the tile's P·V into its hd/32 output dims, the probabilities passed
// by shuffle. Each split writes its (acc[hd], m, l) per query head to a
// workspace; a second kernel, enqueued by the same C call, combines the
// splits of each (sequence, query head) in split order — no atomics, so the
// result is a function of the sequence's own q, K/V rows and length, equal
// bit for bit whatever the batch around it and from launch to launch. The
// combine is a programmatic dependent launch: it is scheduled while the
// split grid runs and waits for it on the device, so the host-side launch
// gap between the two kernels is hidden.
// Rows at or past lengths[b] are never read: their -1e30 scores would
// contribute exp(-1e30 - m) = 0 exactly. A sequence with lengths[b] == 0
// attends uniformly over all S rows, as the -1e30 mask of the reference
// does. Row geometry without 16-byte alignment (hd * sizeof(T) % 16 != 0,
// or an unaligned cache) takes a scalar copy path with the same arithmetic.
//
// The math: at 8 flops per byte the kernel is far from any compute peak,
// but on the CUDA cores the instructions per cache row (a 64-term dot per
// head, then a shuffle, two loads and two FMAs per head and output pair)
// outlast the row's load. So bf16 caches with hd % 16 == 0 (tinyllama's)
// run both products on the tensor cores (flash_decode_split_mma_kernel:
// mma.sync m16n8k16, exact bf16 products, fp32 sums; p enters P·V as two
// bf16 terms, so it keeps ~16 bits); fp32 and other geometries keep the
// CUDA-core kernel, in fp32 throughout.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "pdl.cuh"

namespace {

constexpr int kSplit = 64;          // cache rows per block (one split)
constexpr int kTile = 32;           // rows per staged tile: lane r, row r
constexpr int kStages = 2;          // tiles in flight
constexpr int kMaxDimsPerLane = 8;  // hd <= 256
constexpr int kCombineThreads = 256;  // >= hd: one thread per output dim
constexpr int kCombineChunk = 32;     // split records staged at a time

// The page table of the paged layout (unused by the dense one).
struct PageTable {
  const int* pages;  // (B, n_pages) physical block per ring page
  int n_pages;
  int block_len;  // ring rows per block
  int n_pool;     // blocks in the pool; page ids are clamped below it
};

// Element offset of ring row `row` of this block's (sequence, KV head) in
// k / v: the dense ring's, or the paged pool's through the staged pages.
template <bool kPaged>
struct RowAddr;

template <>
struct RowAddr<false> {
  size_t base;    // the sequence's ring, at its KV head
  size_t stride;  // elements per ring row (Hkv * hd)
  __device__ __forceinline__ size_t operator()(int row) const {
    return base + static_cast<size_t>(row) * stride;
  }
};

template <>
struct RowAddr<true> {
  const int* spages;  // shared memory: page ids from page0 on
  int page0;
  int block_len;
  size_t head;    // kvh * hd
  size_t stride;  // elements per pool row (Hkv * hd)
  __device__ __forceinline__ size_t operator()(int row) const {
    const int pg = row / block_len;
    const size_t prow = static_cast<size_t>(spages[pg - page0]) * block_len +
                        (row - pg * block_len);
    return prow * stride + head;
  }
};

// The row addressing of (sequence b, KV head kvh) for the split of rows
// [row0, row0 + nrows). Paged: stages the split's page ids in spages
// (kSplit ints: a 64-row split spans at most 64 pages) and syncs the block;
// every thread of the block must call it.
template <bool kPaged>
__device__ __forceinline__ RowAddr<kPaged> row_addr(
    const PageTable& pt, int* spages, int b, int kvh, int S, int Hkv, int hd,
    int row0, int nrows) {
  const size_t stride = static_cast<size_t>(Hkv) * hd;
  if constexpr (kPaged) {
    const int page0 = row0 / pt.block_len;
    const int npg = (row0 + nrows - 1) / pt.block_len - page0 + 1;
    const int* row_pages =
        pt.pages + static_cast<size_t>(b) * pt.n_pages + page0;
    for (int i = threadIdx.x; i < npg; i += blockDim.x)
      spages[i] = min(max(row_pages[i], 0), pt.n_pool - 1);
    __syncthreads();
    return RowAddr<true>{spages, page0, pt.block_len,
                         static_cast<size_t>(kvh) * hd, stride};
  } else {
    return RowAddr<false>{(static_cast<size_t>(b) * S * Hkv + kvh) * hd,
                          stride};
  }
}

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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// q_g · k_r in fp32 over hd dims, k_r in shared memory in its own dtype.
// vec: 16-byte reads (hd * sizeof(T) % 16 == 0).
__device__ __forceinline__ float smem_dot(const float* kr, const float* qg,
                                          int hd, bool vec) {
  float dot = 0.f;
  if (vec) {
#pragma unroll 4
    for (int c = 0; c < hd; c += 4) {
      const float4 a = *reinterpret_cast<const float4*>(kr + c);
      const float4 b = *reinterpret_cast<const float4*>(qg + c);
      dot = fmaf(a.x, b.x, dot);
      dot = fmaf(a.y, b.y, dot);
      dot = fmaf(a.z, b.z, dot);
      dot = fmaf(a.w, b.w, dot);
    }
  } else {
    for (int c = 0; c < hd; ++c) dot = fmaf(kr[c], qg[c], dot);
  }
  return dot;
}

__device__ __forceinline__ float smem_dot(const __nv_bfloat16* kr,
                                          const float* qg, int hd, bool vec) {
  float dot = 0.f;
  if (vec) {
#pragma unroll 4
    for (int c = 0; c < hd; c += 8) {
      const uint4 raw = *reinterpret_cast<const uint4*>(kr + c);
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
      const float4 b0 = *reinterpret_cast<const float4*>(qg + c);
      const float4 b1 = *reinterpret_cast<const float4*>(qg + c + 4);
      const float2 a0 = __bfloat1622float2(h2[0]);
      const float2 a1 = __bfloat1622float2(h2[1]);
      const float2 a2 = __bfloat1622float2(h2[2]);
      const float2 a3 = __bfloat1622float2(h2[3]);
      dot = fmaf(a0.x, b0.x, dot);
      dot = fmaf(a0.y, b0.y, dot);
      dot = fmaf(a1.x, b0.z, dot);
      dot = fmaf(a1.y, b0.w, dot);
      dot = fmaf(a2.x, b1.x, dot);
      dot = fmaf(a2.y, b1.y, dot);
      dot = fmaf(a3.x, b1.z, dot);
      dot = fmaf(a3.y, b1.w, dot);
    }
  } else {
    for (int c = 0; c < hd; ++c) dot = fmaf(__bfloat162float(kr[c]), qg[c], dot);
  }
  return dot;
}

__host__ __device__ __forceinline__ int row_pitch(int hd, int elem) {
  return hd + 16 / elem;  // elements; 16 bytes of padding per row
}

__host__ __device__ __forceinline__ size_t q_bytes(int G, int hd) {
  return (static_cast<size_t>(G) * hd * sizeof(float) + 15) & ~size_t{15};
}

// Workspace of one (sequence, query head): n_split records of hd + 2 floats
// (acc[hd], m, l).
// kDims: output dims per lane, ceil(hd / 32) rounded up to a power of two.
template <typename T, int kDims, bool kPaged>
__global__ void __launch_bounds__(1024) flash_decode_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ lengths, float* __restrict__ ws, int S, int Hq,
    int Hkv, int hd, int n_split, float scale, int vec, PageTable pt,
    int skip_empty) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int spages[kPaged ? kSplit : 1];
  const int G = Hq / Hkv;
  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  // the combine kernel may be scheduled now; it waits for this grid's end
  repro_torch::allow_dependent_launch();
  const int len = min(lengths[b], S);
  // a row of length 0 reads every row (the reference's all-masked
  // average), or with skip_empty (the log-sum-exp call) none
  const int rows_end = len > 0 ? len : (skip_empty ? 0 : S);
  const int row0 = split * kSplit;
  if (row0 >= rows_end) return;  // block-uniform: past the sequence
  const int nrows = min(kSplit, rows_end - row0);

  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int ld = row_pitch(hd, sizeof(T));
  float* sQ = reinterpret_cast<float*>(smem_raw);
  T* sKV = reinterpret_cast<T*>(smem_raw + q_bytes(G, hd));
  const size_t tile_elems = static_cast<size_t>(kTile) * ld;

  const RowAddr<kPaged> rows =
      row_addr<kPaged>(pt, spages, b, kvh, S, Hkv, hd, row0, nrows);
  const int n_tiles = (nrows + kTile - 1) / kTile;

  // Stage tile t (rows row0 + t * kTile ...) into buffer t % kStages; one
  // cp.async group per call, empty past the last tile.
  auto load_tile = [&](int t) {
    if (t < n_tiles) {
      T* sK = sKV + (2 * (t % kStages)) * tile_elems;
      T* sV = sK + tile_elems;
      const int r0 = row0 + t * kTile;
      const int nr = min(kTile, row0 + nrows - r0);
      if (vec) {
        constexpr int kE = 16 / sizeof(T);
        const int cpr = hd / kE;  // 16-byte chunks per row
        for (int i = tid; i < nr * cpr; i += nthr) {
          const int r = i / cpr;
          const int c = (i - r * cpr) * kE;
          const size_t off = rows(r0 + r) + c;
          cp_async16(sK + r * ld + c, k + off);
          cp_async16(sV + r * ld + c, v + off);
        }
      } else {
        for (int i = tid; i < nr * hd; i += nthr) {
          const int r = i / hd;
          const int c = i - r * hd;
          const size_t off = rows(r0 + r) + c;
          sK[r * ld + c] = k[off];
          sV[r * ld + c] = v[off];
        }
      }
    }
    cp_async_commit();
  };

  load_tile(0);
  load_tile(1);
  const T* qb = q + (static_cast<size_t>(b) * Hq + kvh * G) * hd;
  for (int i = tid; i < G * hd; i += nthr) sQ[i] = to_float(qb[i]);

  float m_run = -1e30f;
  float l_run = 0.f;
  float acc[kDims];
#pragma unroll
  for (int j = 0; j < kDims; ++j) acc[j] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait_all_but_one();  // tile t has landed (this thread's copies)
    __syncthreads();              // ... and every thread's, and sQ
    if (warp < G) {
      const T* sK = sKV + (2 * (t % kStages)) * tile_elems;
      const T* sV = sK + tile_elems;
      const int r0 = row0 + t * kTile;
      const int nr = min(kTile, row0 + nrows - r0);
      float s = -INFINITY;
      if (lane < nr) {
        const float dot = smem_dot(sK + lane * ld, sQ + warp * hd, hd, vec);
        s = (r0 + lane < len) ? dot * scale : -1e30f;
      }
      const float m_new = fmaxf(m_run, warp_max(s));
      const float corr = expf(m_run - m_new);
      const float p = lane < nr ? expf(s - m_new) : 0.f;
      l_run = l_run * corr + warp_sum(p);
      m_run = m_new;
#pragma unroll
      for (int j = 0; j < kDims; ++j) acc[j] *= corr;
#pragma unroll 8
      for (int r = 0; r < nr; ++r) {
        const float pr = __shfl_sync(0xffffffffu, p, r);
        const T* vr = sV + r * ld;
#pragma unroll
        for (int j = 0; j < kDims; ++j) {
          const int c = lane + 32 * j;
          if (c < hd) acc[j] = fmaf(pr, to_float(vr[c]), acc[j]);
        }
      }
    }
    __syncthreads();  // buffer t % kStages fully consumed
    load_tile(t + kStages);
  }

  if (warp < G) {
    float* wp = ws + ((static_cast<size_t>(b) * Hq + kvh * G + warp) * n_split +
                      split) * (hd + 2);
#pragma unroll
    for (int j = 0; j < kDims; ++j) {
      const int c = lane + 32 * j;
      if (c < hd) wp[c] = acc[j];
    }
    if (lane == 0) {
      wp[hd] = m_run;
      wp[hd + 1] = l_run;
    }
  }
}

// ---------------------------------------------------------------------------
// The bf16 split kernel on the tensor cores (mma.sync m16n8k16, fp32
// accumulation): q, K and V are bf16 already, so every product is exact.
//
//   * Q·Kᵀ: per 32-row tile, jobs (16 rows) x (8 heads): A = K rows from
//     shared memory (ldmatrix), B = q (bf16 in shared memory), C = scores
//     into sS[head][row];
//   * softmax: warp g < G runs head g's online softmax over sS[g] (as the
//     CUDA-core kernel does) and writes p as two bf16 terms, p_hi + p_lo
//     (p_lo = bf16(p - p_hi)), which carry p to ~2^-16 relative;
//   * P·V: jobs (16 output dims) x (8 heads): A = Vᵀ (ldmatrix.trans of the
//     V tile), B = p_hi, then p_lo, into register accumulators that the
//     warp owning the job rescales by each tile's correction.
//
// Heads are padded to a multiple of 8 (the mma's N); the padded columns are
// computed and never written. Needs hd % 16 == 0 and 16-byte rows.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x2(unsigned (&r)[2], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

// c += a · b for one m16n8k16 tile (bf16 in, fp32 accumulators).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

constexpr int kMaxPvJobs = 4;   // P·V jobs a warp owns (hd 256, G <= 4)
constexpr int kPPitch = kTile + 8;  // bf16 per row of p_hi / p_lo
constexpr int kSPitch = kTile + 1;  // floats per row of the scores

// Shared memory of the tensor-core kernel, in bytes, for Gp padded heads.
__host__ __device__ __forceinline__ size_t mma_smem(int Gp, int hd) {
  const size_t kv = sizeof(__nv_bfloat16) * 2 * kStages * kTile *
                    static_cast<size_t>(hd + 8);
  const size_t qb = sizeof(__nv_bfloat16) * static_cast<size_t>(Gp) * (hd + 8);
  const size_t ss = sizeof(float) * static_cast<size_t>(Gp) * kSPitch;
  const size_t sp = sizeof(__nv_bfloat16) * 2 * static_cast<size_t>(Gp) *
                    kPPitch;
  const size_t sc = sizeof(float) * static_cast<size_t>(Gp);
  return kv + qb + ss + sp + sc;
}

template <bool kPaged>
__global__ void __launch_bounds__(1024) flash_decode_split_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ lengths,
    float* __restrict__ ws, int S, int Hq, int Hkv, int hd, int n_split,
    float scale, PageTable pt, int skip_empty) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int spages[kPaged ? kSplit : 1];
  using bf16 = __nv_bfloat16;
  const int G = Hq / Hkv;
  const int Gp = (G + 7) & ~7;
  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  repro_torch::allow_dependent_launch();
  const int len = min(lengths[b], S);
  // a row of length 0 reads every row (the reference's all-masked
  // average), or with skip_empty (the log-sum-exp call) none
  const int rows_end = len > 0 ? len : (skip_empty ? 0 : S);
  const int row0 = split * kSplit;
  if (row0 >= rows_end) return;  // block-uniform: past the sequence
  const int nrows = min(kSplit, rows_end - row0);

  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int nwarps = nthr >> 5;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int ld = hd + 8;  // bf16 per K / V / q row in shared memory
  bf16* sKV = reinterpret_cast<bf16*>(smem_raw);
  const size_t tile_elems = static_cast<size_t>(kTile) * ld;
  bf16* sQb = sKV + 2 * kStages * tile_elems;
  float* sS = reinterpret_cast<float*>(sQb + static_cast<size_t>(Gp) * ld);
  bf16* sPh = reinterpret_cast<bf16*>(sS + Gp * kSPitch);
  bf16* sPl = sPh + Gp * kPPitch;
  float* sCorr = reinterpret_cast<float*>(sPl + Gp * kPPitch);

  const RowAddr<kPaged> rows =
      row_addr<kPaged>(pt, spages, b, kvh, S, Hkv, hd, row0, nrows);
  const int n_tiles = (nrows + kTile - 1) / kTile;
  const int cpr = hd / 8;  // 16-byte chunks per row

  auto load_tile = [&](int t) {
    if (t < n_tiles) {
      bf16* sK = sKV + (2 * (t % kStages)) * tile_elems;
      bf16* sV = sK + tile_elems;
      const int r0 = row0 + t * kTile;
      const int nr = min(kTile, row0 + nrows - r0);
      for (int i = tid; i < kTile * cpr; i += nthr) {
        const int r = i / cpr;
        const int c = (i - r * cpr) * 8;
        if (r < nr) {
          const size_t off = rows(r0 + r) + c;
          cp_async16(sK + r * ld + c, k + off);
          cp_async16(sV + r * ld + c, v + off);
        } else {  // rows past the sequence: p is 0 there, and so must V be
          *reinterpret_cast<uint4*>(sV + r * ld + c) = make_uint4(0, 0, 0, 0);
        }
      }
    }
    cp_async_commit();
  };

  load_tile(0);
  load_tile(1);
  const bf16* qb = q + (static_cast<size_t>(b) * Hq + kvh * G) * hd;
  for (int i = tid; i < G * hd; i += nthr) {
    const int g = i / hd;
    sQb[g * ld + (i - g * hd)] = qb[i];
  }

  const int mt_n = hd / 16;     // P·V jobs: mt_n x (Gp / 8)
  const int pv_jobs = mt_n * (Gp / 8);
  float m_run = -1e30f;
  float l_run = 0.f;
  float acc[kMaxPvJobs][4];
#pragma unroll
  for (int j = 0; j < kMaxPvJobs; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const int gq = lane >> 2;  // the mma's row group / column of this lane
  const int tq = lane & 3;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait_all_but_one();
    __syncthreads();
    const bf16* sK = sKV + (2 * (t % kStages)) * tile_elems;
    const bf16* sV = sK + tile_elems;
    const int r0 = row0 + t * kTile;
    const int nr = min(kTile, row0 + nrows - r0);

    // Q·Kᵀ: job = (16-row half of the tile, 8 heads)
    for (int job = warp; job < 2 * (Gp / 8); job += nwarps) {
      const int mt = job & 1;
      const int n0 = (job >> 1) * 8;
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k0 = 0; k0 < hd; k0 += 16) {
        unsigned a[4];
        unsigned bq[2];
        ldsm_x4(a, sK + (mt * 16 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
        ldsm_x2(bq, sQb + (n0 + (lane & 7)) * ld + k0 + ((lane >> 3) & 1) * 8);
        mma_bf16(c, a, bq);
      }
      const int r = mt * 16 + gq;
      sS[(n0 + 2 * tq) * kSPitch + r] = c[0];
      sS[(n0 + 2 * tq + 1) * kSPitch + r] = c[1];
      sS[(n0 + 2 * tq) * kSPitch + r + 8] = c[2];
      sS[(n0 + 2 * tq + 1) * kSPitch + r + 8] = c[3];
    }
    __syncthreads();

    // online softmax of head `warp` over the tile
    if (warp < G) {
      float s = -INFINITY;
      if (lane < nr)
        s = (r0 + lane < len) ? sS[warp * kSPitch + lane] * scale : -1e30f;
      const float m_new = fmaxf(m_run, warp_max(s));
      const float corr = expf(m_run - m_new);
      const float p = lane < nr ? expf(s - m_new) : 0.f;
      l_run = l_run * corr + warp_sum(p);
      m_run = m_new;
      const bf16 hi = __float2bfloat16_rn(p);
      sPh[warp * kPPitch + lane] = hi;
      sPl[warp * kPPitch + lane] = __float2bfloat16_rn(p - __bfloat162float(hi));
      if (lane == 0) sCorr[warp] = corr;
    }
    __syncthreads();

    // P·V: job = (16 output dims, 8 heads), accumulated across tiles
#pragma unroll
    for (int jj = 0; jj < kMaxPvJobs; ++jj) {
      const int job = warp + jj * nwarps;
      if (job < pv_jobs) {
        const int c0 = (job % mt_n) * 16;
        const int n0 = (job / mt_n) * 8;
        const float k0 = sCorr[min(n0 + 2 * tq, G - 1)];
        const float k1 = sCorr[min(n0 + 2 * tq + 1, G - 1)];
        acc[jj][0] *= k0;
        acc[jj][1] *= k1;
        acc[jj][2] *= k0;
        acc[jj][3] *= k1;
#pragma unroll
        for (int rk = 0; rk < kTile; rk += 16) {
          unsigned a[4];
          unsigned bh[2];
          unsigned bl[2];
          const int mat = lane >> 3;
          ldsm_x4_trans(a, sV + (rk + (lane & 7) + (mat >> 1) * 8) * ld + c0 +
                               (mat & 1) * 8);
          ldsm_x2(bh, sPh + (n0 + (lane & 7)) * kPPitch + rk +
                          ((lane >> 3) & 1) * 8);
          ldsm_x2(bl, sPl + (n0 + (lane & 7)) * kPPitch + rk +
                          ((lane >> 3) & 1) * 8);
          mma_bf16(acc[jj], a, bh);
          mma_bf16(acc[jj], a, bl);
        }
      }
    }
    __syncthreads();  // buffer t % kStages fully consumed
    load_tile(t + kStages);
  }

  // partials: each P·V job's accumulators, then (m, l) from the softmax warps
  const size_t head0 = static_cast<size_t>(b) * Hq + kvh * G;
#pragma unroll
  for (int jj = 0; jj < kMaxPvJobs; ++jj) {
    const int job = warp + jj * nwarps;
    if (job < pv_jobs) {
      const int c = (job % mt_n) * 16 + gq;
      const int n = (job / mt_n) * 8 + 2 * tq;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ne = n + (e & 1);
        const int ce = c + (e >> 1) * 8;
        if (ne < G)
          ws[((head0 + ne) * n_split + split) * (hd + 2) + ce] = acc[jj][e];
      }
    }
  }
  if (warp < G && lane == 0) {
    float* wp = ws + ((head0 + warp) * n_split + split) * (hd + 2);
    wp[hd] = m_run;
    wp[hd + 1] = l_run;
  }
}

// One block per (sequence, query head): the live splits' partials merged in
// split order. The block copies kCombineChunk records at a time into shared
// memory with coalesced loads, then thread c folds output dim c over them
// in split order. With lse (non-null) it also stores m + log(l), the log of
// the row's sum of exp(scaled score); a row of length 0 then has no split
// and gives out = 0, lse = -inf.
__global__ void __launch_bounds__(kCombineThreads)
    flash_decode_combine_kernel(const float* __restrict__ ws,
                                const int* __restrict__ lengths,
                                float* __restrict__ out,
                                float* __restrict__ lse, int S, int Hq,
                                int hd, int n_split) {
  extern __shared__ float sbuf[];  // kCombineChunk * (hd + 2) records
  __shared__ float sw[kCombineChunk];
  __shared__ float smax[kCombineThreads / 32];
  const int bh = blockIdx.x;
  const int tid = threadIdx.x;
  const int rec = hd + 2;
  const int len = min(lengths[bh / Hq], S);
  const int rows_end = len > 0 ? len : (lse != nullptr ? 0 : S);
  const int ns = (rows_end + kSplit - 1) / kSplit;
  const float* wp = ws + static_cast<size_t>(bh) * n_split * rec;
  // launched early (programmatic dependent launch): wait until the split
  // grid has finished and its partials are visible
  repro_torch::wait_for_previous_grid();
  float m = -INFINITY;  // the max is the same in any order
  for (int i = tid; i < ns; i += kCombineThreads)
    m = fmaxf(m, wp[static_cast<size_t>(i) * rec + hd]);
  m = warp_max(m);
  if ((tid & 31) == 0) smax[tid >> 5] = m;
  __syncthreads();
  m = smax[0];
#pragma unroll
  for (int w = 1; w < kCombineThreads / 32; ++w) m = fmaxf(m, smax[w]);

  float l = 0.f;
  float acc = 0.f;
  for (int c0 = 0; c0 < ns; c0 += kCombineChunk) {
    const int nc = min(kCombineChunk, ns - c0);
    const float* src = wp + static_cast<size_t>(c0) * rec;
    for (int e = tid; e < nc * rec; e += kCombineThreads)
      cp_async4(sbuf + e, src + e);  // all in flight at once
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    if (tid < nc) sw[tid] = expf(sbuf[tid * rec + hd] - m);
    __syncthreads();
    if (tid < hd) {
      for (int i = 0; i < nc; ++i) {
        const float w = sw[i];
        l = fmaf(sbuf[i * rec + hd + 1], w, l);
        acc = fmaf(sbuf[i * rec + tid], w, acc);
      }
    }
    __syncthreads();
  }
  if (lse == nullptr) {
    if (tid < hd) out[static_cast<size_t>(bh) * hd + tid] = acc / l;
    return;
  }
  if (tid < hd) out[static_cast<size_t>(bh) * hd + tid] = ns > 0 ? acc / l : 0.f;
  if (tid == 0) lse[bh] = ns > 0 ? m + logf(l) : -INFINITY;
}

template <typename T, int kDims, bool kPaged>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           float* out, float* lse, float* ws, int B, int S, int Hq, int Hkv,
           int hd, const PageTable& pt, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const int n_split = (S + kSplit - 1) / kSplit;
  const int threads = 32 * (G < 4 ? 4 : G);
  const bool aligned = ((reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  const int vec = aligned && (hd * sizeof(T)) % 16 == 0;
  const size_t smem = q_bytes(G, hd) + sizeof(T) * 2 * kStages * kTile *
                                           static_cast<size_t>(row_pitch(hd, sizeof(T)));
  // bf16 rows of 16-byte chunks and hd % 16 == 0 take the tensor cores
  const bool use_mma =
      std::is_same<T, __nv_bfloat16>::value && vec && hd % 16 == 0;
  if (smem > 48 * 1024 && !use_mma) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_decode_split_kernel<T, kDims, kPaged>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const float scale = 1.0f / sqrtf(static_cast<float>(hd));
  // S == 0: one empty split per (sequence, KV head); the output is 0 / 0
  const dim3 grid(n_split > 0 ? n_split : 1, Hkv, B);
  if (use_mma) {
    const size_t smem_mma = mma_smem((G + 7) & ~7, hd);
    if (smem_mma > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          flash_decode_split_mma_kernel<kPaged>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem_mma));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    flash_decode_split_mma_kernel<kPaged><<<grid, threads, smem_mma, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), lengths, ws, S, Hq, Hkv, hd,
        n_split, scale, pt, lse != nullptr);
  } else {
    flash_decode_split_kernel<T, kDims, kPaged>
        <<<grid, threads, smem, stream>>>(
            static_cast<const T*>(q), static_cast<const T*>(k),
            static_cast<const T*>(v), lengths, ws, S, Hq, Hkv, hd, n_split,
            scale, vec, pt, lse != nullptr);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return repro_torch::launch_dependent(
      flash_decode_combine_kernel, dim3(B * Hq), dim3(kCombineThreads),
      sizeof(float) * kCombineChunk * static_cast<size_t>(hd + 2), stream,
      static_cast<const float*>(ws), lengths, out, lse, S, Hq, hd, n_split);
}

// The launch for q/k/v of type T, with as many output dims per lane as hd
// needs.
template <typename T, bool kPaged>
int launch_dims(const void* q, const void* k, const void* v,
                const int* lengths, float* out, float* lse, float* ws, int B,
                int S, int Hq, int Hkv, int hd, const PageTable& pt,
                cudaStream_t s) {
  if (hd <= 32)
    return launch<T, 1, kPaged>(q, k, v, lengths, out, lse, ws, B, S, Hq,
                                Hkv, hd, pt, s);
  if (hd <= 64)
    return launch<T, 2, kPaged>(q, k, v, lengths, out, lse, ws, B, S, Hq,
                                Hkv, hd, pt, s);
  if (hd <= 128)
    return launch<T, 4, kPaged>(q, k, v, lengths, out, lse, ws, B, S, Hq,
                                Hkv, hd, pt, s);
  return launch<T, kMaxDimsPerLane, kPaged>(q, k, v, lengths, out, lse, ws,
                                            B, S, Hq, Hkv, hd, pt, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k and v share it). ws: the split
// workspace, B * Hq * ceil(S / split_rows) * (hd + 2) floats; split_rows
// must be the kernel's kSplit (the caller sizes ws with it). lse: null, or
// B * Hq floats for each row's log-sum-exp (a row of length 0 is then
// empty: out 0, lse -inf, nothing read). Enqueues the split kernel and the
// combine kernel; returns the CUDA error code of the launches (0 =
// success). The caller validates shapes: Hq % Hkv == 0, Hq / Hkv <= 32,
// hd <= 256.
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const int* lengths,
                                   float* out, float* ws, int B, int S,
                                   int Hq, int Hkv, int hd, int split_rows,
                                   int dtype, void* stream, float* lse) {
  if (split_rows != kSplit) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const PageTable none{nullptr, 0, 1, 1};
  if (dtype == 1)
    return launch_dims<__nv_bfloat16, false>(q, k, v, lengths, out, lse, ws,
                                             B, S, Hq, Hkv, hd, none, s);
  return launch_dims<float, false>(q, k, v, lengths, out, lse, ws, B, S, Hq,
                                   Hkv, hd, none, s);
}

// The paged layout: k_pool / v_pool are (n_pool, block_len, Hkv, hd) and
// pages (B, n_pages) int32 maps each sequence's ring pages to pool blocks;
// the ring is S = n_pages * block_len rows (ws is sized with that S).
// Otherwise as flash_decode_launch.
extern "C" int flash_decode_paged_launch(
    const void* q, const void* k_pool, const void* v_pool, const int* pages,
    const int* lengths, float* out, float* ws, int B, int n_pages,
    int block_len, int n_pool, int Hq, int Hkv, int hd, int split_rows,
    int dtype, void* stream) {
  if (split_rows != kSplit || block_len < 1 || n_pool < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const PageTable pt{pages, n_pages, block_len, n_pool};
  const int S = n_pages * block_len;
  if (dtype == 1)
    return launch_dims<__nv_bfloat16, true>(q, k_pool, v_pool, lengths, out,
                                            nullptr, ws, B, S, Hq, Hkv, hd,
                                            pt, s);
  return launch_dims<float, true>(q, k_pool, v_pool, lengths, out, nullptr,
                                  ws, B, S, Hq, Hkv, hd, pt, s);
}
