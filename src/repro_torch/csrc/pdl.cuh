// Launch helpers for the kernels that split their work over the card.
//
// Programmatic dependent launch (Hopper): a kernel that reads what the
// previous kernel on the stream wrote may be scheduled while that kernel
// still runs, and waits for it on the device instead of behind the host's
// launch gap. Used by the two-kernel calls of flash_decode.cu (split, then
// combine), ivf_gather_score.cu (plan, then score) and decode_fused.cu
// (score, then select or argmax).
//
// sm_count: decode_fused.cu and pq_lut_score.cu size their grids from the
// card's SM count on every call; it is read from the runtime once per
// device.
#pragma once

#include <cuda_runtime.h>

#include <atomic>

namespace repro_torch {

// In the first kernel: its dependent may be scheduled from now on (a no-op
// when nothing depends on it).
__device__ __forceinline__ void allow_dependent_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
}

// In the dependent kernel, before it reads the first kernel's output: waits
// until that grid has finished and its writes are visible (a no-op when the
// kernel was launched the ordinary way).
__device__ __forceinline__ void wait_for_previous_grid() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Launches kern on stream as a programmatic dependent of the stream's
// previous kernel; returns the CUDA error code (0 = success).
template <typename... Params, typename... Args>
int launch_dependent(void (*kern)(Params...), dim3 grid, dim3 block,
                     size_t smem, cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kern, args...));
}

// The current device's SM count into *sms, read from the runtime on the
// first call for each device and remembered for the process; returns the
// CUDA error code (0 = success).
inline int sm_count(int* sms) {
  constexpr int kDevices = 64;
  static std::atomic<int> known[kDevices];  // 0: not read yet
  int dev = 0;
  int e = static_cast<int>(cudaGetDevice(&dev));
  if (e) return e;
  if (dev < kDevices) {
    *sms = known[dev].load(std::memory_order_relaxed);
    if (*sms) return 0;
  }
  e = static_cast<int>(
      cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev));
  if (!e && dev < kDevices) known[dev].store(*sms, std::memory_order_relaxed);
  return e;
}

}  // namespace repro_torch
