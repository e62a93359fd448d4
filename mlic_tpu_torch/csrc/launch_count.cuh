// A count, in device memory, of the launches of a library's kernels that
// reached the device.
//
// Each counted kernel calls count_device_launch() first: thread 0 of block
// 0 adds one, so a launch that the host issued but that never ran on the
// card adds nothing.  MLIC_DEVICE_LAUNCH_COUNTER(name) exports
// `name`_device_launches(out), which copies the count to the host (after
// the caller's synchronize).  mlic_tpu_torch/ops/_build.py reads it beside
// the host's count of the same kernel's launches, so a run can show that
// its kernels ran on the device without a profiler's records.  Each
// library is one translation unit, so each has its own count.
#pragma once

#include <cuda_runtime.h>

__device__ unsigned long long g_device_launches = 0;

__device__ __forceinline__ void count_device_launch() {
  if ((blockIdx.x | blockIdx.y | blockIdx.z | threadIdx.x | threadIdx.y |
       threadIdx.z) == 0)
    atomicAdd(&g_device_launches, 1ull);
}

#define MLIC_DEVICE_LAUNCH_COUNTER(name)                                   \
  extern "C" int name##_device_launches(unsigned long long* out) {         \
    return static_cast<int>(                                               \
        cudaMemcpyFromSymbol(out, g_device_launches, sizeof(*out)));       \
  }
