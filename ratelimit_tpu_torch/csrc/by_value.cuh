// The by-value launch form shared by the serving kernels: K1 and K6
// (counter_update.cuh), K4 and K5 (algorithms.cu).
//
// A served chunk of at most kMaxLanes lanes rides in the launch's
// parameters, one record a lane, which the launcher transposes from the
// caller's HOST words; one block of the lanes rounded up to a warp serves
// it, and the kernel writes its readback straight into the caller's pinned
// host memory through the device alias that cudaHostGetDevicePointer
// gives.  A served chunk is then one device activity: no upload copy, no
// readback copy, and no dependent load of the lane before the gather of
// its state.  The caller must wait for the stream (an event) before
// reading the readback.
//
// Every parameter struct is built at its full kMaxLanes size, whatever
// the chunk's width (one instantiation: a struct of 8 lanes and one of 128
// launch in the same device time, scripts/torch_lane_batch.py), and
// static_asserts that it fits kParamBytes, the classic 4 KB of kernel
// parameters that every CUDA version accepts.  The engine's rule
// (models/fixed_window.py lanes_by_value) counts lanes, not bytes: banks x
// padded <= kMaxLanes for every kernel.

#pragma once

#include <cuda_runtime.h>

constexpr int kMaxLanes = 128;
constexpr int kParamBytes = 4096;

// Threads of a by-value launch: the lanes rounded up to a warp.
inline int lane_threads(int lanes) { return (lanes + 31) / 32 * 32; }

// The device alias of the pinned host memory at `host`, into `*device`.
// A failure (pageable memory has no alias) is returned and cleared, so the
// next launch check does not report it.
inline cudaError_t mapped_alias(void* host, void** device) {
  const cudaError_t err = cudaHostGetDevicePointer(device, host, 0);
  if (err != cudaSuccess) {
    cudaGetLastError();
  }
  return err;
}
