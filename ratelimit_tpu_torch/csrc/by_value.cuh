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
// next launch check does not report it.  The alias is asked in the
// calling thread's current device context, the one the launch goes to:
// every wrapper launches under its table's device (kernels.launch), so a
// bank group on a second card takes its alias there.  That the same
// pinned block is reachable from every card rests on the CUDA runtime's
// unified-addressing rule ("Automatic Mapping of Host Allocated Host
// Memory"): host memory from cudaHostAlloc or cudaMallocHost, as torch's
// pinned allocator makes it, is directly accessible from every device
// that supports unified addressing, whatever its flags, at one address.
// One card cannot show this: chip_smoke.py's phase 16 does, on a host of
// several cards, where its bank groups serve by value from every card.
inline cudaError_t mapped_alias(void* host, void** device) {
  const cudaError_t err = cudaHostGetDevicePointer(device, host, 0);
  if (err != cudaSuccess) {
    cudaGetLastError();
  }
  return err;
}
