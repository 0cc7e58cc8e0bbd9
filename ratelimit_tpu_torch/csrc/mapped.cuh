// The mapped launch form shared by the serving kernels' rows kernels: K1
// and K6 (counter_update.cuh, unique_step_rows_kernel), K4 and K5
// (algorithms.cu, sw_serve_step_rows_kernel and gcra_serve_step_rows_kernel).
//
// A served chunk past kMaxLanes lanes stays in the caller's PINNED host
// staging: the kernel reads the packed words through their device alias
// (mapped_alias, by_value.cuh) while it runs and writes its readback there
// the same way, so the chunk is one launch with no upload, no device
// buffer and no readback copy.  The same kernel launched on device
// pointers is the device form.  What bounds it is the host link: each
// lane crosses it once each way.  A dependent chain costs a link round
// trip (~1-2 us), so each thread serves kMappedLanes consecutive lanes of
// a row, issues one 16-byte load for each packed row it needs before any
// gather of state, every gather before any store (the engine dedups, so
// live slots are unique and the hoist is the serial order's result), and
// writes its readback as 16-byte stores.  A block is one warp
// (kMappedThreads), so a chunk's host reads issue from as many SMs as it
// has warps: at 4096 lanes one-warp blocks took 5.66 us against 6.63 for
// blocks of 256 (scripts/torch_mapped_load.py, H100 80GB HBM3, 700 W).
// Rows whose width or address is not 16-byte aligned (a public wrapper's
// N = 129, say) take scalar loads and stores; the engine's buckets are
// multiples of 8.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "by_value.cuh"

constexpr int kMappedLanes = 4;
constexpr int kMappedThreads = 32;

// Blocks of a rows launch over rows of n lanes.
inline int mapped_blocks(int n) {
  const int threads = (n + kMappedLanes - 1) / kMappedLanes;
  return (threads + kMappedThreads - 1) / kMappedThreads;
}

// Whether rows of n lanes at `packed` with their readback at `out` take
// 16-byte loads and stores: n a multiple of kMappedLanes and both
// addresses 16-byte aligned (so is then every row and lane group).
inline bool mapped_vec(int n, const void* packed, const void* out) {
  return n % kMappedLanes == 0 && reinterpret_cast<uintptr_t>(packed) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(out) % 16 == 0;
}

// The device aliases of the pinned host `words` and `out`, or
// mapped_alias's error (returned and cleared) where one has none:
// pageable memory.
inline cudaError_t mapped_aliases(const void* words, void* out, void** dev_words,
                                  void** dev_out) {
  const cudaError_t err = mapped_alias(const_cast<void*>(words), dev_words);
  return err != cudaSuccess ? err : mapped_alias(out, dev_out);
}

// Lanes [i0, i0 + m) of one packed row, `row` pointing at its lane i0,
// into w: one 16-byte load where `vec`, else m scalar loads and `fill`
// in the lanes past m.
__device__ __forceinline__ void load_lanes(const int32_t* __restrict__ row, int m, bool vec,
                                           int32_t (&w)[kMappedLanes], int32_t fill = 0) {
  if (vec) {
    const int4 v = *reinterpret_cast<const int4*>(row);
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < kMappedLanes; ++j) {
      w[j] = j < m ? row[j] : fill;
    }
  }
}
