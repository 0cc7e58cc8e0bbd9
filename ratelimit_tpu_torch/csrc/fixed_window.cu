// Fixed-window counter kernels for Hopper (sm_90a).
//
// The counter table is uint32 per slot (stored by the caller as an int32
// tensor of the same bits).  All arithmetic and comparisons here are on
// uint32_t: torch's int32 compares are signed and wrong at 2^31 and up.
// Slot ids follow JAX's index semantics (slot_index.cuh): an id in
// [-num_slots, -1] addresses id + num_slots; any other id outside the
// table is inert.  The kernels of K1 and the K3 update live in
// counter_update.cuh, shared with the bank-sharded table (sharded.cu).
//
// K1 fw_unique_step replaces the jitted XLA step
//   ratelimit_tpu/models/fixed_window.py:171 step_counters_unique_packed
//   -> update_unique (:200-245).
// One thread per lane of the packed int32[4, N] batch (rows: slot, hits
// bits, limit bits, fresh).  Slots are unique, so the scatter needs no
// atomics.  Bound: 16 B in, 4 B gathered, 4 B written and <= 4 B read
// back per lane -- about 0.1 MB at 4096 lanes, so the launch latency
// and not the memory system bounds it.  The TPU's 128-wide row gather
// (fixed_window.py:210-226) is a TPU layout trick and has no
// counterpart here.  Two forms (counter_update.cuh): rl_fw_unique_step
// reads the batch from device memory; rl_fw_unique_step_lanes, for the
// served widths (N <= 128), takes it from host words into the launch's
// parameters and writes the readback into mapped pinned memory, so a
// served chunk is one device activity instead of upload, kernel and
// readback copy.
//
// K3 replaces ratelimit_tpu/models/fixed_window.py:247 update (the
// duplicate-tolerant step), :108 step_counters_compact (its narrow
// readback) and :294 decision_block.  rl_fw_general_step runs the whole
// general step -- zero fresh slots, gather, the per-slot prefix (K2's
// tile pass), modular scatter-add, and the raw afters, their narrow
// readback or the decision block as its epilogue -- in ONE cooperative
// launch, general_step_kernel in counter_update.cuh (which says what
// bounds it and why it is one launch).  rl_fw_decision_block is the
// decision block alone, one thread per lane, the same decide_lane
// function as the fused epilogue.

#include <cstdint>
#include <cuda_runtime.h>

#include "counter_update.cuh"

namespace {

__global__ void fw_decision_block_kernel(const uint32_t* __restrict__ afters,
                                         const uint32_t* __restrict__ hits,
                                         const uint32_t* __restrict__ limits,
                                         const uint8_t* __restrict__ shadow,
                                         float near_ratio, int n,
                                         uint32_t* __restrict__ out,
                                         uint8_t* __restrict__ set_lc) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    decide_lane(afters[i], hits[i], limits[i], shadow[i] != 0, near_ratio, out,
                n, i, set_lc);
  }
}

}  // namespace

extern "C" int rl_fw_unique_step(void* counts, long long num_slots,
                                 const void* packed, int n, void* out,
                                 int out_kind, void* stream) {
  return launch_unique_step(counts, num_slots, packed, 1, n, out, out_kind,
                            stream);
}

extern "C" int rl_fw_unique_step_lanes(void* counts, long long num_slots,
                                       const void* words, int n, void* out,
                                       int out_kind, void* stream) {
  return launch_unique_step_lanes(counts, num_slots, words, 1, n, out,
                                  out_kind, stream);
}

// The device alias of pinned host memory at `host` (what the by-value
// launchers write through), for checks on the card.
extern "C" int rl_mapped_alias(void* host, void** device) {
  return static_cast<int>(mapped_alias(host, device));
}

// The general step (K3) of n lanes on one table; `epilogue` is an
// Epilogue of counter_update.cuh.
extern "C" int rl_fw_general_step(void* counts, long long num_slots,
                                  const void* slots, const void* hits,
                                  const void* fresh, const void* limits,
                                  const void* shadow, float near_ratio,
                                  void* afters, void* incl, void* out,
                                  void* set_lc, int epilogue, int n,
                                  void* stream) {
  return launch_general_step(counts, WrappedIndex{num_slots}, slots, hits,
                             fresh, limits, shadow, near_ratio, afters, incl,
                             out, set_lc, epilogue, n, stream);
}

extern "C" int rl_fw_decision_block(const void* afters, const void* hits,
                                    const void* limits, const void* shadow,
                                    float near_ratio, int n, void* out,
                                    void* set_lc, void* stream) {
  if (n <= 0) {
    return 0;
  }
  fw_decision_block_kernel<<<blocks_for(n), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(afters), static_cast<const uint32_t*>(hits),
      static_cast<const uint32_t*>(limits),
      static_cast<const uint8_t*>(shadow), near_ratio, n,
      static_cast<uint32_t*>(out), static_cast<uint8_t*>(set_lc));
  return static_cast<int>(cudaGetLastError());
}
