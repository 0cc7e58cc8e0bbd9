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
// duplicate-tolerant step), :108 step_counters_compact (rl_fw_add's
// optional narrow readback) and :294 decision_block.  The update runs as
// separate launches on one stream (counter_update.cuh says why): zero
// fresh slots, gather, the per-slot prefix (K2, csrc/prefix.cu: a memset
// and a triangular tiled pass over the whole card), then add + modular
// atomicAdd; each is about one launch's cost at the engine's batch
// sizes.  fw_decision_block is the branch-free
// threshold machine, one thread per lane; the near-limit threshold is
// floorf(__fmul_rn(limit, ratio)) so that nvcc cannot contract it with
// anything else.

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
  if (i >= n) {
    return;
  }
  const uint32_t after = afters[i];
  const uint32_t h = hits[i];
  const uint32_t limit = limits[i];
  const uint32_t before = after - h;
  const float near_f =
      floorf(__fmul_rn(__uint2float_rn(limit), near_ratio));
  const uint32_t near =
      near_f <= 0.0f ? 0u
                     : (near_f >= 4294967296.0f ? kU32Max
                                                : static_cast<uint32_t>(near_f));

  const bool over = after > limit;
  const bool ok = !over;
  const bool fully_over = over && before >= limit;
  const bool partly_over = over && !fully_over;
  const uint32_t over_delta =
      fully_over ? h : (partly_over ? after - limit : 0u);
  const uint32_t max_near_before = near > before ? near : before;
  const uint32_t near_from_over = partly_over ? limit - max_near_before : 0u;
  const bool near_ok = ok && after > near;
  const uint32_t near_from_ok =
      (near_ok && before >= near) ? h : (near_ok ? after - near : 0u);
  const bool shadowed = over && shadow[i] != 0;

  out[i] = (over && !shadowed) ? 2u : 1u;          // codes
  out[n + i] = ok ? limit - after : 0u;            // limit_remaining
  out[2 * n + i] = before;                         // befores
  out[3 * n + i] = after;                          // afters
  out[4 * n + i] = over_delta;                     // over_limit
  out[5 * n + i] = near_from_over + near_from_ok;  // near_limit
  out[6 * n + i] = ok ? h : 0u;                    // within_limit
  out[7 * n + i] = shadowed ? h : 0u;              // shadow_mode
  set_lc[i] = over ? 1 : 0;                        // set_local_cache
}

}  // namespace

extern "C" int rl_fw_unique_step(void* counts, long long num_slots,
                                 const void* packed, int n, void* out,
                                 int out_kind, void* stream) {
  return launch_unique_step(counts, num_slots, packed, 1, n, out, out_kind,
                            stream);
}

extern "C" int rl_fw_zero_and_gather(void* counts, long long num_slots,
                                     const void* slots, const void* fresh,
                                     void* before, int n, void* stream) {
  return launch_zero_and_gather(counts, WrappedIndex{num_slots}, slots, fresh,
                                before, n, stream);
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

extern "C" int rl_fw_add(void* counts, long long num_slots, const void* slots,
                         const void* hits, const void* incl, void* afters,
                         const void* limits, void* out, int out_kind, int n,
                         void* stream) {
  return launch_add(counts, WrappedIndex{num_slots}, slots, hits, incl, afters,
                    limits, out, out_kind, n, stream);
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
