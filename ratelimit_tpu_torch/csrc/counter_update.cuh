// Fixed-window counter kernels shared by csrc/fixed_window.cu (one table,
// K1 and the K3 update) and csrc/sharded.cu (a bank-sharded table, K6 and
// K7).  Counters are uint32 (stored by the caller as int32 of the same
// bits); all arithmetic and comparisons are on uint32_t.
//
// The duplicate-tolerant update is templated on an index policy, the map
// from a slot id to a table position (or -1 where the id is inert):
//
// - WrappedIndex: one table, JAX's index semantics (slot_index.cuh): an
//   id in [-num_slots, -1] addresses id + num_slots.
// - StripedIndex: a (num_banks, slots_per_bank) table, bank-major.  Global
//   slot s in [0, num_banks * slots_per_bank) lives in bank s % num_banks
//   at position s / num_banks.  Every other id, negative ones included, is
//   out of the table: the sharded JAX model masks ids to [0, num_slots)
//   and never wraps them (ratelimit_tpu/parallel/sharded.py:281-287).
//
// A fresh lane zeroes its slot for EVERY lane of that slot, so every
// zeroing must land before any gather, and every gather before any add:
// the update runs as separate launches on one stream -- zero fresh slots,
// gather, the per-slot prefix (K2, csrc/prefix.cu, which zeroes its
// output and runs its triangular tiled pass), then add + modular
// atomicAdd.  The prefix's stream order is what makes its atomics finish
// before the add reads them.
//
// The unique-slot serving step takes one thread per lane and a bank per
// blockIdx.y (a single table is one bank): slots are unique within a
// bank, so the scatter needs no atomics.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "slot_index.cuh"

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kU32Max = 0xFFFFFFFFu;

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

struct WrappedIndex {
  long long num_slots;
  __device__ __forceinline__ long long operator()(int32_t slot) const {
    return slot_index(slot, num_slots);
  }
};

struct StripedIndex {
  int num_banks;
  long long slots_per_bank;
  __device__ __forceinline__ long long operator()(int32_t slot) const {
    if (slot < 0 || slot >= num_banks * slots_per_bank) {
      return -1;
    }
    return (slot % num_banks) * slots_per_bank + slot / num_banks;
  }
};

// The serving readback of one lane: the raw after (out_kind 0), or
// min(after, limit + hits) -- the cap is modular, as the reference's --
// truncated to uint8 (1) or uint16 (2).
__device__ __forceinline__ void write_readback(void* out, long long lane,
                                               uint32_t after, uint32_t cap,
                                               int out_kind) {
  if (out_kind == 0) {
    static_cast<uint32_t*>(out)[lane] = after;
    return;
  }
  const uint32_t sat = after < cap ? after : cap;
  if (out_kind == 1) {
    static_cast<uint8_t*>(out)[lane] = static_cast<uint8_t>(sat);
  } else {
    static_cast<uint16_t*>(out)[lane] = static_cast<uint16_t>(sat);
  }
}

// Bank blockIdx.y of `counts` (num_slots each) against its packed
// int32[4, n] rows (slot, hits bits, limit bits, fresh) of an int32[banks,
// 4, n] batch: fresh-zero, gather, saturating add, unique scatter-set,
// readback into out[banks, n].
__global__ void unique_step_kernel(uint32_t* __restrict__ counts,
                                   long long num_slots,
                                   const int32_t* __restrict__ packed, int n,
                                   void* __restrict__ out, int out_kind) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) {
    return;
  }
  const long long bank = blockIdx.y;
  counts += bank * num_slots;
  packed += bank * 4 * n;
  const long long slot = slot_index(packed[i], num_slots);
  const uint32_t hits = static_cast<uint32_t>(packed[n + i]);
  const uint32_t limit = static_cast<uint32_t>(packed[2 * n + i]);
  const bool fresh = packed[3 * n + i] != 0;
  const bool live = slot >= 0;

  const uint32_t before = (live && !fresh) ? counts[slot] : 0u;
  uint32_t after = before + hits;
  if (after < before) {  // one u32 add wraps at most once: saturate
    after = kU32Max;
  }
  if (live) {
    counts[slot] = after;
  }
  write_readback(out, bank * n + i, after, limit + hits, out_kind);
}

int launch_unique_step(void* counts, long long num_slots, const void* packed,
                       int banks, int n, void* out, int out_kind,
                       void* stream) {
  if (n <= 0 || banks <= 0) {
    return 0;
  }
  unique_step_kernel<<<dim3(blocks_for(n), banks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(counts), num_slots,
      static_cast<const int32_t*>(packed), n, out, out_kind);
  return static_cast<int>(cudaGetLastError());
}

template <class Index>
__global__ void zero_fresh_kernel(uint32_t* __restrict__ counts, Index index,
                                  const int32_t* __restrict__ slots,
                                  const uint8_t* __restrict__ fresh, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n && fresh[i]) {
    const long long slot = index(slots[i]);
    if (slot >= 0) {
      counts[slot] = 0u;
    }
  }
}

template <class Index>
__global__ void gather_kernel(const uint32_t* __restrict__ counts, Index index,
                              const int32_t* __restrict__ slots,
                              uint32_t* __restrict__ before, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    const long long slot = index(slots[i]);
    before[i] = slot >= 0 ? counts[slot] : 0u;
  }
}

// afters = before + incl, in place in `afters` (modular: the general path
// does not saturate), the modular scatter-add of hits, and with out_kind
// 1 or 2 the narrow readback of each after into `out`.
template <class Index>
__global__ void add_kernel(uint32_t* __restrict__ counts, Index index,
                           const int32_t* __restrict__ slots,
                           const uint32_t* __restrict__ hits,
                           const uint32_t* __restrict__ incl,
                           uint32_t* __restrict__ afters,
                           const uint32_t* __restrict__ limits,
                           void* __restrict__ out, int out_kind, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) {
    return;
  }
  const uint32_t after = afters[i] + incl[i];
  afters[i] = after;
  const long long slot = index(slots[i]);
  if (slot >= 0) {
    atomicAdd(&counts[slot], hits[i]);
  }
  if (out_kind != 0) {
    write_readback(out, i, after, limits[i] + hits[i], out_kind);
  }
}

// First half of the general update: zero fresh slots, then gather the
// table values into `before` (a second launch, so it sees every zero).
template <class Index>
int launch_zero_and_gather(void* counts, Index index, const void* slots,
                           const void* fresh, void* before, int n,
                           void* stream) {
  if (n <= 0) {
    return 0;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  zero_fresh_kernel<<<blocks_for(n), kThreads, 0, s>>>(
      static_cast<uint32_t*>(counts), index,
      static_cast<const int32_t*>(slots), static_cast<const uint8_t*>(fresh),
      n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  gather_kernel<<<blocks_for(n), kThreads, 0, s>>>(
      static_cast<const uint32_t*>(counts), index,
      static_cast<const int32_t*>(slots), static_cast<uint32_t*>(before), n);
  return static_cast<int>(cudaGetLastError());
}

// Second half, after the prefix (see add_kernel).
template <class Index>
int launch_add(void* counts, Index index, const void* slots, const void* hits,
               const void* incl, void* afters, const void* limits, void* out,
               int out_kind, int n, void* stream) {
  if (n <= 0) {
    return 0;
  }
  add_kernel<<<blocks_for(n), kThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(counts), index,
      static_cast<const int32_t*>(slots), static_cast<const uint32_t*>(hits),
      static_cast<const uint32_t*>(incl), static_cast<uint32_t*>(afters),
      static_cast<const uint32_t*>(limits), out, out_kind, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
