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
// The unique-slot serving step (serve_lane) takes one thread per lane:
// slots are unique within a bank, so the scatter needs no atomics.  A
// single table is one bank.  It has two forms, chosen by the batch's
// shape alone (fixed_window.py lanes_by_value):
//
// - the device form, unique_step_kernel: the packed int32[banks, 4, n]
//   batch in device memory, a bank per blockIdx.y, the readback into a
//   device tensor.  It serves batches too large for a launch's
//   parameters (warmup, bursts) and the public wrappers.
// - the by-value form, unique_step_lanes_kernel (by_value.cuh): at most
//   kMaxLanes lanes (banks x cap) ride in the launch's parameters, one
//   16-byte (slot, hits, limit, fresh) record per lane.  One block of
//   banks x cap threads, the readback into the caller's pinned host
//   memory through its device alias.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "by_value.cuh"
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

// One lane of the unique-slot step on one bank's `counts` (num_slots
// each): fresh-zero, gather, saturating add, unique scatter-set, and
// readback entry `lane` of `out`.
__device__ __forceinline__ void serve_lane(uint32_t* __restrict__ counts,
                                           long long num_slots, int32_t id,
                                           uint32_t hits, uint32_t limit,
                                           bool fresh, void* __restrict__ out,
                                           long long lane, int out_kind) {
  const long long slot = slot_index(id, num_slots);
  const bool live = slot >= 0;
  const uint32_t before = (live && !fresh) ? counts[slot] : 0u;
  uint32_t after = before + hits;
  if (after < before) {  // one u32 add wraps at most once: saturate
    after = kU32Max;
  }
  if (live) {
    counts[slot] = after;
  }
  write_readback(out, lane, after, limit + hits, out_kind);
}

// Device form: bank blockIdx.y of `counts` against its packed int32[4, n]
// rows (slot, hits bits, limit bits, fresh) of an int32[banks, 4, n]
// batch, readback into out[banks, n].
__global__ void unique_step_kernel(uint32_t* __restrict__ counts,
                                   long long num_slots,
                                   const int32_t* __restrict__ packed, int n,
                                   void* __restrict__ out, int out_kind) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) {
    return;
  }
  const long long bank = blockIdx.y;
  packed += bank * 4 * n;
  serve_lane(counts + bank * num_slots, num_slots, packed[i],
             static_cast<uint32_t>(packed[n + i]),
             static_cast<uint32_t>(packed[2 * n + i]), packed[3 * n + i] != 0,
             out, bank * n + i, out_kind);
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

// By-value form (by_value.cuh): 16 B x 128 lanes = 2 KB of records.
struct LaneBatch {
  uint32_t* counts;
  void* out;            // device alias of the caller's pinned readback
  long long num_slots;  // slots per bank
  int cap;              // lanes per bank
  int lanes;            // banks x cap; records past it are never read
  int out_kind;
  int4 lane[kMaxLanes];  // lane t = bank * cap + i: (slot, hits, limit, fresh)
};

static_assert(sizeof(LaneBatch) <= kParamBytes,
              "the by-value batch must fit the 4 KB parameter space");

// __grid_constant__ lets each thread index the parameter array in place
// (a plain by-value struct indexed per thread would be copied to local
// memory first).  Thread t serves lane t of bank t / cap; out[banks, cap]
// is indexed by t as well.
__global__ void unique_step_lanes_kernel(const __grid_constant__ LaneBatch b) {
  const int t = threadIdx.x;
  if (t >= b.lanes) {
    return;
  }
  const long long bank = t / b.cap;
  const int4 l = b.lane[t];
  serve_lane(b.counts + bank * b.num_slots, b.num_slots, l.x,
             static_cast<uint32_t>(l.y), static_cast<uint32_t>(l.z), l.w != 0,
             b.out, t, b.out_kind);
}

// The by-value launcher.  `words` is the HOST address of the int32[banks,
// 4, cap] batch; its values are copied into the launch, so the caller may
// reuse the buffer as soon as this returns.  `out` is the host address of
// pinned memory (mapped_alias's error is returned where it has no alias).
int launch_unique_step_lanes(void* counts, long long num_slots,
                             const void* words, int banks, int cap, void* out,
                             int out_kind, void* stream) {
  if (banks <= 0 || cap <= 0) {
    return 0;
  }
  if (static_cast<long long>(banks) * cap > kMaxLanes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LaneBatch b;
  const cudaError_t err = mapped_alias(out, &b.out);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  b.counts = static_cast<uint32_t*>(counts);
  b.num_slots = num_slots;
  b.cap = cap;
  b.lanes = banks * cap;
  b.out_kind = out_kind;
  // words is int32[banks, 4, cap] row-major; transpose to one record a lane.
  const int32_t* w = static_cast<const int32_t*>(words);
  for (int bank = 0; bank < banks; ++bank) {
    const int32_t* rows = w + bank * 4 * cap;
    for (int i = 0; i < cap; ++i) {
      b.lane[bank * cap + i] =
          make_int4(rows[i], rows[cap + i], rows[2 * cap + i], rows[3 * cap + i]);
    }
  }
  unique_step_lanes_kernel<<<1, lane_threads(b.lanes), 0,
                             static_cast<cudaStream_t>(stream)>>>(b);
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
