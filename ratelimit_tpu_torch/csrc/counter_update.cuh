// Fixed-window counter kernels shared by csrc/fixed_window.cu (one table,
// K1 and K3) and csrc/sharded.cu (a bank-sharded table, K6 and K7).
// Counters are uint32 (stored by the caller as int32 of the same bits);
// all arithmetic and comparisons are on uint32_t.
//
// The duplicate-tolerant general step is templated on an index policy,
// the map from a slot id to the counter it addresses (null where the id
// is inert here):
//
// - WrappedIndex: one table, JAX's index semantics (slot_index.cuh): an
//   id in [-num_slots, -1] addresses id + num_slots.
// - GroupIndex: the banks [bank_lo, bank_lo + banks_here) of a
//   (num_banks, slots_per_bank) table, bank-major, held as one bank
//   group's (banks_here, slots_per_bank) tensor.  Global slot s in [0,
//   num_banks * slots_per_bank) lives in bank s % num_banks at position
//   s / num_banks.  Every other id, negative ones included, is out of the
//   table: the sharded JAX model masks ids to [0, num_slots) and never
//   wraps them (ratelimit_tpu/parallel/sharded.py:281-287).  An id owned
//   by a bank outside the group is inert here, as on another chip of the
//   JAX mesh.  A group of every bank (bank_lo 0, banks_here num_banks) is
//   the whole sharded table.
// - CardIndex: every bank group of a mesh that lies on one card, each
//   its own (k, slots_per_bank) tensor; group g holds the banks [g k,
//   (g + 1) k).  It carries one table pointer per group of the mesh, null
//   for a group on another card, so one launch serves every group the
//   card holds.
//
// Each policy also says which lanes its tables OWN, the `owned` mask of
// _bank_core (sharded.py:286): an in-table lane is owned by its bank's
// table, an out-of-table lane by the table that holds bank 0.  Only an
// owned lane runs the epilogue: the step writes nothing at the others.
// WrappedIndex, and a group of every bank, own every lane.
//
// and on an epilogue: the raw afters, their narrow u8/u16 readback, or
// the decision block's nine fields.  It is one cooperative launch
// (general_step_kernel, below, says how and why).
//
// The unique-slot serving step serves each lane from one thread: slots
// are unique within a bank, so the scatter needs no atomics.  A single
// table is one bank.  Two kernels serve it:
//
// - unique_step_rows_kernel: the packed int32[banks, 4, n] batch, a bank
//   row per blockIdx.y, kMappedLanes lanes a thread.  Launched on device
//   memory it is the device form, which the public device-tensor
//   wrappers (the JAX package's API) take.  Launched on the device
//   aliases of the caller's PINNED host words and readback it is the
//   mapped form: a served chunk past kMaxLanes lanes (warmup, bursts,
//   wide requests) is one device activity, with no upload, no device
//   buffer and no readback copy.
// - the by-value form, unique_step_lanes_kernel (by_value.cuh): at most
//   kMaxLanes lanes (banks x cap) ride in the launch's parameters, one
//   16-byte (slot, hits, limit, fresh) record per lane.  One block of
//   banks x cap threads, the readback into the caller's pinned host
//   memory through its device alias.
//
// The engine picks by the batch's shape alone (fixed_window.py
// lanes_by_value): by value up to kMaxLanes lanes, mapped past it.

#pragma once

#include <atomic>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "by_value.cuh"
#include "mapped.cuh"
#include "prefix_tiles.cuh"
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
  __device__ __forceinline__ uint32_t* at(uint32_t* counts, int32_t slot) const {
    const long long s = (*this)(slot);
    return s < 0 ? nullptr : counts + s;
  }
  __device__ __forceinline__ bool owns(int32_t) const { return true; }
};

struct GroupIndex {
  int num_banks;   // of the whole table
  int bank_lo;     // the group's first bank
  int banks_here;  // the group's banks: rows of its tensor
  long long slots_per_bank;
  // The group's row of `slot`'s bank, or -1 when another group holds it;
  // -2 when the id is out of the table.
  __device__ __forceinline__ int row(int32_t slot) const {
    if (slot < 0 || slot >= num_banks * slots_per_bank) {
      return -2;
    }
    const int r = slot % num_banks - bank_lo;
    return (r >= 0 && r < banks_here) ? r : -1;
  }
  __device__ __forceinline__ long long operator()(int32_t slot) const {
    const int r = row(slot);
    return r < 0 ? -1 : r * slots_per_bank + slot / num_banks;
  }
  __device__ __forceinline__ uint32_t* at(uint32_t* counts, int32_t slot) const {
    const long long s = (*this)(slot);
    return s < 0 ? nullptr : counts + s;
  }
  __device__ __forceinline__ bool owns(int32_t slot) const {
    const int r = row(slot);
    return r >= 0 || (r == -2 && bank_lo == 0);
  }
};

// The groups one card launch may carry: 256 pointers, 2 KB of the 4 KB
// a launch's parameters hold (parallel/sharded.py MAX_GROUPS refuses a
// larger mesh).
constexpr int kMaxGroups = 256;

struct CardIndex {
  uint32_t* table[kMaxGroups];  // group g's tensor on this card, else null
  int num_banks;
  int banks_per_group;          // k
  long long slots_per_bank;
  // The group of `slot`'s bank; an out-of-table id belongs to group 0.
  __device__ __forceinline__ int group(int32_t slot) const {
    if (slot < 0 || slot >= num_banks * slots_per_bank) {
      return 0;
    }
    return (slot % num_banks) / banks_per_group;
  }
  __device__ __forceinline__ uint32_t* at(uint32_t*, int32_t slot) const {
    if (slot < 0 || slot >= num_banks * slots_per_bank) {
      return nullptr;
    }
    const int b = slot % num_banks;
    const int g = b / banks_per_group;
    uint32_t* t = table[g];
    return t == nullptr
               ? nullptr
               : t + (b - g * banks_per_group) * slots_per_bank + slot / num_banks;
  }
  __device__ __forceinline__ bool owns(int32_t slot) const {
    return table[group(slot)] != nullptr;
  }
};

// The serving readback's value of one lane: the raw after (out_kind 0),
// or min(after, limit + hits) -- the cap is modular, as the reference's
// -- which the caller truncates to uint8 (1) or uint16 (2).
__device__ __forceinline__ uint32_t readback_of(uint32_t after, uint32_t cap,
                                                int out_kind) {
  return (out_kind == 0 || after < cap) ? after : cap;
}

// Entry `lane` of the readback `out`: the value `v`, truncated to the
// out_kind's width.
__device__ __forceinline__ void store_readback(void* out, long long lane,
                                               uint32_t v, int out_kind) {
  if (out_kind == 0) {
    static_cast<uint32_t*>(out)[lane] = v;
  } else if (out_kind == 1) {
    static_cast<uint8_t*>(out)[lane] = static_cast<uint8_t>(v);
  } else {
    static_cast<uint16_t*>(out)[lane] = static_cast<uint16_t>(v);
  }
}

__device__ __forceinline__ void write_readback(void* out, long long lane,
                                               uint32_t after, uint32_t cap,
                                               int out_kind) {
  store_readback(out, lane, readback_of(after, cap, out_kind), out_kind);
}

// serve_lane's two halves, so that a thread serving several lanes can
// issue every gather before its first store (unique_step_rows_kernel): the count
// before the add at `slot` (-1: inert; a fresh lane reads 0), and the
// saturating add.
__device__ __forceinline__ uint32_t lane_before(const uint32_t* counts,
                                                long long slot, bool fresh) {
  return (slot >= 0 && !fresh) ? counts[slot] : 0u;
}

__device__ __forceinline__ uint32_t lane_after(uint32_t before, uint32_t hits) {
  const uint32_t after = before + hits;
  return after < before ? kU32Max : after;  // one u32 add wraps at most once
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
  const uint32_t after = lane_after(lane_before(counts, slot, fresh), hits);
  if (slot >= 0) {
    counts[slot] = after;
  }
  write_readback(out, lane, after, limit + hits, out_kind);
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

// -- the device and mapped forms -------------------------------------------
//
// One kernel, unique_step_rows_kernel, on device memory (the device
// form) or on the device aliases of pinned host memory (the mapped
// form), in mapped.cuh's layout: kMappedLanes lanes a thread in one-warp
// blocks, the four 16-byte loads of a thread's lanes (slot, hits, limit
// and fresh rows) before any gather, every gather before any store, the
// readback as one store of kMappedLanes values.  The mapped form
// replaces, for a served chunk past kMaxLanes lanes, the device form's
// three activities (upload copy, kernel, readback copy) and the caller's
// device buffers.  Its bound is the host link: 16 B a lane in and 1-4 B
// out, about 1 us at 4096 lanes over PCIe 5.0 x16 (64 GB/s one way); in
// device memory it gathers and scatters 8 B a live lane.

// The bank rows of a one-group launch: row r's counters at counts + r x
// num_slots (K1: one row).
struct BankRows {
  uint32_t* counts;
  long long num_slots;
  __device__ __forceinline__ uint32_t* bank(long long row) const {
    return counts + row * num_slots;
  }
};

// Row blockIdx.y of the packed int32[rows, 4, n] batch at `packed` (in
// device memory, or a device alias of pinned host memory) against
// rows.bank(row), its readback into out[rows, n] (likewise),
// kMappedLanes lanes a thread.
template <class Rows>
__global__ void unique_step_rows_kernel(const __grid_constant__ Rows rows,
                                          long long num_slots,
                                          const int32_t* __restrict__ packed,
                                          int n, void* __restrict__ out,
                                          int out_kind, bool vec) {
  const int i0 = (blockIdx.x * blockDim.x + threadIdx.x) * kMappedLanes;
  if (i0 >= n) {
    return;
  }
  const long long row = blockIdx.y;
  const int32_t* p = packed + row * 4 * n + i0;
  const int m = min(kMappedLanes, n - i0);
  int32_t w[4][kMappedLanes];  // slot, hits, limit, fresh x the lanes
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    load_lanes(p + static_cast<long long>(r) * n, m, vec, w[r]);
  }
  uint32_t* counts = rows.bank(row);
  long long slot[kMappedLanes];
  uint32_t after[kMappedLanes];
#pragma unroll
  for (int j = 0; j < kMappedLanes; ++j) {
    slot[j] = j < m ? slot_index(w[0][j], num_slots) : -1;
    after[j] = lane_before(counts, slot[j], w[3][j] != 0);
  }
  uint32_t v[kMappedLanes];
#pragma unroll
  for (int j = 0; j < kMappedLanes; ++j) {
    const uint32_t hits = static_cast<uint32_t>(w[1][j]);
    after[j] = lane_after(after[j], hits);
    if (slot[j] >= 0) {
      counts[slot[j]] = after[j];
    }
    v[j] = readback_of(after[j], static_cast<uint32_t>(w[2][j]) + hits, out_kind);
  }
  const long long lane = row * n + i0;
  if (!vec) {
    for (int j = 0; j < m; ++j) {
      store_readback(out, lane + j, v[j], out_kind);
    }
  } else if (out_kind == 0) {
    *reinterpret_cast<uint4*>(static_cast<uint32_t*>(out) + lane) =
        make_uint4(v[0], v[1], v[2], v[3]);
  } else if (out_kind == 1) {
    *reinterpret_cast<uint32_t*>(static_cast<uint8_t*>(out) + lane) =
        (v[0] & 0xFFu) | (v[1] & 0xFFu) << 8 | (v[2] & 0xFFu) << 16 | v[3] << 24;
  } else {
    *reinterpret_cast<uint2*>(static_cast<uint16_t*>(out) + lane) =
        make_uint2((v[0] & 0xFFFFu) | v[1] << 16, (v[2] & 0xFFFFu) | v[3] << 16);
  }
}

// The launcher over `banks` rows of `rows`: `packed` (int32[banks, 4,
// n]) and `out` are addresses the device reads and writes, device memory
// or device aliases.  Rows whose width or address is not 16-byte aligned
// take the kernel's scalar path.
template <class Rows>
int launch_rows(const Rows& rows, long long num_slots, const void* packed,
                int banks, int n, void* out, int out_kind, cudaStream_t stream) {
  if (banks <= 0 || n <= 0) {
    return 0;
  }
  if (banks > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  unique_step_rows_kernel<Rows>
      <<<dim3(mapped_blocks(n), banks), kMappedThreads, 0, stream>>>(
          rows, num_slots, static_cast<const int32_t*>(packed), n, out, out_kind,
          mapped_vec(n, packed, out));
  return static_cast<int>(cudaGetLastError());
}

// The mapped launcher: `words` (int32[banks, 4, n]) and `out` are HOST
// addresses of pinned memory, each reached through its device alias
// (mapped_alias's error, returned and cleared, where one has none:
// pageable memory).  The kernel reads the words while it runs, so the
// caller keeps them until the stream passes it.
template <class Rows>
int launch_mapped(const Rows& rows, long long num_slots,
                  const void* words, int banks, int n, void* out,
                  int out_kind, cudaStream_t stream) {
  if (banks <= 0 || n <= 0) {
    return 0;
  }
  void* dev_words = nullptr;
  void* dev_out = nullptr;
  const cudaError_t err = mapped_aliases(words, out, &dev_words, &dev_out);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  return launch_rows(rows, num_slots, dev_words, banks, n, dev_out, out_kind, stream);
}

// The device form over `banks` banks of `counts`: `packed` and `out` in
// device memory.
int launch_unique_step(void* counts, long long num_slots, const void* packed,
                       int banks, int n, void* out, int out_kind,
                       void* stream) {
  return launch_rows(BankRows{static_cast<uint32_t*>(counts), num_slots}, num_slots,
                     packed, banks, n, out, out_kind, static_cast<cudaStream_t>(stream));
}

int launch_unique_step_mapped(void* counts, long long num_slots,
                              const void* words, int banks, int n, void* out,
                              int out_kind, void* stream) {
  return launch_mapped(
      BankRows{static_cast<uint32_t*>(counts), num_slots}, num_slots, words,
      banks, n, out, out_kind, static_cast<cudaStream_t>(stream));
}

// -- the general step: one cooperative launch ----------------------------
//
// general_step_kernel replaces, in one launch,
//   ratelimit_tpu/models/fixed_window.py:247 update (+ :108
//   step_counters_compact's narrow readback) and :294 decision_block
//   (WrappedIndex: K3 update and K3 decide), and
//   ratelimit_tpu/parallel/sharded.py:270 _bank_core with _bank_update,
//   step_counters_compact and _bank_step (GroupIndex: K7 on a group of
//   every bank; CardIndex: K7 on the groups one card holds).  Each lane
//   has one owner bank, so the psum is the owner's write of that lane
//   (sharded.cu says how the cards of a mesh write theirs).
//
// What bounds it.  About 14 B in per lane (slot, hits, fresh, limit,
// shadow), 8 B gathered and scattered per distinct slot and at most 33 B
// out per lane: 0.2 MB at N = 4096, 0.06 us at 3.35 TB/s, and the prefix
// needs no more than a sort's N log N operations.  So the bytes set the
// bound, and at the engine's batch sizes every launch costs more than
// the work (about 1.2 us on an H100).  A fresh lane zeroes its slot for
// EVERY lane of that slot, earlier duplicates included, so every zero
// must land before any gather and every gather before any add; the
// prefix's atomics must all land before any lane reads its sum.  Kept by
// stream order alone, that takes five launches and a memset (zero,
// gather, K2's memset and pass, add, decide), each near the cost of a
// launch, and the host's time to enqueue all six.
//
// The design.  One cooperative launch (cudaLaunchCooperativeKernel; a
// kernel that calls grid.sync() must never be launched with <<<>>>)
// of a persistent grid: at most the blocks the card holds at once
// (occupancy x SMs), never more than the tile pairs.  Blocks of kTile
// threads walk the lanes and K2's tile pairs grid-stride, so any N >= 1
// runs in one launch, and two grid barriers carry the three hazards:
//
//   A. zero the fresh lanes' slots; zero the prefix scratch `incl`;
//   -- grid.sync() --
//   B. gather each lane's before into `afters`; K2's triangular tile
//      pass (prefix_tiles.cuh, the code the standalone K2 runs) adds
//      into `incl` with modular atomics;
//   -- grid.sync() --
//   C. after = before + incl (modular), modular atomicAdd of the hits
//      into the table, then the epilogue.
//
// A lane is served by one thread in every phase, so `afters` needs no
// barrier between a lane's gather and its add.  What a barrier costs
// beside a launch, and what the grid's size does to it, PERF.md has as
// measured (scripts/torch_forward_step.py).  The prefix's work still
// grows as N^2 (K2, prefix.cu).

namespace cg = cooperative_groups;

// The decision block of one lane (limiter/base.py formulas; reference
// base_limiter.go:76-179), branch-free: the nine fields of lane i of
// out[8, n] (codes, limit_remaining, befores, afters, over_limit,
// near_limit, within_limit, shadow_mode) and set_lc[n].  The near-limit
// threshold is floorf(__fmul_rn(limit, ratio)), so that nvcc cannot
// contract it with anything else.  The standalone fw_decision_block
// kernel and the fused epilogue both call it, so the two are bit-equal.
__device__ __forceinline__ void decide_lane(uint32_t after, uint32_t h,
                                            uint32_t limit, bool shadow,
                                            float near_ratio,
                                            uint32_t* __restrict__ out,
                                            long long n, long long i,
                                            uint8_t* __restrict__ set_lc) {
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
  const bool shadowed = over && shadow;

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

// The epilogues; the first three are the out_kind of write_readback.
enum Epilogue : int { kAfters = 0, kNarrow8 = 1, kNarrow16 = 2, kDecide = 3 };

struct GeneralStep {
  uint32_t* counts;
  const int32_t* slots;
  const uint32_t* hits;
  const uint8_t* fresh;
  const uint32_t* limits;  // kNarrow8, kNarrow16, kDecide
  const uint8_t* shadow;   // kDecide
  float near_ratio;        // kDecide
  uint32_t* afters;  // [n]: the gathered befores
  uint32_t* incl;    // [n]: the prefix scratch
  void* out;         // kAfters: u32[n] (may be `afters`); kNarrow8/16:
                     // u8/u16[n]; kDecide: u32[8, n]
  uint8_t* set_lc;   // kDecide: [n]
  int n;
  long long pairs;   // tile_pairs(n)
  bool aligned;      // tiles_aligned(slots, hits)
};

// `counts`, `afters` and `incl` are written and read again across the
// barriers, so they carry no __restrict__ (no read-only loads).  The
// index is a __grid_constant__: CardIndex's table is indexed per lane in
// place, never copied to local memory.
template <class Index, int kEpilogue>
__global__ void __launch_bounds__(kTile)
    general_step_kernel(const GeneralStep p, const __grid_constant__ Index index) {
  cg::grid_group grid = cg::this_grid();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;

  for (long long i = first; i < p.n; i += stride) {  // A
    if (p.fresh[i]) {
      uint32_t* cell = index.at(p.counts, p.slots[i]);
      if (cell != nullptr) {
        *cell = 0u;
      }
    }
    p.incl[i] = 0u;
  }
  grid.sync();

  for (long long i = first; i < p.n; i += stride) {  // B
    const uint32_t* cell = index.at(p.counts, p.slots[i]);
    p.afters[i] = cell != nullptr ? *cell : 0u;
  }
  prefix_tile_pass(p.slots, p.hits, p.incl, p.n, p.pairs, p.aligned);
  grid.sync();

  for (long long i = first; i < p.n; i += stride) {  // C
    const uint32_t h = p.hits[i];
    const uint32_t after = p.afters[i] + p.incl[i];
    const int32_t id = p.slots[i];
    uint32_t* cell = index.at(p.counts, id);
    if (cell != nullptr) {
      atomicAdd(cell, h);
    }
    if (!index.owns(id)) {
      continue;  // another card's (or group's) lane: written there
    }
    if constexpr (kEpilogue == kDecide) {
      decide_lane(after, h, p.limits[i], p.shadow[i] != 0, p.near_ratio,
                  static_cast<uint32_t*>(p.out), p.n, i, p.set_lc);
    } else {
      write_readback(p.out, i, after, kEpilogue == kAfters ? 0u : p.limits[i] + h,
                     kEpilogue);
    }
  }
}

constexpr int kMaxDevices = 64;

// One cooperative launch of general_step_kernel<Index, kEpilogue> on
// `stream`: its grid is min(tile pairs, co-resident blocks).  The
// co-resident count (and whether the card takes cooperative launches at
// all) is asked once per device.  Returns the launch's error, and clears
// it, so that a refused launch does not surface in a later call.
template <class Index, int kEpilogue>
int launch_general(const GeneralStep& p, const Index& index,
                   cudaStream_t stream) {
  static std::atomic<int> coresident[kMaxDevices];  // 0 = not yet asked
  const void* kernel =
      reinterpret_cast<const void*>(general_step_kernel<Index, kEpilogue>);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  int blocks = dev < kMaxDevices ? coresident[dev].load() : 0;
  if (blocks == 0) {
    int cooperative = 0, per_sm = 0, sms = 0;
    err = cudaDeviceGetAttribute(&cooperative, cudaDevAttrCooperativeLaunch,
                                 dev);
    if (err == cudaSuccess && !cooperative) {
      err = cudaErrorNotSupported;
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kTile, 0);
    }
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err != cudaSuccess) {
      cudaGetLastError();
      return static_cast<int>(err);
    }
    blocks = per_sm * sms;
    if (dev < kMaxDevices) {
      coresident[dev].store(blocks);
    }
  }
  const int grid =
      static_cast<int>(p.pairs < blocks ? p.pairs : static_cast<long long>(blocks));
  GeneralStep params = p;
  Index idx = index;
  void* args[] = {&params, &idx};
  err = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kTile), args, 0,
                                    stream);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// The C entries' body: the general step of n lanes with epilogue
// `epilogue` (Epilogue), in one launch.  `afters` and `incl` are int32[n]
// of scratch (kAfters: `out` may be `afters`); the pointers an epilogue
// does not read may be null.
template <class Index>
int launch_general_step(void* counts, const Index& index, const void* slots,
                        const void* hits, const void* fresh,
                        const void* limits, const void* shadow,
                        float near_ratio, void* afters, void* incl, void* out,
                        void* set_lc, int epilogue, int n, void* stream) {
  if (n <= 0) {
    return 0;
  }
  const GeneralStep p{static_cast<uint32_t*>(counts),
                      static_cast<const int32_t*>(slots),
                      static_cast<const uint32_t*>(hits),
                      static_cast<const uint8_t*>(fresh),
                      static_cast<const uint32_t*>(limits),
                      static_cast<const uint8_t*>(shadow),
                      near_ratio,
                      static_cast<uint32_t*>(afters),
                      static_cast<uint32_t*>(incl),
                      out,
                      static_cast<uint8_t*>(set_lc),
                      n,
                      tile_pairs(n),
                      tiles_aligned(slots, hits)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (epilogue) {
    case kAfters:
      return launch_general<Index, kAfters>(p, index, s);
    case kNarrow8:
      return launch_general<Index, kNarrow8>(p, index, s);
    case kNarrow16:
      return launch_general<Index, kNarrow16>(p, index, s);
    case kDecide:
      return launch_general<Index, kDecide>(p, index, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
