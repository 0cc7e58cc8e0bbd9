// Bank-sharded fixed-window counter kernels for Hopper (sm_90a).
//
// The table is uint32 laid out (num_banks, slots_per_bank), bank-major
// (the caller stores it as int32 of the same bits).  The JAX model puts
// one bank on each chip of a mesh and recombines per-lane answers with a
// psum.  The port places the banks in GROUPS (parallel/sharded.py Mesh):
// group g holds the contiguous banks [g k, (g + 1) k) as one (k,
// slots_per_bank) tensor on its own device, and one group may hold every
// bank.  The kernels are those of the single table (counter_update.cuh),
// under another index policy or with a bank per blockIdx.y, plus
// sharded_combine, which stands in for the psum where a card cannot map
// the home card's memory.
//
// K6 rl_sharded_routed_step replaces the routed unique step
//   ratelimit_tpu/parallel/sharded.py:184-227
//   step_counters_unique_routed_packed -> _bank_unique (:229-266).
// The host routes each unique slot to its bank and hands over one packed
// int32[num_banks, 4, cap] batch of LOCAL ids (padding ids
// slots_per_bank + i).  One launch serves every bank of a group (the
// batch's rows of that group), no atomics (slots are unique within a
// bank): in the device form (rl_sharded_routed_step) and the mapped form
// (rl_sharded_routed_step_mapped, the engine's form past 128 lanes)
// unique_step_rows_kernel, a bank per blockIdx.y and 4 lanes a thread,
// over the batch in device memory or read from pinned host words through
// their device alias, the readback likewise; in the by-value form
// (rl_sharded_routed_step_lanes, num_banks x cap <= 128, so 8 banks up to
// cap 16) one block of num_banks x cap threads over the batch carried in
// the launch's parameters, the readback into mapped
// pinned memory (counter_update.cuh).  Local ids follow JAX's index
// semantics at width slots_per_bank.  The add saturates; the readback is
// K1's.  Bound: 16 B in, 4 B gathered, 4 B written and <= 4 B out per
// routed lane, padding included -- about 0.1 MB for 4096 lanes over 8
// banks, so the launch latency bounds the device form, as it bounds K1;
// the mapped form moves the 16 B in and the readback over the host link
// (64 GB/s one way on PCIe 5.0 x16), about 1 us at 4096 lanes.  The TPU's
// 128-wide row gather (sharded.py:239-253) is a TPU layout trick and has
// no counterpart.
//
// The host routes by bank, so K6 needs no collective.  On a mesh of one
// group the entries above serve every bank.  Over several groups K6 has a
// CARD form: one launch over the banks of every group a card holds, its
// group tables reached through a table-pointer array as CardIndex reaches
// K7's (rl_sharded_routed_card_step, device form: a block row a bank
// held, the card's rows int32[held x k, 4, cap] of the batch;
// rl_sharded_routed_card_step_lanes, by value: one block of held x k x
// cap <= 128 threads, each lane-row's bank base in the parameters beside
// its record; rl_sharded_routed_card_step_mapped: the mapped form over
// the card's rows of the batch in pinned host memory).  Each lane runs serve_lane, the K1 / K6 body, so a card
// computes exactly what _bank_unique (sharded.py:229-266) computes for
// each of its banks.  Bound: as K6's, per routed lane.
//
// The mesh entries enqueue every card's work in ONE host call, the
// counterpart of JAX's single SPMD dispatch over the mesh
// (jax.jit(shard_map(...)), sharded.py:184-227 and :270-324).  Each takes
// per-card arrays (device ordinal, stream, launch arguments, the event to
// record), sets each card's device in turn, enqueues that card's work,
// and puts the caller's device back; it returns the first error and
// writes the index of the card that raised it into *failed (-1 for
// none).  Cards run in parallel, each on its own stream.
//
// - rl_mesh_routed_step_lanes / rl_mesh_routed_step_mapped: K6's card
//   form on every card, by value or mapped (the engine's two forms: each
//   card's batch and readback in that card's pinned staging), then the
//   card's event; rl_mesh_routed_step: the device form on every card,
//   its batch and readback in the card's memory (the model's
//   device-tensor API).
// - rl_mesh_card_step: K7's card step on every card whose lanes reach the
//   home output in place or through a peer mapping ("home" and "peer",
//   parallel/sharded.py Mesh.links).  A card past the home one waits on
//   an event recorded on the home stream at entry (the lanes and the
//   output are ready), takes ONE cudaMemcpyPeerAsync of the lanes' bytes
//   where the caller gives it a destination, and launches; the home
//   stream then waits on every such card's event, so the output is read,
//   and the home card's buffers are reused, only after every card's
//   stores.  Those events live inside the call.
//
// K7 replaces the general update _bank_core (sharded.py:270-302) and
// _bank_update, step_counters_compact and _bank_step (:116-141,304-324)
// over a replicated batch of GLOBAL ids, with the psum (:306,322) that
// sums the chips' answers.  It is K3's general step under another index
// policy, one cooperative launch (general_step_kernel, counter_update.cuh,
// says what bounds it), with the raw afters, the narrow u8/u16 readback
// min(after, limit + hits) or the decision block as its epilogue.  Two
// entries:
//
// - rl_sharded_group_step, on a group of every bank under GroupIndex:
//   the one-group mesh, where every lane is the group's own.
// - rl_sharded_card_step, ONE launch a card over every group the card
//   holds, under CardIndex: the launch zeroes, gathers and scatters only
//   the lanes of its own groups' banks; an out-of-table lane (negative
//   ids included: they never wrap here) reads a virtual zero and scatters
//   nowhere.  The per-slot prefix runs once a card, on the raw global
//   ids over the whole replicated batch, as every chip of the JAX mesh
//   does.  The card writes its OWNED lanes -- its groups' ids, and the
//   out-of-table ones where it holds group 0 -- and nothing else.  Each
//   lane has exactly one owner card, so JAX's psum is that card's store
//   of the lane into the one output on the home device (the first
//   group's): the home card's launch stores in place, another card's
//   through the peer mapping rl_enable_peer made at mesh build.  Groups
//   that all lie on one card need one launch, no partial, copy or
//   combine.
//
//   What bounds it.  Bytes, as the one-group step: about 14 B in a lane
//   (slot, hits, fresh, limit, shadow), 8 B gathered and scattered a
//   distinct slot the card holds, up to 33 B out a lane -- 0.2 MB at
//   N = 4096, 0.06 us at 3.35 TB/s -- so at the engine's batch sizes the
//   launch and its two grid barriers set the time, as they set the
//   one-group step's.  The design pays them once a card, not once a
//   group; cards run in parallel, each on its own stream, and a lane
//   crosses NVLink once, to its owner's store, instead of a partial of
//   33 B x N a group, a copy of it and a select.  The tables ride in the
//   launch's parameters (kMaxGroups pointers, a __grid_constant__), so
//   no pointer array is uploaded.
//
// sharded_combine, rl_sharded_combine, replaces the psum where a card
// cannot map the home card's memory (the mesh says so at build, from the
// topology).  The home card and every mapped card store their owned lanes
// into the one home output in place, as with no combine.  Each card that
// cannot ("combine") runs its card step into ONE partial of the
// output's layout on its own card, which goes home in ONE
// copy: partials[cards, stride] on the home device.  Then one launch
// copies, for each lane whose owner group lies on a combine card, that
// lane's fields from the card's partial into the home output.  The owner
// is the group of bank s % num_banks for an in-table id s, found with
// 32-bit arithmetic, and a group -> source table (kMaxGroups bytes: 0 the
// home output, c + 1 partial c) rides in the launch's parameters; an id
// outside the table is group 0's, which the home card holds, so its lane
// is already in place.  No other lane or row is read, so nothing needs
// zeros: the select is JAX's sum of one owner's share.  A layout is
// rows32 rows of u32[n], then rows16 rows of u16[n], then rows8 rows of
// u8[n] -- the afters 1/0/0, the u16 readback 0/1/0, the u8 readback
// 0/0/1, the decision block 8/0/1 (set_local_cache its u8 row).  One
// lane a thread in one-warp blocks, every row gathered before any store:
// at 4096 lanes that took 1.73 us on an H100 against 5.15 for 4 lanes a
// thread moving each row's lanes as one 16-, 8- or 4-byte word (the
// owners of 4 adjacent lanes differ, so most words are blended lane by
// lane, with a quarter of the threads in flight; scripts/torch_combine.cu
// keeps that variant).
// Bound: bytes, and only the lanes a combine card owns move: the ids in,
// and each such lane's fields read from its partial and written home --
// about 0.14 MB for the decision block of 4096 lanes half of which a
// combine card owns, 0.04 us at 3.35 TB/s, so the launch bounds it.

#include <cstdint>
#include <cuda_runtime.h>

#include "counter_update.cuh"

extern "C" int rl_sharded_routed_step(void* counts, long long slots_per_bank,
                                      const void* packed, int num_banks,
                                      int cap, void* out, int out_kind,
                                      void* stream) {
  return launch_unique_step(counts, slots_per_bank, packed, num_banks, cap, out,
                            out_kind, stream);
}

extern "C" int rl_sharded_routed_step_lanes(void* counts,
                                            long long slots_per_bank,
                                            const void* words, int num_banks,
                                            int cap, void* out, int out_kind,
                                            void* stream) {
  return launch_unique_step_lanes(counts, slots_per_bank, words, num_banks,
                                  cap, out, out_kind, stream);
}

// `words` (int32[num_banks, 4, cap]) and `out` are host addresses of
// pinned memory.
extern "C" int rl_sharded_routed_step_mapped(void* counts,
                                             long long slots_per_bank,
                                             const void* words, int num_banks,
                                             int cap, void* out, int out_kind,
                                             void* stream) {
  return launch_unique_step_mapped(counts, slots_per_bank, words, num_banks,
                                   cap, out, out_kind, stream);
}

namespace {

// -- K6's card form --------------------------------------------------------

// The group tables of one card, in the order of its rows of the batch:
// held group h holds the card's bank rows [h k, (h + 1) k).
struct CardTables {
  uint32_t* table[kMaxGroups];
  int banks_per_group;  // k
  long long slots_per_bank;
  // Bank row `row` of the card's batch: row - h k of held group h.
  __device__ __forceinline__ uint32_t* bank(long long row) const {
    const int h = static_cast<int>(row / banks_per_group);
    return table[h] + (row - static_cast<long long>(h) * banks_per_group) * slots_per_bank;
  }
};

// The card's tables into *t; false where held x k does not fit a launch.
bool card_tables(const void* tables, int held, int banks_per_group,
                 long long slots_per_bank, CardTables* t) {
  if (held < 1 || held > kMaxGroups || banks_per_group < 1 ||
      static_cast<long long>(held) * banks_per_group > 65535) {
    return false;
  }
  for (int h = 0; h < held; ++h) {
    t->table[h] = static_cast<uint32_t* const*>(tables)[h];
  }
  t->banks_per_group = banks_per_group;
  t->slots_per_bank = slots_per_bank;
  return true;
}

int launch_routed_card(const void* tables, int held, int banks_per_group,
                       long long slots_per_bank, const void* packed, int cap,
                       void* out, int out_kind, cudaStream_t stream) {
  CardTables t{};
  if (!card_tables(tables, held, banks_per_group, slots_per_bank, &t)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_rows(t, slots_per_bank, packed, held * banks_per_group, cap, out,
                     out_kind, stream);
}

// Mapped (counter_update.cuh): `words` is the HOST address of the card's
// pinned int32[held x k, 4, cap] batch, `out` of its pinned readback.
int launch_routed_card_mapped(const void* tables, int held, int banks_per_group,
                              long long slots_per_bank, const void* words,
                              int cap, void* out, int out_kind,
                              cudaStream_t stream) {
  CardTables t{};
  if (!card_tables(tables, held, banks_per_group, slots_per_bank, &t)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_mapped(t, slots_per_bank, words, held * banks_per_group, cap,
                       out, out_kind, stream);
}

// By value (by_value.cuh): a bank base and a 16 B record a lane-row, so
// 8 B x 128 + 16 B x 128 = 3 KB of parameters.
struct CardLaneBatch {
  uint32_t* bank[kMaxLanes];  // bank row r's counters; rows past held x k unset
  void* out;                  // device alias of the caller's pinned readback
  long long num_slots;        // slots per bank
  int cap;                    // lanes per bank
  int lanes;                  // held x k x cap; records past it are never read
  int out_kind;
  int4 lane[kMaxLanes];       // lane t = row * cap + i: (slot, hits, limit, fresh)
};

static_assert(sizeof(CardLaneBatch) <= kParamBytes,
              "the by-value card batch must fit the 4 KB parameter space");

__global__ void routed_card_lanes_kernel(const __grid_constant__ CardLaneBatch b) {
  const int t = threadIdx.x;
  if (t >= b.lanes) {
    return;
  }
  const int4 l = b.lane[t];
  serve_lane(b.bank[t / b.cap], b.num_slots, l.x, static_cast<uint32_t>(l.y),
             static_cast<uint32_t>(l.z), l.w != 0, b.out, t, b.out_kind);
}

// `words` is the HOST address of the card's int32[held x k, 4, cap]
// batch, copied into the launch; `out` the host address of pinned memory.
int launch_routed_card_lanes(const void* tables, int held, int banks_per_group,
                             long long slots_per_bank, const void* words,
                             int cap, void* out, int out_kind,
                             cudaStream_t stream) {
  if (held < 1 || banks_per_group < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (cap <= 0) {
    return 0;
  }
  const long long rows = static_cast<long long>(held) * banks_per_group;
  if (rows * cap > kMaxLanes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CardLaneBatch b;
  const cudaError_t err = mapped_alias(out, &b.out);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  uint32_t* const* t = static_cast<uint32_t* const*>(tables);
  for (int r = 0; r < rows; ++r) {
    b.bank[r] = t[r / banks_per_group] + (r % banks_per_group) * slots_per_bank;
  }
  b.num_slots = slots_per_bank;
  b.cap = cap;
  b.lanes = static_cast<int>(rows) * cap;
  b.out_kind = out_kind;
  const int32_t* w = static_cast<const int32_t*>(words);
  for (int r = 0; r < rows; ++r) {
    const int32_t* rw = w + r * 4 * cap;
    for (int i = 0; i < cap; ++i) {
      b.lane[r * cap + i] =
          make_int4(rw[i], rw[cap + i], rw[2 * cap + i], rw[3 * cap + i]);
    }
  }
  routed_card_lanes_kernel<<<1, lane_threads(b.lanes), 0, stream>>>(b);
  return static_cast<int>(cudaGetLastError());
}

// -- the mesh entries' frame ----------------------------------------------

// Runs card(i) under each card's device in turn (devices[i]), stopping at
// the first error, whose card goes into *failed; puts the caller's device
// back.
template <class Card>
int each_card(int cards, const int* devices, int* failed, Card card) {
  *failed = -1;
  if (cards < 1 || cards > kMaxDevices) {
    *failed = 0;
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) {
    *failed = 0;
    return static_cast<int>(err);
  }
  int rc = 0;
  for (int i = 0; i < cards && rc == 0; ++i) {
    err = cudaSetDevice(devices[i]);
    rc = err != cudaSuccess ? static_cast<int>(err) : card(i);
    if (rc != 0) {
      *failed = i;
    }
  }
  err = cudaSetDevice(current);
  if (rc == 0 && err != cudaSuccess) {
    *failed = 0;
    rc = static_cast<int>(err);
  }
  return rc;
}

int record(const void* events, int i, cudaStream_t stream) {
  if (events == nullptr) {
    return 0;
  }
  cudaEvent_t ev = static_cast<const cudaEvent_t*>(events)[i];
  return ev == nullptr ? 0 : static_cast<int>(cudaEventRecord(ev, stream));
}

// -- the combine -----------------------------------------------------------

// One-warp blocks of one lane a thread (timed against 4 lanes a thread by
// scripts/torch_combine.py: 1.73 and 5.15 us at 4096 lanes), and the most
// rows of each width a layout has (the decision block's eight u32 fields,
// one u8 row).
constexpr int kCombineThreads = 32;
constexpr int kCombineRows32 = 8;
constexpr int kCombineRows16 = 1;
constexpr int kCombineRows8 = 1;

struct CombineArgs {
  uint8_t* out;             // the home output, written in place
  const uint8_t* partials;  // u8[cards, stride] on the home device
  const int32_t* slots;
  long long stride;
  uint32_t in_table;        // ids in [0, in_table) are in the table
  uint32_t num_banks;
  uint32_t banks_per_group;
  int n;
  int rows32, rows16, rows8;
  uint8_t source[kMaxGroups];  // group g's lanes: 0 in out, c + 1 in partial c
};

// Where lane id s's fields lie: 0 the home output, c + 1 partial c.
__device__ __forceinline__ int combine_source(const CombineArgs& a, int32_t s) {
  const uint32_t u = static_cast<uint32_t>(s);
  return (s >= 0 && u < a.in_table) ? a.source[(u % a.num_banks) / a.banks_per_group] : 0;
}

// Lane i, where a combine card owns it, takes its fields from that
// card's partial: every row gathered before any is stored.
__global__ void combine_kernel(const __grid_constant__ CombineArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) {
    return;
  }
  const int src = combine_source(a, a.slots[i]);
  if (src == 0) {
    return;
  }
  const uint8_t* part = a.partials + (src - 1) * a.stride;
  const long long w = a.n;
  const long long at16 = 4 * a.rows32 * w;
  const long long at8 = at16 + 2 * a.rows16 * w;
  uint32_t v32[kCombineRows32];
  uint16_t v16[kCombineRows16];
  uint8_t v8[kCombineRows8];
#pragma unroll
  for (int r = 0; r < kCombineRows32; ++r) {
    if (r < a.rows32) {
      v32[r] = reinterpret_cast<const uint32_t*>(part)[r * w + i];
    }
  }
#pragma unroll
  for (int r = 0; r < kCombineRows16; ++r) {
    if (r < a.rows16) {
      v16[r] = reinterpret_cast<const uint16_t*>(part + at16)[r * w + i];
    }
  }
#pragma unroll
  for (int r = 0; r < kCombineRows8; ++r) {
    if (r < a.rows8) {
      v8[r] = part[at8 + r * w + i];
    }
  }
#pragma unroll
  for (int r = 0; r < kCombineRows32; ++r) {
    if (r < a.rows32) {
      reinterpret_cast<uint32_t*>(a.out)[r * w + i] = v32[r];
    }
  }
#pragma unroll
  for (int r = 0; r < kCombineRows16; ++r) {
    if (r < a.rows16) {
      reinterpret_cast<uint16_t*>(a.out + at16)[r * w + i] = v16[r];
    }
  }
#pragma unroll
  for (int r = 0; r < kCombineRows8; ++r) {
    if (r < a.rows8) {
      a.out[at8 + r * w + i] = v8[r];
    }
  }
}

// rl_sharded_combine's arguments into *a; false where they do not fit
// (see the entry).
bool combine_args(void* out, const void* partials, long long stride, int cards,
                  const void* sources, int groups, const void* slots, int num_banks,
                  long long slots_per_bank, int rows32, int rows16, int rows8, int n,
                  CombineArgs* a) {
  const long long lane_bytes = 4LL * rows32 + 2LL * rows16 + rows8;
  if (groups < 1 || groups > kMaxGroups || num_banks < 1 || num_banks % groups != 0 ||
      cards < 1 || cards > 255 || rows32 < 0 || rows32 > kCombineRows32 || rows16 < 0 ||
      rows16 > kCombineRows16 || rows8 < 0 || rows8 > kCombineRows8 || lane_bytes < 1 ||
      stride < lane_bytes * n || stride % 4 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(partials) % 4 != 0) {
    return false;
  }
  const int* src = static_cast<const int*>(sources);
  if (src[0] != 0) {
    return false;  // group 0, and the out-of-table lanes, are the home card's
  }
  for (int g = 0; g < groups; ++g) {
    if (src[g] < 0 || src[g] > cards) {
      return false;
    }
    a->source[g] = static_cast<uint8_t>(src[g]);
  }
  const long long num_slots = static_cast<long long>(num_banks) * slots_per_bank;
  a->out = static_cast<uint8_t*>(out);
  a->partials = static_cast<const uint8_t*>(partials);
  a->slots = static_cast<const int32_t*>(slots);
  a->stride = stride;
  a->in_table = static_cast<uint32_t>(num_slots < 0x80000000LL ? num_slots : 0x80000000LL);
  a->num_banks = static_cast<uint32_t>(num_banks);
  a->banks_per_group = static_cast<uint32_t>(num_banks / groups);
  a->n = n;
  a->rows32 = rows32;
  a->rows16 = rows16;
  a->rows8 = rows8;
  return true;
}

static_assert(sizeof(CombineArgs) <= kParamBytes,
              "the combine's arguments must fit the 4 KB parameter space");

}  // namespace

extern "C" int rl_sharded_group_step(
    void* counts, int num_banks, int bank_lo, int banks_here,
    long long slots_per_bank, const void* slots, const void* hits,
    const void* fresh, const void* limits, const void* shadow,
    float near_ratio, void* afters, void* incl, void* out, void* set_lc,
    int epilogue, int n, void* stream) {
  if (bank_lo < 0 || banks_here < 1 || bank_lo + banks_here > num_banks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_general_step(
      counts, GroupIndex{num_banks, bank_lo, banks_here, slots_per_bank},
      slots, hits, fresh, limits, shadow, near_ratio, afters, incl, out,
      set_lc, epilogue, n, stream);
}

// One launch of K7 on one card: `tables` is the HOST array of the mesh's
// `groups` table pointers, null for a group on another card (at least one
// is this card's), its values carried into the launch's parameters.  The
// owned lanes' fields land in `out` (and set_lc); `out` may lie on another
// card that this card maps.  `afters` and `incl` are int32[n] of scratch on this card.
extern "C" int rl_sharded_card_step(
    const void* tables, int groups, int num_banks, long long slots_per_bank,
    const void* slots, const void* hits, const void* fresh, const void* limits,
    const void* shadow, float near_ratio, void* afters, void* incl, void* out,
    void* set_lc, int epilogue, int n, void* stream) {
  if (groups < 1 || groups > kMaxGroups || num_banks % groups != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CardIndex index{};
  bool any = false;
  for (int g = 0; g < groups; ++g) {
    index.table[g] = static_cast<uint32_t* const*>(tables)[g];
    any = any || index.table[g] != nullptr;
  }
  if (!any) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  index.num_banks = num_banks;
  index.banks_per_group = num_banks / groups;
  index.slots_per_bank = slots_per_bank;
  return launch_general_step(nullptr, index, slots, hits, fresh, limits,
                             shadow, near_ratio, afters, incl, out, set_lc,
                             epilogue, n, stream);
}

// -- K6's card form: one card, and every card in one call -----------------

// One launch of K6 over the banks of every group one card holds: `tables`
// is the HOST array of the card's `held` group tables (each int32[k,
// slots_per_bank]), `packed` the card's int32[held x k, 4, cap] rows of
// the batch in device memory, `out` [held x k, cap].
extern "C" int rl_sharded_routed_card_step(const void* tables, int held,
                                           int banks_per_group,
                                           long long slots_per_bank,
                                           const void* packed, int cap,
                                           void* out, int out_kind,
                                           void* stream) {
  return launch_routed_card(tables, held, banks_per_group, slots_per_bank,
                            packed, cap, out, out_kind,
                            static_cast<cudaStream_t>(stream));
}

// The same by value: `words` in host memory, `out` pinned host memory.
extern "C" int rl_sharded_routed_card_step_lanes(const void* tables, int held,
                                                 int banks_per_group,
                                                 long long slots_per_bank,
                                                 const void* words, int cap,
                                                 void* out, int out_kind,
                                                 void* stream) {
  return launch_routed_card_lanes(tables, held, banks_per_group,
                                  slots_per_bank, words, cap, out, out_kind,
                                  static_cast<cudaStream_t>(stream));
}

// The same mapped: `words` and `out` pinned host memory.
extern "C" int rl_sharded_routed_card_step_mapped(const void* tables, int held,
                                                  int banks_per_group,
                                                  long long slots_per_bank,
                                                  const void* words, int cap,
                                                  void* out, int out_kind,
                                                  void* stream) {
  return launch_routed_card_mapped(tables, held, banks_per_group,
                                   slots_per_bank, words, cap, out, out_kind,
                                   static_cast<cudaStream_t>(stream));
}

namespace {

// Runs `launch` (one of the launch_routed_card* launchers) on every card
// of a mesh, with card i's slice of `tables`, batch[i] and outs[i], then
// records events[i]: the frame of the three mesh entries of K6.
template <class Launch>
int mesh_routed(int cards, const void* devices, const void* streams,
                const void* tables, const void* held, int banks_per_group,
                long long slots_per_bank, const void* batch, int cap,
                const void* outs, int out_kind, const void* events, void* failed,
                Launch launch) {
  const int* h = static_cast<const int*>(held);
  void* const* t = static_cast<void* const*>(tables);
  int first[kMaxDevices + 1] = {0};
  for (int i = 0; i < cards && i < kMaxDevices; ++i) {
    first[i + 1] = first[i] + h[i];
  }
  return each_card(
      cards, static_cast<const int*>(devices), static_cast<int*>(failed),
      [&](int i) {
        cudaStream_t s = static_cast<cudaStream_t const*>(streams)[i];
        int rc = launch(t + first[i], h[i], banks_per_group, slots_per_bank,
                        static_cast<void* const*>(batch)[i], cap,
                        static_cast<void* const*>(outs)[i], out_kind, s);
        return rc != 0 ? rc : record(events, i, s);
      });
}

}  // namespace

// K6's card form by value on every card of a mesh, in one call.  Per card
// i: devices[i] (int), streams[i], held[i] (int) group tables -- card i's
// are tables[held[0] + ... + held[i - 1] ...] --, words[i] (host) and
// outs[i] (pinned host), and events[i] recorded after the launch (the
// array, or an entry, may be null).
extern "C" int rl_mesh_routed_step_lanes(
    int cards, const void* devices, const void* streams, const void* tables,
    const void* held, int banks_per_group, long long slots_per_bank,
    const void* words, int cap, const void* outs, int out_kind,
    const void* events, void* failed) {
  return mesh_routed(cards, devices, streams, tables, held, banks_per_group,
                     slots_per_bank, words, cap, outs, out_kind, events, failed,
                     launch_routed_card_lanes);
}

// K6's card form mapped on every card of a mesh, in one call: as
// rl_mesh_routed_step_lanes, words[i] and outs[i] card i's pinned staging
// (the batch read, the readback written, through their device aliases).
extern "C" int rl_mesh_routed_step_mapped(
    int cards, const void* devices, const void* streams, const void* tables,
    const void* held, int banks_per_group, long long slots_per_bank,
    const void* words, int cap, const void* outs, int out_kind,
    const void* events, void* failed) {
  return mesh_routed(cards, devices, streams, tables, held, banks_per_group,
                     slots_per_bank, words, cap, outs, out_kind, events, failed,
                     launch_routed_card_mapped);
}

// K6's card form in the device form on every card, in one call: as
// rl_mesh_routed_step_lanes, with packed[i] and outs[i] in card i's
// memory.
extern "C" int rl_mesh_routed_step(
    int cards, const void* devices, const void* streams, const void* tables,
    const void* held, int banks_per_group, long long slots_per_bank,
    const void* packed, int cap, const void* outs, int out_kind,
    const void* events, void* failed) {
  return mesh_routed(cards, devices, streams, tables, held, banks_per_group,
                     slots_per_bank, packed, cap, outs, out_kind, events, failed,
                     launch_routed_card);
}

// K7's card step on every "home" and "peer" card of a mesh, in one call;
// card 0 is the home card, whose stream orders the output.  Per card i:
// devices[i], streams[i], tables[i x groups ...] (the mesh's `groups`
// table pointers, null for a group on another card), lanes[5 i ...] (its
// slots, hits, fresh, limits and shadow; limits and shadow may be null),
// scratch[i] (int32[2, n] on the card: afters, incl), and copies[i]: where
// not null, the card's lanes are ONE copy of the `packed_bytes` bytes at
// `packed` (on the home card) made there first, and lanes[5 i ...] point
// into it.  Every card writes its owned lanes into `out` / `set_lc` (on
// the home card), as rl_sharded_card_step.
extern "C" int rl_mesh_card_step(
    int cards, const void* devices, const void* streams, const void* tables,
    int groups, int num_banks, long long slots_per_bank, const void* lanes,
    const void* copies, const void* packed, long long packed_bytes,
    float near_ratio, const void* scratch, void* out, void* set_lc,
    int epilogue, int n, void* failed) {
  int* bad = static_cast<int*>(failed);
  *bad = -1;
  if (groups < 1 || groups > kMaxGroups || num_banks % groups != 0 ||
      cards < 1 || cards > kMaxDevices) {
    *bad = 0;
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) {
    return 0;
  }
  const int* dev = static_cast<const int*>(devices);
  cudaStream_t const* st = static_cast<cudaStream_t const*>(streams);
  uint32_t* const* tab = static_cast<uint32_t* const*>(tables);
  void* const* ln = static_cast<void* const*>(lanes);
  cudaEvent_t ready = nullptr;
  cudaEvent_t done[kMaxDevices] = {};
  if (cards > 1) {
    // The lanes (and their packed copy) and the output are ready on the
    // home stream once the caller's work enqueued before this call is.
    int rc = each_card(1, dev, bad, [&](int) {
      cudaError_t err = cudaEventCreateWithFlags(&ready, cudaEventDisableTiming);
      return static_cast<int>(err != cudaSuccess ? err : cudaEventRecord(ready, st[0]));
    });
    if (rc != 0) {
      if (ready != nullptr) {
        cudaEventDestroy(ready);
      }
      return rc;
    }
  }
  int rc = each_card(cards, dev, bad, [&](int i) {
    cudaError_t err = cudaSuccess;
    if (i > 0) {
      err = cudaStreamWaitEvent(st[i], ready, 0);
    }
    void* copy = static_cast<void* const*>(copies)[i];
    if (err == cudaSuccess && copy != nullptr) {
      err = cudaMemcpyPeerAsync(copy, dev[i], packed, dev[0], packed_bytes, st[i]);
    }
    if (err != cudaSuccess) {
      return static_cast<int>(err);
    }
    CardIndex index{};
    bool any = false;
    for (int g = 0; g < groups; ++g) {
      index.table[g] = tab[static_cast<long long>(i) * groups + g];
      any = any || index.table[g] != nullptr;
    }
    if (!any) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    index.num_banks = num_banks;
    index.banks_per_group = num_banks / groups;
    index.slots_per_bank = slots_per_bank;
    uint8_t* scr = static_cast<uint8_t* const*>(scratch)[i];
    const int rc = launch_general_step(
        nullptr, index, ln[5 * i], ln[5 * i + 1], ln[5 * i + 2], ln[5 * i + 3],
        ln[5 * i + 4], near_ratio, scr, scr + 4LL * n, out, set_lc, epilogue, n,
        st[i]);
    if (rc != 0 || i == 0) {
      return rc;
    }
    err = cudaEventCreateWithFlags(&done[i], cudaEventDisableTiming);
    return static_cast<int>(err != cudaSuccess ? err : cudaEventRecord(done[i], st[i]));
  });
  // The home stream waits on every card that enqueued work, failed call
  // or not: the home card's lanes and output are not reused before.
  int home_bad = -1;
  const int waited = each_card(1, dev, &home_bad, [&](int) {
    int first = 0;
    for (int i = 1; i < cards; ++i) {
      if (done[i] != nullptr) {
        const cudaError_t err = cudaStreamWaitEvent(st[0], done[i], 0);
        first = first != 0 ? first : static_cast<int>(err);
      }
    }
    return first;
  });
  for (int i = 1; i < cards; ++i) {
    if (done[i] != nullptr) {
      cudaEventDestroy(done[i]);
    }
  }
  if (ready != nullptr) {
    cudaEventDestroy(ready);
  }
  if (rc == 0 && waited != 0) {
    *bad = 0;
    rc = waited;
  }
  return rc;
}

// Whether kernels on `device` may store into memory of `peer`
// (cudaDeviceCanAccessPeer) into *mapped, and where they may, the
// mapping enabled (cudaDeviceEnablePeerAccess under `device`; one that
// is enabled already is fine).  The calling thread's device is put back.
extern "C" int rl_enable_peer(int device, int peer, int* mapped) {
  int can = 0;
  cudaError_t err = cudaDeviceCanAccessPeer(&can, device, peer);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  *mapped = can;
  if (!can) {
    return 0;
  }
  int current = 0;
  err = cudaGetDevice(&current);
  if (err == cudaSuccess) {
    err = cudaSetDevice(device);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceEnablePeerAccess(peer, 0);
    if (err == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();
      err = cudaSuccess;
    }
    const cudaError_t back = cudaSetDevice(current);
    err = err != cudaSuccess ? err : back;
  }
  return static_cast<int>(err);
}

// `out` is the home output (u8, one layout of n lanes) and `partials`
// u8[cards, stride] (stride a multiple of 4) on the home device;
// `sources` is the HOST array of `groups` ints, group g's lanes' place: 0
// already in `out` (group 0 always), c + 1 in partial c.  Writes the
// combine cards' lanes into `out` in place.
extern "C" int rl_sharded_combine(void* out, const void* partials, long long stride,
                                  int cards, const void* sources, int groups,
                                  const void* slots, int num_banks,
                                  long long slots_per_bank, int rows32, int rows16,
                                  int rows8, int n, void* stream) {
  if (n <= 0) {
    return 0;
  }
  CombineArgs a;
  if (!combine_args(out, partials, stride, cards, sources, groups, slots, num_banks,
                    slots_per_bank, rows32, rows16, rows8, n, &a)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  combine_kernel<<<(n + kCombineThreads - 1) / kCombineThreads, kCombineThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
