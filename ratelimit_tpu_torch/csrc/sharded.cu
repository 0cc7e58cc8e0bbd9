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
// batch's rows of that group), one thread per routed lane, no atomics
// (slots are unique within a bank): in the device form
// (rl_sharded_routed_step) grid (cap / 256, num_banks) over the
// batch in device memory; in the by-value form
// (rl_sharded_routed_step_lanes, num_banks x cap <= 128, so 8 banks up to
// cap 16) one block of num_banks x cap threads over the batch carried in
// the launch's parameters, the readback into mapped pinned memory
// (counter_update.cuh).  Local ids follow JAX's index semantics at width
// slots_per_bank.  The add saturates; the readback is K1's.  Bound: 16 B
// in, 4 B gathered, 4 B written and <= 4 B out per routed lane, padding
// included -- about 0.1 MB for 4096 lanes over 8 banks, so the launch
// latency bounds it, as it bounds K1.  The TPU's 128-wide row gather
// (sharded.py:239-253) is a TPU layout trick and has no counterpart.
//
// The host routes by bank, so K6 needs no collective: a group's launch
// serves that group's rows of the batch (the engine packs one
// int32[k, 4, cap] batch a group, each on its group's stream).
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
// topology).  Then every card's launch writes each owned lane into the
// row of its owner group, out_stride bytes apart (parts[groups,
// part_bytes]: on the home card and on mapped cards in place, on an
// unmapped card into a stage of its own that the caller copies home), and
// one launch selects, for each lane, the fields of the row of its owner
// group: (s % num_banks) / banks_per_group for an in-table id s, the
// group of bank 0 for any other.  It reads no other row, so the rows
// need no zeros: the select is JAX's sum of one owner's share.  A row is
// rows32 rows of u32[n], then rows16 rows of u16[n], then rows8 rows of
// u8[n] -- the afters 1/0/0, the u16 readback 0/1/0, the u8 readback
// 0/0/1, the decision block 8/0/1 (set_local_cache its u8 row) -- and
// `out` has the same layout.  One thread a lane, no atomics.  Bound:
// bytes, and the select reads only the owner's row of each lane: one
// row's bytes and the ids in, one row out -- about 0.29 MB for the
// decision block of 4096 lanes, 0.09 us at 3.35 TB/s, whatever the
// number of groups, so the launch bounds it.

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

namespace {

__global__ void combine_kernel(const uint8_t* __restrict__ parts,
                               long long part_bytes,
                               const int32_t* __restrict__ slots,
                               int num_banks, long long num_slots,
                               int banks_per_group, int n, int rows32,
                               int rows16, int rows8,
                               uint8_t* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) {
    return;
  }
  const int32_t s = slots[i];
  const long long owner =
      (s >= 0 && s < num_slots) ? (s % num_banks) / banks_per_group : 0;
  const uint8_t* src = parts + owner * part_bytes;
  const long long w = n;
  for (int r = 0; r < rows32; ++r) {
    reinterpret_cast<uint32_t*>(out)[r * w + i] =
        reinterpret_cast<const uint32_t*>(src)[r * w + i];
  }
  const long long at16 = 4 * rows32 * w;
  for (int r = 0; r < rows16; ++r) {
    reinterpret_cast<uint16_t*>(out + at16)[r * w + i] =
        reinterpret_cast<const uint16_t*>(src + at16)[r * w + i];
  }
  const long long at8 = at16 + 2 * rows16 * w;
  for (int r = 0; r < rows8; ++r) {
    out[at8 + r * w + i] = src[at8 + r * w + i];
  }
}

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
// is this card's), its values carried into the launch's parameters.  An
// owned lane's fields land at out + g * out_stride bytes for its owner
// group g (set_lc likewise); `out` may lie on another card that this card
// maps.  `afters` and `incl` are int32[n] of scratch on this card.
extern "C" int rl_sharded_card_step(
    const void* tables, int groups, int num_banks, long long slots_per_bank,
    const void* slots, const void* hits, const void* fresh, const void* limits,
    const void* shadow, float near_ratio, void* afters, void* incl, void* out,
    void* set_lc, long long out_stride, int epilogue, int n, void* stream) {
  if (groups < 1 || groups > kMaxGroups || num_banks % groups != 0 ||
      out_stride < 0) {
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
  index.out_stride = out_stride;
  return launch_general_step(nullptr, index, slots, hits, fresh, limits,
                             shadow, near_ratio, afters, incl, out, set_lc,
                             epilogue, n, stream);
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

// `parts` is u8[groups, part_bytes] on the home device, part_bytes a
// multiple of 4 (each partial's u32 rows stay aligned); `out` holds one
// partial's layout.
extern "C" int rl_sharded_combine(const void* parts, long long part_bytes,
                                  int groups, const void* slots,
                                  int num_banks, long long slots_per_bank,
                                  int rows32, int rows16, int rows8, int n,
                                  void* out, void* stream) {
  if (n <= 0) {
    return 0;
  }
  if (groups < 1 || num_banks % groups != 0 || part_bytes % 4 != 0 ||
      part_bytes < (4LL * rows32 + 2LL * rows16 + rows8) * n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  combine_kernel<<<blocks_for(n), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(parts), part_bytes,
      static_cast<const int32_t*>(slots), num_banks,
      static_cast<long long>(num_banks) * slots_per_bank, num_banks / groups,
      n, rows32, rows16, rows8, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
