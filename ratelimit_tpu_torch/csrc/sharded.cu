// Bank-sharded fixed-window counter kernels for Hopper (sm_90a).
//
// The table is uint32 laid out (num_banks, slots_per_bank), bank-major, on
// one device (the caller stores it as int32 of the same bits).  The JAX
// model puts one bank on each chip of a mesh; here every bank lives on one
// card, so no kernel needs a collective.  The kernels are those of the
// single table (counter_update.cuh), under another index policy or with a
// bank per blockIdx.y.
//
// K6 rl_sharded_routed_step replaces the routed unique step
//   ratelimit_tpu/parallel/sharded.py:184-227
//   step_counters_unique_routed_packed -> _bank_unique (:229-266).
// The host routes each unique slot to its bank and hands over one packed
// int32[num_banks, 4, cap] batch of LOCAL ids (padding ids
// slots_per_bank + i).  One launch serves every bank, one thread per
// routed lane, no atomics (slots are unique within a bank): in the device
// form (rl_sharded_routed_step) grid (cap / 256, num_banks) over the
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
// K7 rl_sharded_general_step replaces the general update _bank_core
// (sharded.py:270-302) and the psum of _bank_update,
// step_counters_compact and _bank_step (:116-141,304-324) over a
// replicated batch of GLOBAL ids.  StripedIndex gives each in-table lane
// its owner bank and position; an out-of-table lane (negative ids
// included: they never wrap here) reads a virtual zero and scatters
// nowhere.  The per-slot prefix runs on the raw global ids.  Each lane
// has exactly one owner, so the psum is the write of that lane: no
// collective.  It is K3's general step under another index policy, one
// cooperative launch (general_step_kernel, counter_update.cuh, says what
// bounds it), with the raw afters, the narrow u8/u16 readback
// min(after, limit + hits) or the decision block as its epilogue.

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

extern "C" int rl_sharded_general_step(
    void* counts, int num_banks, long long slots_per_bank, const void* slots,
    const void* hits, const void* fresh, const void* limits,
    const void* shadow, float near_ratio, void* afters, void* incl, void* out,
    void* set_lc, int epilogue, int n, void* stream) {
  return launch_general_step(counts, StripedIndex{num_banks, slots_per_bank},
                             slots, hits, fresh, limits, shadow, near_ratio,
                             afters, incl, out, set_lc, epilogue, n, stream);
}
