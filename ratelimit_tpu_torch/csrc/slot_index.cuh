// JAX's index semantics for a slot id, shared by every kernel that
// gathers from or scatters into a [rows, num_slots] table (gather
// mode="fill", scatter mode="drop"): an id in [-num_slots, -1] addresses
// id + num_slots, numpy-style; an id below -num_slots or at or above
// num_slots is inert -- it reads 0 and writes nothing (the serving
// engine pads batches with the ids num_slots + i).

#pragma once

#include <cstdint>

// Table index of `slot`, or -1 when the id is out of the table.
__device__ __forceinline__ long long slot_index(int32_t slot,
                                                long long num_slots) {
  const long long s = slot < 0 ? slot + num_slots : slot;
  return (s >= 0 && s < num_slots) ? s : -1;
}
