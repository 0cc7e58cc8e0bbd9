// K2: per-slot inclusive prefix over one batch, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ratelimit_tpu/ops/prefix_pallas.py
// (_prefix_kernel, launched through pl.pallas_call at line 82):
//
//     incl[i] = sum_{j <= i, slots[j] == slots[i]} hits[j]     (mod 2^32)
//
// Slot ids are compared raw, so -1 and ns - 1 share a table slot but not a
// prefix, as in the JAX package.  Any N >= 1.
//
// What bounds it.  The least work is a sort of the lanes by slot and a
// segmented sum (n log2 n + n operations), and the bytes are 8 B in and
// 4 B out per lane: 48 KB at N = 4096, 0.015 us at 3.35 TB/s.  So at the
// batch sizes the engine makes (TPU_BATCH_BUCKETS, at most 4096 lanes by
// default) the latency of a launch bounds it, not the memory system.  The
// Pallas kernel's mask reduction does N(N+1)/2 compare-adds; carried over
// as one block per 128 output lanes walking every tile before its own, it
// left 100 of the 132 SMs idle at N = 4096 and put a serial 4096-step
// shared-memory loop on the critical path.
//
// The design.  The lanes are cut into tiles of kTile = 128, and the grid
// enumerates only the lower-triangle tile pairs (it, jt <= it), decoded
// from a linear block id, so each block does one 128 x 128 tile pair:
// N = 4096 runs 528 blocks, four to an SM, none longer than the others.
// A block stages the j tile's slots and hits in shared memory (16-byte
// loads where the pointers allow), and each thread compares its lane i's
// slot with the 128 staged slots, four at a time from one broadcast
// 16-byte shared load each for slots and hits; j <= i is applied on the
// diagonal tile only.  It then atomicAdds its partial sum into out[i]
// when the partial is not zero.  u32 addition commutes, so any order of
// the atomics gives the same bits: the result is exact, not within a
// tolerance.  The launcher zeroes `out` on the same stream first.
//
// The pass itself (tile_pair, tile_sum, the staging loop) lives in
// prefix_tiles.cuh, which the fused general step (counter_update.cuh)
// runs as its phase B: this kernel and the fused one run the same code.
//
// Limit.  The work still grows as N^2.  That fits every batch the engine
// makes: on an H100 80GB HBM3 at 700 W (chip_smoke.py) a call, memset
// included, takes 4.6 us at N = 4096, where one launch of anything costs
// about 1.2 us.  At N = 16384 (8,256 tile pairs) it takes 30.2 us, still
// under the 100 us of the sort-based plain version, but a sort would win
// a few doublings further on.  Past kMaxBlocks tile pairs the blocks walk
// the pairs grid-stride; kMaxBlocks is about what the card holds at once,
// so a grid never queues more blocks than it can run, and N = 16384
// (8,256 pairs) runs the loop.

#include <cstdint>
#include <cuda_runtime.h>

#include "prefix_tiles.cuh"

namespace {

constexpr long long kMaxBlocks = 2048;

__global__ void __launch_bounds__(kTile) per_slot_inclusive_prefix_kernel(
    const int32_t* __restrict__ slots, const uint32_t* __restrict__ hits,
    uint32_t* __restrict__ out, int n, long long pairs, bool aligned) {
  prefix_tile_pass(slots, hits, out, n, pairs, aligned);
}

}  // namespace

extern "C" int rl_per_slot_inclusive_prefix(
    const void* slots, const void* hits, void* out, int n, void* stream) {
  if (n <= 0) {
    return 0;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaMemsetAsync(out, 0, static_cast<size_t>(n) * sizeof(uint32_t), s);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  const long long pairs = tile_pairs(n);
  const int blocks = static_cast<int>(pairs < kMaxBlocks ? pairs : kMaxBlocks);
  per_slot_inclusive_prefix_kernel<<<blocks, kTile, 0, s>>>(
      static_cast<const int32_t*>(slots), static_cast<const uint32_t*>(hits),
      static_cast<uint32_t*>(out), n, pairs, tiles_aligned(slots, hits));
  return static_cast<int>(cudaGetLastError());
}
