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

namespace {

constexpr int kTile = 128;  // lanes per tile = threads per block
constexpr long long kMaxBlocks = 2048;

// Tile pair p of the lower triangle in row-major order:
// p = it * (it + 1) / 2 + jt with 0 <= jt <= it.  The double sqrt is
// correctly rounded, which makes the floor exact for every pair of up to
// 2^31 - 1 lanes (tests/test_torch_prefix.py checks each row's edges).
__device__ __forceinline__ void tile_pair(long long p, long long* it,
                                          long long* jt) {
  const long long r = static_cast<long long>(
      (sqrt(8.0 * static_cast<double>(p) + 1.0) - 1.0) * 0.5);
  *it = r;
  *jt = p - r * (r + 1) / 2;
}

// Sum of the staged hits whose slot equals `mine`; on the diagonal tile
// only staged lanes k <= t (j <= i) count.
template <bool kDiagonal>
__device__ __forceinline__ uint32_t tile_sum(const int4* s4, const uint4* h4,
                                             int32_t mine, int t) {
  uint32_t acc = 0u;
#pragma unroll 8
  for (int q = 0; q < kTile / 4; ++q) {
    const int4 s = s4[q];
    const uint4 h = h4[q];
    const int k = 4 * q;
    acc += (s.x == mine && (!kDiagonal || k <= t)) ? h.x : 0u;
    acc += (s.y == mine && (!kDiagonal || k + 1 <= t)) ? h.y : 0u;
    acc += (s.z == mine && (!kDiagonal || k + 2 <= t)) ? h.z : 0u;
    acc += (s.w == mine && (!kDiagonal || k + 3 <= t)) ? h.w : 0u;
  }
  return acc;
}

__global__ void __launch_bounds__(kTile) per_slot_inclusive_prefix_kernel(
    const int32_t* __restrict__ slots, const uint32_t* __restrict__ hits,
    uint32_t* __restrict__ out, int n, long long pairs, bool aligned) {
  __shared__ __align__(16) int32_t s_slots[kTile];
  __shared__ __align__(16) uint32_t s_hits[kTile];
  const int t = threadIdx.x;

  for (long long p = blockIdx.x; p < pairs; p += gridDim.x) {
    long long it, jt;
    tile_pair(p, &it, &jt);
    const long long i = it * kTile + t;
    const long long j0 = jt * kTile;
    const int32_t mine = i < n ? slots[i] : 0;

    // Stage the j tile.  Lanes past n get hits 0, so they add nothing
    // whatever their slot.
    if (aligned && j0 + kTile <= n) {
      constexpr int kVecs = kTile / 4;
      if (t < kVecs) {
        reinterpret_cast<int4*>(s_slots)[t] =
            reinterpret_cast<const int4*>(slots + j0)[t];
      } else if (t < 2 * kVecs) {
        reinterpret_cast<uint4*>(s_hits)[t - kVecs] =
            reinterpret_cast<const uint4*>(hits + j0)[t - kVecs];
      }
    } else {
      const long long j = j0 + t;
      s_slots[t] = j < n ? slots[j] : 0;
      s_hits[t] = j < n ? hits[j] : 0u;
    }
    __syncthreads();

    if (i < n) {
      const int4* s4 = reinterpret_cast<const int4*>(s_slots);
      const uint4* h4 = reinterpret_cast<const uint4*>(s_hits);
      const uint32_t acc = it == jt ? tile_sum<true>(s4, h4, mine, t)
                                    : tile_sum<false>(s4, h4, mine, t);
      if (acc != 0u) {
        atomicAdd(&out[i], acc);
      }
    }
    __syncthreads();
  }
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
  const long long tiles = (static_cast<long long>(n) + kTile - 1) / kTile;
  const long long pairs = tiles * (tiles + 1) / 2;
  const int blocks = static_cast<int>(pairs < kMaxBlocks ? pairs : kMaxBlocks);
  const bool aligned = ((reinterpret_cast<uintptr_t>(slots) |
                         reinterpret_cast<uintptr_t>(hits)) &
                        15u) == 0;
  per_slot_inclusive_prefix_kernel<<<blocks, kTile, 0, s>>>(
      static_cast<const int32_t*>(slots), static_cast<const uint32_t*>(hits),
      static_cast<uint32_t*>(out), n, pairs, aligned);
  return static_cast<int>(cudaGetLastError());
}
