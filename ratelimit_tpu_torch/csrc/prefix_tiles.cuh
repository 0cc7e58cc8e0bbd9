// The triangular tile pass of the per-slot inclusive prefix (K2), shared
// by the standalone kernel (prefix.cu) and the fused general step
// (counter_update.cuh), so both run the same code:
//
//     out[i] += sum_{j <= i, slots[j] == slots[i]} hits[j]     (mod 2^32)
//
// over the lanes' 128-lane tiles: tile pair p = (it, jt <= it) adds the
// partial sums of tile jt's lanes into tile it's, with a modular
// atomicAdd per lane.  u32 addition commutes, so any order of the atomics
// gives the same bits.  `out` must be zero before the pass, and the pass
// must be called by every thread of a block of kTile threads: it stages
// each j tile in shared memory behind __syncthreads.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;  // lanes per tile = threads per block

// Lower-triangle tile pairs of n lanes.
inline long long tile_pairs(int n) {
  const long long tiles = (static_cast<long long>(n) + kTile - 1) / kTile;
  return tiles * (tiles + 1) / 2;
}

// Whether both lane arrays allow the 16-byte staging loads.
inline bool tiles_aligned(const void* slots, const void* hits) {
  return ((reinterpret_cast<uintptr_t>(slots) |
           reinterpret_cast<uintptr_t>(hits)) &
          15u) == 0;
}

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

// The pass: the block walks tile pairs blockIdx.x, + gridDim.x, ... of
// `pairs` (tile_pairs(n)); `aligned` is tiles_aligned(slots, hits).
__device__ __forceinline__ void prefix_tile_pass(
    const int32_t* __restrict__ slots, const uint32_t* __restrict__ hits,
    uint32_t* out, int n, long long pairs, bool aligned) {
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
