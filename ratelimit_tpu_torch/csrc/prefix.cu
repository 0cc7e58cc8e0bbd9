// K2: per-slot inclusive prefix over one batch, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ratelimit_tpu/ops/prefix_pallas.py
// (_prefix_kernel, launched through pl.pallas_call at line 82):
//
//     incl[i] = sum_{j <= i, slots[j] == slots[i]} hits[j]     (mod 2^32)
//
// The TPU kernel materialises 256 x N equality*causality masks in VMEM
// and reduces them on the vector unit.  Here each thread owns one
// output lane i and walks the lanes j <= i in shared-memory tiles of
// (slots, hits), accumulating in uint32_t -- the same modular sum the
// sort-based plain version (ops/prefix.py) and the Pallas int32
// accumulator give.  Any N >= 1 works; tiles mask the ragged edge.
//
// Bound: N(N+1)/2 compare-adds (about 8.4 M at N = 4096) against 8 B
// read and 4 B written per lane, so the work is operations-bound on
// paper and launch/latency-bound in practice at serving sizes.  A block
// stops at the last tile its own lanes need, so blocks late in the
// batch do the most work; a warp-level __match_any_sync design that
// groups equal slots is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;

__global__ void per_slot_inclusive_prefix_kernel(
    const int32_t* __restrict__ slots,
    const uint32_t* __restrict__ hits,
    uint32_t* __restrict__ out,
    int n) {
  __shared__ int32_t s_slots[kTile];
  __shared__ uint32_t s_hits[kTile];

  const int first = blockIdx.x * kTile;
  const int i = first + threadIdx.x;
  const bool live = i < n;
  const int32_t mine = live ? slots[i] : 0;
  // Highest lane any thread of this block reads.
  const int last = min(n - 1, first + kTile - 1);

  uint32_t acc = 0;
  for (int base = 0; base <= last; base += kTile) {
    const int j = base + threadIdx.x;
    if (j <= last) {
      s_slots[threadIdx.x] = slots[j];
      s_hits[threadIdx.x] = hits[j];
    }
    __syncthreads();
    const int count = min(kTile, last - base + 1);
    for (int k = 0; k < count; ++k) {
      if (base + k <= i && s_slots[k] == mine) {
        acc += s_hits[k];
      }
    }
    __syncthreads();
  }
  if (live) {
    out[i] = acc;
  }
}

}  // namespace

extern "C" int rl_per_slot_inclusive_prefix(
    const void* slots, const void* hits, void* out, int n, void* stream) {
  if (n <= 0) {
    return 0;
  }
  const int blocks = (n + kTile - 1) / kTile;
  per_slot_inclusive_prefix_kernel<<<blocks, kTile, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(slots), static_cast<const uint32_t*>(hits),
      static_cast<uint32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
