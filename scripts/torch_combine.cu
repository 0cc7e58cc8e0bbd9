// The combine (sharded_combine, the psum's stand-in for a card that
// cannot map the home card) in other designs, for
// scripts/torch_combine.py to time on the card beside the shipped one
// (ratelimit_tpu_torch/csrc/sharded.cu, included here):
//
// - rl_parent_combine: the PR 18 design, kept verbatim.  Every card
//   writes each owned lane into the row of its owner group (parts[groups,
//   part_bytes], a stage copied home a row at a time), and one thread a
//   lane selects its owner's row with 64-bit % and /, moving each of the
//   layout's rows 4, 2 or 1 bytes at a time into a new output.
// - rl_probe_combine: the shipped select (in place in the home output,
//   each combine card's lanes from its one partial, the group -> source
//   table in the parameters) at `lanes` lanes a thread in one-warp
//   blocks: 1, the shipped combine_kernel, or 4, lanes4_combine_kernel
//   below, which moves each row's 4 lanes as one 16-, 8- or 4-byte word
//   where n is a multiple of 4 and the buffers 16-byte aligned, blending
//   lane by lane where the 4 lanes' owners differ; its other arguments
//   are rl_sharded_combine's.

#include "../ratelimit_tpu_torch/csrc/sharded.cu"

namespace {

constexpr int kParentThreads = 256;

__global__ void parent_combine_kernel(const uint8_t* __restrict__ parts,
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

// The PR 18 entry's arguments: `parts` u8[groups, part_bytes] on one
// device, `out` one partial's layout.
extern "C" int rl_parent_combine(const void* parts, long long part_bytes, int groups,
                                 const void* slots, int num_banks, long long slots_per_bank,
                                 int rows32, int rows16, int rows8, int n, void* out,
                                 void* stream) {
  if (n <= 0) {
    return 0;
  }
  if (groups < 1 || num_banks % groups != 0 || part_bytes % 4 != 0 ||
      part_bytes < (4LL * rows32 + 2LL * rows16 + rows8) * n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  parent_combine_kernel<<<(n + kParentThreads - 1) / kParentThreads, kParentThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(parts), part_bytes, static_cast<const int32_t*>(slots),
      num_banks, static_cast<long long>(num_banks) * slots_per_bank, num_banks / groups, n,
      rows32, rows16, rows8, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

namespace {

// 4 lanes of one row of T as one word.
template <class T> struct Word4;
template <> struct Word4<uint32_t> { using type = uint4; };
template <> struct Word4<uint16_t> { using type = uint2; };
template <> struct Word4<uint8_t> { using type = uint32_t; };

template <class T>
union Lanes4 {
  typename Word4<T>::type v;
  T e[4];
};

// Lanes [i0, i0 + m) of row `r` of width T at byte `at`: from the one
// partial every lane takes them from where `same`, else the home row with
// each combine lane's field put in; one word where `vec`.
template <class T>
__device__ __forceinline__ Lanes4<T> gather4(const CombineArgs& a, long long at, int r, int i0,
                                             int m, const int (&src)[4], bool same, bool vec) {
  const long long x = static_cast<long long>(r) * a.n + i0;
  const uint8_t* base = same ? a.partials + (src[0] - 1) * a.stride : a.out;
  const T* row = reinterpret_cast<const T*>(base + at) + x;
  Lanes4<T> w;
  if (vec) {
    w.v = *reinterpret_cast<const typename Word4<T>::type*>(row);
  } else {
    for (int j = 0; j < 4; ++j) {
      w.e[j] = j < m ? row[j] : T(0);
    }
  }
  if (!same) {
    for (int j = 0; j < m; ++j) {
      if (src[j] != 0) {
        w.e[j] = reinterpret_cast<const T*>(a.partials + (src[j] - 1) * a.stride + at)[x + j];
      }
    }
  }
  return w;
}

template <class T>
__device__ __forceinline__ void store4(T* row, const Lanes4<T>& w, int m, bool vec) {
  if (vec) {
    *reinterpret_cast<typename Word4<T>::type*>(row) = w.v;
  } else {
    for (int j = 0; j < m; ++j) {
      row[j] = w.e[j];
    }
  }
}

__global__ void lanes4_combine_kernel(const __grid_constant__ CombineArgs a, bool vec) {
  const int i0 = (blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i0 >= a.n) {
    return;
  }
  const int m = min(4, a.n - i0);
  int32_t s[4];
  load_lanes(a.slots + i0, m, vec, s, -1);
  int src[4];
  bool any = false;
  bool same = true;
  for (int j = 0; j < 4; ++j) {
    src[j] = combine_source(a, s[j]);
    any = any || src[j] != 0;
    same = same && src[j] == src[0];
  }
  if (!any) {
    return;
  }
  const long long at16 = 4LL * a.rows32 * a.n;
  const long long at8 = at16 + 2LL * a.rows16 * a.n;
  Lanes4<uint32_t> w32[kCombineRows32];
  Lanes4<uint16_t> w16[kCombineRows16];
  Lanes4<uint8_t> w8[kCombineRows8];
#pragma unroll
  for (int r = 0; r < kCombineRows32; ++r) {
    if (r < a.rows32) {
      w32[r] = gather4<uint32_t>(a, 0, r, i0, m, src, same, vec);
    }
  }
#pragma unroll
  for (int r = 0; r < kCombineRows16; ++r) {
    if (r < a.rows16) {
      w16[r] = gather4<uint16_t>(a, at16, r, i0, m, src, same, vec);
    }
  }
#pragma unroll
  for (int r = 0; r < kCombineRows8; ++r) {
    if (r < a.rows8) {
      w8[r] = gather4<uint8_t>(a, at8, r, i0, m, src, same, vec);
    }
  }
  const long long w = a.n;
#pragma unroll
  for (int r = 0; r < kCombineRows32; ++r) {
    if (r < a.rows32) {
      store4(reinterpret_cast<uint32_t*>(a.out) + r * w + i0, w32[r], m, vec);
    }
  }
#pragma unroll
  for (int r = 0; r < kCombineRows16; ++r) {
    if (r < a.rows16) {
      store4(reinterpret_cast<uint16_t*>(a.out + at16) + r * w + i0, w16[r], m, vec);
    }
  }
#pragma unroll
  for (int r = 0; r < kCombineRows8; ++r) {
    if (r < a.rows8) {
      store4(a.out + at8 + r * w + i0, w8[r], m, vec);
    }
  }
}

}  // namespace

extern "C" int rl_probe_combine(int lanes, void* out, const void* partials, long long stride,
                                int cards, const void* sources, int groups, const void* slots,
                                int num_banks, long long slots_per_bank, int rows32,
                                int rows16, int rows8, int n, void* stream) {
  if (n <= 0) {
    return 0;
  }
  CombineArgs a;
  if ((lanes != 1 && lanes != 4) ||
      !combine_args(out, partials, stride, cards, sources, groups, slots, num_banks,
                    slots_per_bank, rows32, rows16, rows8, n, &a)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = (n + lanes - 1) / lanes;
  const int blocks = (threads + kCombineThreads - 1) / kCombineThreads;
  if (lanes == 1) {
    combine_kernel<<<blocks, kCombineThreads, 0, s>>>(a);
  } else {
    const bool vec = n % 4 == 0 && stride % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(partials) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(slots) % 16 == 0;
    lanes4_combine_kernel<<<blocks, kCombineThreads, 0, s>>>(a, vec);
  }
  return static_cast<int>(cudaGetLastError());
}
