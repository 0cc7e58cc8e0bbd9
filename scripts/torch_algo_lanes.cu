// Lanes a thread in the algorithm kernels' rows kernels (K4 sliding
// window, K5 GCRA), for scripts/torch_algo_lanes.py to compare on the
// card, in the mapped form (pinned host words and readback through their
// device aliases) and in the device form (device pointers):
//
// - the shipped entries of ratelimit_tpu_torch/csrc/algorithms.cu
//   (rl_sw_serve_step(_mapped), rl_gcra_serve_step(_mapped)): the rows
//   kernels, kMappedLanes lanes a thread with 16-byte row loads, one-warp
//   blocks;
// - rl_probe_lane: one lane a thread, the same lane functions (sw_lane,
//   gcra_lane: gather, then compute and scatter), its row loads 4 bytes
//   a thread -- a warp's 32 lanes one 128-byte request a row -- in
//   blocks of `threads`.

#include "../ratelimit_tpu_torch/csrc/algorithms.cu"

namespace {

__global__ void sw_lane_kernel(uint32_t* __restrict__ state, long long num_slots,
                               const int32_t* __restrict__ packed, int n, uint32_t now,
                               uint32_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) {
    return;
  }
  const long long stride = n;
  sw_lane(state, num_slots, packed[i], static_cast<uint32_t>(packed[stride + i]),
          packed[3 * stride + i] != 0, static_cast<uint32_t>(packed[4 * stride + i]), now,
          out, n, i);
}

__global__ void gcra_lane_kernel(uint32_t* __restrict__ state, long long num_slots,
                                 const int32_t* __restrict__ packed, int n, uint32_t now,
                                 int32_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) {
    return;
  }
  const long long stride = n;
  gcra_lane(state, num_slots, packed[i], static_cast<uint32_t>(packed[stride + i]),
            static_cast<uint32_t>(packed[2 * stride + i]), packed[3 * stride + i] != 0,
            static_cast<uint32_t>(packed[4 * stride + i]), now, out, i);
}

}  // namespace

// `gcra` 0: K4, else K5.  `mapped` nonzero: `words` and `out` are host
// addresses of pinned memory, reached through their device aliases;
// else device pointers.
extern "C" int rl_probe_lane(int gcra, void* state, long long num_slots, const void* words,
                             int n, int now, void* out, void* stream, int mapped,
                             int threads) {
  if (n <= 0) {
    return 0;
  }
  void* dev_words = const_cast<void*>(words);
  void* dev_out = out;
  if (mapped) {
    const cudaError_t err = mapped_aliases(words, out, &dev_words, &dev_out);
    if (err != cudaSuccess) {
      return static_cast<int>(err);
    }
  }
  const int blocks = (n + threads - 1) / threads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gcra) {
    gcra_lane_kernel<<<blocks, threads, 0, s>>>(
        static_cast<uint32_t*>(state), num_slots, static_cast<const int32_t*>(dev_words), n,
        static_cast<uint32_t>(now), static_cast<int32_t*>(dev_out));
  } else {
    sw_lane_kernel<<<blocks, threads, 0, s>>>(
        static_cast<uint32_t*>(state), num_slots, static_cast<const int32_t*>(dev_words), n,
        static_cast<uint32_t>(now), static_cast<uint32_t*>(dev_out));
  }
  return static_cast<int>(cudaGetLastError());
}
