// Two ways for the mapped form of K1 to read its staged batch from
// pinned host memory, for scripts/torch_mapped_load.py to compare on
// the card (one table, the same arithmetic, the same readback):
//
// - rl_probe_direct: the shipped kernel (unique_step_rows_kernel in
//   ratelimit_tpu_torch/csrc/counter_update.cuh), each thread's four
//   16-byte loads of the host words issued before any gather;
// - rl_probe_direct_block: the same kernel at another block size;
// - rl_probe_bulk: a block stages its tile of kBulkLanes lanes in shared
//   memory with four bulk copies (cp.async.bulk, one a row of the packed
//   batch) completing on one mbarrier, then each thread serves its four
//   lanes from shared memory.  Whether a bulk copy accepts a host-mapped
//   source is part of what the script finds out.
//
// And, with the batch and readback in DEVICE memory (--device):
//
// - rl_probe_device: the shipped device form (launch_unique_step, the
//   same unique_step_rows_kernel on device pointers);
// - rl_probe_device_lane: the device form it replaced, one lane a thread
//   in blocks of kThreads (serve_lane).

#include <cstdint>
#include <cuda_runtime.h>

#include "../ratelimit_tpu_torch/csrc/counter_update.cuh"

namespace {

constexpr int kBulkLanes = kThreads * kMappedLanes;  // lanes a block stages

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__global__ void bulk_kernel(uint32_t* __restrict__ counts, long long num_slots,
                            const int32_t* __restrict__ packed, int n,
                            void* __restrict__ out, int out_kind) {
  __shared__ alignas(128) int32_t tile[4][kBulkLanes];
  __shared__ alignas(8) uint64_t bar;
  const int lo = blockIdx.x * kBulkLanes;
  const int width = min(kBulkLanes, n - lo);  // a multiple of kMappedLanes
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(&bar)));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const uint32_t bytes = static_cast<uint32_t>(width) * 4;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"(smem_addr(&bar)), "r"(4 * bytes) : "memory");
    for (int r = 0; r < 4; ++r) {
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];"
          ::"r"(smem_addr(tile[r])), "l"(packed + static_cast<long long>(r) * n + lo),
          "r"(bytes), "r"(smem_addr(&bar))
          : "memory");
    }
  }
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], 0;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(smem_addr(&bar))
      : "memory");
  const int j0 = threadIdx.x * kMappedLanes;
  if (j0 >= width) {
    return;
  }
  long long slot[kMappedLanes];
  uint32_t after[kMappedLanes];
#pragma unroll
  for (int j = 0; j < kMappedLanes; ++j) {
    slot[j] = slot_index(tile[0][j0 + j], num_slots);
    after[j] = lane_before(counts, slot[j], tile[3][j0 + j] != 0);
  }
#pragma unroll
  for (int j = 0; j < kMappedLanes; ++j) {
    const uint32_t hits = static_cast<uint32_t>(tile[1][j0 + j]);
    after[j] = lane_after(after[j], hits);
    if (slot[j] >= 0) {
      counts[slot[j]] = after[j];
    }
    store_readback(out, lo + j0 + j,
                   readback_of(after[j], static_cast<uint32_t>(tile[2][j0 + j]) + hits,
                               out_kind),
                   out_kind);
  }
}

__global__ void device_lane_kernel(uint32_t* __restrict__ counts, long long num_slots,
                                   const int32_t* __restrict__ packed, int n,
                                   void* __restrict__ out, int out_kind) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) {
    return;
  }
  serve_lane(counts, num_slots, packed[i], static_cast<uint32_t>(packed[n + i]),
             static_cast<uint32_t>(packed[2 * n + i]), packed[3 * n + i] != 0, out, i,
             out_kind);
}

}  // namespace

// `packed` and `out` in device memory.
extern "C" int rl_probe_device(void* counts, long long num_slots, const void* packed,
                               int n, void* out, int out_kind, void* stream) {
  return launch_unique_step(counts, num_slots, packed, 1, n, out, out_kind, stream);
}

extern "C" int rl_probe_device_lane(void* counts, long long num_slots, const void* packed,
                                    int n, void* out, int out_kind, void* stream) {
  if (n <= 0) {
    return 0;
  }
  device_lane_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(counts), num_slots, static_cast<const int32_t*>(packed), n, out,
      out_kind);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rl_probe_direct(void* counts, long long num_slots, const void* words,
                               int n, void* out, int out_kind, void* stream) {
  return launch_unique_step_mapped(counts, num_slots, words, 1, n, out, out_kind, stream);
}

// The shipped kernel launched with `threads` threads a block (a multiple
// of 32) instead of the launcher's choice.
extern "C" int rl_probe_direct_block(void* counts, long long num_slots, const void* words,
                                     int n, void* out, int out_kind, void* stream,
                                     int threads) {
  if (n <= 0) {
    return 0;
  }
  void* dev_words = nullptr;
  void* dev_out = nullptr;
  cudaError_t err = mapped_alias(const_cast<void*>(words), &dev_words);
  if (err == cudaSuccess) {
    err = mapped_alias(out, &dev_out);
  }
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  const bool vec = n % kMappedLanes == 0 &&
                   reinterpret_cast<uintptr_t>(dev_words) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dev_out) % 16 == 0;
  const int lanes_threads = (n + kMappedLanes - 1) / kMappedLanes;
  unique_step_rows_kernel<BankRows>
      <<<(lanes_threads + threads - 1) / threads, threads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          BankRows{static_cast<uint32_t*>(counts), num_slots}, num_slots,
          static_cast<const int32_t*>(dev_words), n, dev_out, out_kind, vec);
  return static_cast<int>(cudaGetLastError());
}

// n must be a multiple of kMappedLanes (16-byte rows for the bulk copies).
extern "C" int rl_probe_bulk(void* counts, long long num_slots, const void* words,
                             int n, void* out, int out_kind, void* stream) {
  if (n <= 0) {
    return 0;
  }
  if (n % kMappedLanes != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  void* dev_words = nullptr;
  void* dev_out = nullptr;
  cudaError_t err = mapped_alias(const_cast<void*>(words), &dev_words);
  if (err == cudaSuccess) {
    err = mapped_alias(out, &dev_out);
  }
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  bulk_kernel<<<(n + kBulkLanes - 1) / kBulkLanes, kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(counts), num_slots, static_cast<const int32_t*>(dev_words), n,
      dev_out, out_kind);
  return static_cast<int>(cudaGetLastError());
}
