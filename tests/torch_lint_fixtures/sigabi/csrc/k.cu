// Drifted CUDA launchers for sigabi/kernels.py (the table there
// disagrees with three of them; rl_undeclared has no entry at all).
#include <cstdint>

constexpr long long kMaxBlocks = 2048;

__global__ void step_kernel(uint32_t* state, long long num_slots) {}

extern "C" int rl_step(void* state, long long num_slots, const void* packed,
                       int n, void* stream) {
  step_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(state), num_slots);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rl_decide(const void* afters, const void* limits,
                         float near_ratio, int n, void* out, void* stream) {
  return 0;
}

extern "C" int rl_wide(void* table, unsigned long long n, void** device) {
  return 0;
}

extern "C" int rl_undeclared(void* table) { return 0; }
