// CUDA launchers that sigabi_ok/kernels.py binds exactly.
#include <cstdint>

extern "C" int rl_step(void* state, long long num_slots, const void* packed,
                       int n, void* stream) {
  return 0;
}

extern "C" int rl_decide(const void* afters, const void* limits,
                         float near_ratio, int n, void* out, void* stream) {
  return 0;
}

extern "C" int rl_wide(void* table, unsigned long long n, void** device) {
  return 0;
}
