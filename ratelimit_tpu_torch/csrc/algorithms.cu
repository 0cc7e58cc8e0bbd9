// Algorithm-bank serving kernels for Hopper (sm_90a): sliding window (K4)
// and GCRA (K5).
//
// State is a [rows, num_slots] table of uint32 (stored by the caller as an
// int32 tensor of the same bits), row r at state + r * num_slots.  The
// batch is the engine's packed int32[5, N] upload -- rows: slot, hits
// bits, limit bits, fresh, divider bits -- plus the batch clock `now`,
// which arrives as an int32 and is reinterpreted as uint32 (JAX's
// now.astype(jnp.uint32)).  Slot ids follow JAX's index semantics
// (slot_index.cuh): an id in [-num_slots, -1] addresses id + num_slots;
// any other id outside [0, num_slots) reads 0 and writes nothing (the
// engine pads with num_slots + i).  Dividers are never 0: every rate
// unit maps to a positive divider and pads carry 1.
//
// K4 sw_serve_step replaces the jitted XLA step
//   ratelimit_tpu/models/sliding_window.py:70 step_serve_packed (:79-119).
// K5 gcra_serve_step replaces
//   ratelimit_tpu/models/gcra.py:86 step_serve_packed (:95-143).
//
// One thread per lane: gather the slot's state rows, compute, scatter the
// new rows and write the narrow per-lane output.  The engine dedups on the
// host, so live slots are unique and the scatter needs no atomics.  Bound:
// K4 moves ~48 B per lane (16 packed in -- it never reads the limit row
// -- 12 gathered, 12 scattered, 8 out), K5 ~40 B (20 + 8 + 8 + 4):
// ~0.2 MB at 4096 lanes, far below what
// a launch costs, so the launch latency bounds both, as it does K1.
//
// Every f32 step is an explicit round-to-nearest intrinsic (__fmul_rn,
// __fadd_rn, __fsub_rn, __fdiv_rn) in the order of the JAX step and its
// numpy oracle, so nvcc cannot contract a multiply and an add into an FMA
// and the kernel equals the plain PyTorch version bit for bit.  Float to
// integer conversions use __float2uint_rz / __float2int_rz, which saturate
// and send NaN to 0 like PTX cvt.rzi and like XLA's convert (numpy's cast
// wraps instead: that is where the numpy oracle and the JAX step part).

#include <cstdint>
#include <cuda_runtime.h>

#include "slot_index.cuh"

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kU32Max = 0xFFFFFFFFu;
constexpr float kFracUnit = 2.3283064365386963e-10f;  // 2^-32
constexpr float kFracScale = 4294967296.0f;           // 2^32
constexpr float kFracMax = 4294967040.0f;  // largest f32 below 2^32
constexpr float kBudgetMax = 2147483520.0f;  // 2^31 - 128

__device__ __forceinline__ bool is_nan(float x) { return x != x; }

__global__ void sw_serve_step_kernel(uint32_t* __restrict__ state,
                                     long long num_slots,
                                     const int32_t* __restrict__ packed,
                                     int n, uint32_t now,
                                     uint32_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) {
    return;
  }
  const long long slot = slot_index(packed[i], num_slots);
  const uint32_t hits = static_cast<uint32_t>(packed[n + i]);
  const bool fresh = packed[3 * n + i] != 0;
  const uint32_t divider = static_cast<uint32_t>(packed[4 * n + i]);

  uint32_t win = 0u, curr = 0u, prev = 0u;
  if (slot >= 0) {
    win = state[slot];
    curr = state[num_slots + slot];
    prev = state[2 * num_slots + slot];
  }
  const uint32_t w = now - now % divider;
  const bool same = win == w && !fresh;
  // w - divider wraps when w < divider; the wrapped value never equals
  // a stored window (sliding_window.py:91-94).
  const bool adjacent = win == w - divider && !fresh;
  const uint32_t new_prev = same ? prev : (adjacent ? curr : 0u);
  const uint32_t base = same ? curr : 0u;

  const uint32_t elapsed = now - w;
  const float frac = __fdiv_rn(__uint2float_rn(divider - elapsed),
                               __uint2float_rn(divider));
  const uint32_t wprev =
      __float2uint_rz(floorf(__fmul_rn(__uint2float_rn(new_prev), frac)));

  uint32_t after = base + hits;
  if (after < base) {  // one u32 add wraps at most once: saturate
    after = kU32Max;
  }
  if (slot >= 0) {
    state[slot] = w;
    state[num_slots + slot] = after;
    state[2 * num_slots + slot] = new_prev;
  }
  out[i] = wprev;
  out[n + i] = after;
}

__global__ void gcra_serve_step_kernel(uint32_t* __restrict__ state,
                                       long long num_slots,
                                       const int32_t* __restrict__ packed,
                                       int n, uint32_t now,
                                       int32_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) {
    return;
  }
  const long long slot = slot_index(packed[i], num_slots);
  const uint32_t hits = static_cast<uint32_t>(packed[n + i]);
  const uint32_t limit = static_cast<uint32_t>(packed[2 * n + i]);
  const bool fresh = packed[3 * n + i] != 0;
  const uint32_t divider = static_cast<uint32_t>(packed[4 * n + i]);

  uint32_t sec = 0u, frac = 0u;
  if (slot >= 0 && !fresh) {
    sec = state[slot];
    frac = state[num_slots + slot];
  }
  // Signed seconds from now to the TAT, by two's-complement wrap.
  const int32_t rel = static_cast<int32_t>(sec - now);
  const float d = __fadd_rn(__int2float_rn(rel),
                            __fmul_rn(__uint2float_rn(frac), kFracUnit));
  const float v = fmaxf(d, 0.0f);  // (TAT - now)+, never NaN

  const float divf = __uint2float_rn(divider);
  const float t_emit = __fdiv_rn(divf, __uint2float_rn(limit));  // inf at 0
  const float tau = __fsub_rn(divf, t_emit);
  float budget =
      __fadd_rn(floorf(__fdiv_rn(__fsub_rn(tau, v), t_emit)), 1.0f);
  // limit == 0 makes the budget NaN: replace it BEFORE the clip, and clip
  // as jnp.clip does, keeping any other NaN (fminf/fmaxf would drop it).
  if (limit == 0u) {
    budget = 0.0f;
  }
  if (!is_nan(budget)) {
    budget = fminf(fmaxf(budget, 0.0f), kBudgetMax);
  }

  const float adm =
      is_nan(budget) ? budget : fminf(__uint2float_rn(hits), budget);
  const bool upd = adm > 0.0f;
  const float new_d = __fadd_rn(v, __fmul_rn(adm, upd ? t_emit : 0.0f));
  const float floor_d = floorf(new_d);
  float new_frac_f = __fmul_rn(__fsub_rn(new_d, floor_d), kFracScale);
  if (!is_nan(new_frac_f)) {
    new_frac_f = fminf(new_frac_f, kFracMax);
  }
  if (slot >= 0) {
    state[slot] = upd ? now + __float2uint_rz(floor_d) : sec;
    state[num_slots + slot] = upd ? __float2uint_rz(new_frac_f) : frac;
  }
  out[i] = __float2int_rz(budget);
}

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" int rl_sw_serve_step(void* state, long long num_slots,
                                const void* packed, int n, int now, void* out,
                                void* stream) {
  if (n <= 0) {
    return 0;
  }
  sw_serve_step_kernel<<<blocks_for(n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(state), num_slots,
      static_cast<const int32_t*>(packed), n, static_cast<uint32_t>(now),
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rl_gcra_serve_step(void* state, long long num_slots,
                                  const void* packed, int n, int now,
                                  void* out, void* stream) {
  if (n <= 0) {
    return 0;
  }
  gcra_serve_step_kernel<<<blocks_for(n), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(state), num_slots,
      static_cast<const int32_t*>(packed), n, static_cast<uint32_t>(now),
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
