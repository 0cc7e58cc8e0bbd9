// Algorithm-bank serving kernels for Hopper (sm_90a): sliding window (K4)
// and GCRA (K5).
//
// State is a [rows, num_slots] table of uint32 (stored by the caller as an
// int32 tensor of the same bits), row r at state + r * num_slots.  The
// batch is the engine's packed int32[5, N] -- rows: slot, hits bits, limit
// bits, fresh, divider bits -- plus the batch clock `now`, which arrives
// as an int32 and is reinterpreted as uint32 (JAX's
// now.astype(jnp.uint32)).  Slot ids follow JAX's index semantics
// (slot_index.cuh): an id in [-num_slots, -1] addresses id + num_slots;
// any other id outside [0, num_slots) reads 0 and writes nothing (the
// engine pads with num_slots + i).  Dividers are never 0: every rate unit
// maps to a positive divider and pads carry 1.
//
// K4 sw_serve_step replaces the jitted XLA step
//   ratelimit_tpu/models/sliding_window.py:70 step_serve_packed (:79-119).
// K5 gcra_serve_step replaces
//   ratelimit_tpu/models/gcra.py:86 step_serve_packed (:95-143).
//
// One thread per lane (sw_lane, gcra_lane): gather the slot's state rows,
// compute, scatter the new rows and write the narrow per-lane readback --
// K4 u32[2, N] (weighted prev, after), K5 i32[N] (budget).  The engine
// dedups on the host, so live slots are unique and the scatter needs no
// atomics.  Bound: K4 moves ~48 B per lane (16 packed in -- it never reads
// the limit row -- 12 gathered, 12 scattered, 8 out), K5 ~40 B (20 + 8 +
// 8 + 4): ~0.2 MB at 4096 lanes, far below what a launch costs, so the
// launch latency bounds both, as it does K1.  Each kernel has K1's two
// forms, chosen by the batch's shape alone (fixed_window.py
// lanes_by_value): the device form reads the packed batch from device
// memory and writes the readback into a device tensor; the by-value form
// (by_value.cuh), for chunks of at most kMaxLanes lanes, carries one
// 20-byte record a lane in the launch's parameters and writes the
// readback into the caller's pinned host memory, so a served algorithm
// chunk is one device activity instead of upload, kernel and readback
// copy.  Both forms run the same lane function, so they agree bit for bit.
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

#include "by_value.cuh"
#include "slot_index.cuh"

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kU32Max = 0xFFFFFFFFu;
constexpr float kFracUnit = 2.3283064365386963e-10f;  // 2^-32
constexpr float kFracScale = 4294967296.0f;           // 2^32
constexpr float kFracMax = 4294967040.0f;  // largest f32 below 2^32
constexpr float kBudgetMax = 2147483520.0f;  // 2^31 - 128

__device__ __forceinline__ bool is_nan(float x) { return x != x; }

// One lane of K4 against state[3, num_slots]; writes readback lane i of
// the u32[2, n] `out`: out[i] weighted prev, out[n + i] after.
__device__ __forceinline__ void sw_lane(uint32_t* __restrict__ state,
                                        long long num_slots, int32_t id,
                                        uint32_t hits, bool fresh,
                                        uint32_t divider, uint32_t now,
                                        uint32_t* __restrict__ out, int n,
                                        int i) {
  const long long slot = slot_index(id, num_slots);
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

// One lane of K5 against state[2, num_slots]; writes out[i], the budget.
__device__ __forceinline__ void gcra_lane(uint32_t* __restrict__ state,
                                          long long num_slots, int32_t id,
                                          uint32_t hits, uint32_t limit,
                                          bool fresh, uint32_t divider,
                                          uint32_t now,
                                          int32_t* __restrict__ out, int i) {
  const long long slot = slot_index(id, num_slots);
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

// -- the device form: the packed int32[5, n] batch in device memory ------

__global__ void sw_serve_step_kernel(uint32_t* __restrict__ state,
                                     long long num_slots,
                                     const int32_t* __restrict__ packed,
                                     int n, uint32_t now,
                                     uint32_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) {
    return;
  }
  sw_lane(state, num_slots, packed[i], static_cast<uint32_t>(packed[n + i]),
          packed[3 * n + i] != 0, static_cast<uint32_t>(packed[4 * n + i]),
          now, out, n, i);
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
  gcra_lane(state, num_slots, packed[i], static_cast<uint32_t>(packed[n + i]),
            static_cast<uint32_t>(packed[2 * n + i]), packed[3 * n + i] != 0,
            static_cast<uint32_t>(packed[4 * n + i]), now, out, i);
}

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

// -- the by-value form (by_value.cuh) -------------------------------------

// 20 B a lane: 2,560 B of lanes at 128, plus the header.
struct AlgoLanes {
  uint32_t* state;
  void* out;  // device alias of the caller's pinned readback
  long long num_slots;
  uint32_t now;
  int lanes;  // records past it are never read
  int4 lane[kMaxLanes];         // (slot, hits bits, limit bits, fresh)
  uint32_t divider[kMaxLanes];  // divider bits
};

static_assert(sizeof(AlgoLanes) <= kParamBytes,
              "the by-value batch must fit the 4 KB parameter space");

// Thread t serves lane t (__grid_constant__: indexed in place, as K1's).
__global__ void sw_serve_step_lanes_kernel(const __grid_constant__ AlgoLanes b) {
  const int t = threadIdx.x;
  if (t >= b.lanes) {
    return;
  }
  const int4 l = b.lane[t];
  sw_lane(b.state, b.num_slots, l.x, static_cast<uint32_t>(l.y), l.w != 0,
          b.divider[t], b.now, static_cast<uint32_t*>(b.out), b.lanes, t);
}

__global__ void gcra_serve_step_lanes_kernel(const __grid_constant__ AlgoLanes b) {
  const int t = threadIdx.x;
  if (t >= b.lanes) {
    return;
  }
  const int4 l = b.lane[t];
  gcra_lane(b.state, b.num_slots, l.x, static_cast<uint32_t>(l.y),
            static_cast<uint32_t>(l.z), l.w != 0, b.divider[t], b.now,
            static_cast<int32_t*>(b.out), t);
}

// Fill `b` from the HOST int32[5, n] words (1 <= n), transposed to one
// record a lane, and the device alias of the pinned readback `out`.
cudaError_t fill_lanes(AlgoLanes& b, void* state, long long num_slots,
                       const void* words, int n, int now, void* out) {
  if (n > kMaxLanes) {
    return cudaErrorInvalidValue;
  }
  const cudaError_t err = mapped_alias(out, &b.out);
  if (err != cudaSuccess) {
    return err;
  }
  b.state = static_cast<uint32_t*>(state);
  b.num_slots = num_slots;
  b.now = static_cast<uint32_t>(now);
  b.lanes = n;
  const int32_t* w = static_cast<const int32_t*>(words);
  for (int i = 0; i < n; ++i) {
    b.lane[i] = make_int4(w[i], w[n + i], w[2 * n + i], w[3 * n + i]);
    b.divider[i] = static_cast<uint32_t>(w[4 * n + i]);
  }
  return cudaSuccess;
}

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

// The by-value launchers.  `words` is the HOST address of the int32[5, n]
// batch (n <= kMaxLanes), copied into the launch, so the caller may reuse
// it as soon as this returns; `out` is the host address of pinned memory
// laid out as the device form's readback.  Returns the launch's error, or
// mapped_alias's where `out` has no device alias.
extern "C" int rl_sw_serve_step_lanes(void* state, long long num_slots,
                                      const void* words, int n, int now,
                                      void* out, void* stream) {
  if (n <= 0) {
    return 0;
  }
  AlgoLanes b;
  const cudaError_t err = fill_lanes(b, state, num_slots, words, n, now, out);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  sw_serve_step_lanes_kernel<<<1, lane_threads(n), 0,
                               static_cast<cudaStream_t>(stream)>>>(b);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rl_gcra_serve_step_lanes(void* state, long long num_slots,
                                        const void* words, int n, int now,
                                        void* out, void* stream) {
  if (n <= 0) {
    return 0;
  }
  AlgoLanes b;
  const cudaError_t err = fill_lanes(b, state, num_slots, words, n, now, out);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  gcra_serve_step_lanes_kernel<<<1, lane_threads(n), 0,
                                 static_cast<cudaStream_t>(stream)>>>(b);
  return static_cast<int>(cudaGetLastError());
}
