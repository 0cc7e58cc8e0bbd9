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
// Each lane is two halves: a gather of the slot's state rows (sw_gather,
// gcra_gather) and the compute, the scatter of the new rows and the
// narrow per-lane readback (sw_apply, gcra_apply) -- K4 u32[2, N]
// (weighted prev, after), K5 i32[N] (budget).  The engine dedups on the
// host, so live slots are unique and the scatter needs no atomics.
// Bound: K4 moves ~48 B per lane (16 packed in -- it never reads the
// limit row -- 12 gathered, 12 scattered, 8 out), K5 ~40 B (20 + 8 + 8 +
// 4): ~0.2 MB at 4096 lanes, far below what a launch costs, so the launch
// latency bounds both in device memory, as it does K1.  Each kernel has
// K1's three forms, chosen by the batch's shape alone (fixed_window.py
// lanes_by_value):
//
// - by value (by_value.cuh), for chunks of at most kMaxLanes lanes: one
//   20-byte record a lane in the launch's parameters, one thread a lane,
//   the readback into the caller's pinned host memory;
// - mapped (mapped.cuh), past it: the rows kernel reads the packed batch
//   from the caller's pinned host words through their device alias and
//   writes the readback there the same way, kMappedLanes lanes a thread,
//   every 16-byte row load before any gather and every gather before any
//   store (K4 loads 4 rows, 16 B a lane; K5 all 5, 20 B);
// - the device form: the same rows kernel on device pointers (the
//   JAX-named device-tensor API).
//
// So a served algorithm chunk of any width is one device activity instead
// of upload, kernel and readback copy.  Every form runs the same two
// halves, so they agree bit for bit.
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
#include "mapped.cuh"
#include "slot_index.cuh"

namespace {

constexpr uint32_t kU32Max = 0xFFFFFFFFu;
constexpr float kFracUnit = 2.3283064365386963e-10f;  // 2^-32
constexpr float kFracScale = 4294967296.0f;           // 2^32
constexpr float kFracMax = 4294967040.0f;  // largest f32 below 2^32
constexpr float kBudgetMax = 2147483520.0f;  // 2^31 - 128

__device__ __forceinline__ bool is_nan(float x) { return x != x; }

// K4's gather half: a lane's state rows at `slot` (-1: inert, reads 0).
struct SwRows {
  uint32_t win, curr, prev;
};

__device__ __forceinline__ SwRows sw_gather(const uint32_t* state,
                                            long long num_slots, long long slot) {
  if (slot < 0) {
    return SwRows{0u, 0u, 0u};
  }
  return SwRows{state[slot], state[num_slots + slot], state[2 * num_slots + slot]};
}

// K4's compute-and-scatter half against state[3, num_slots]: the new rows
// at `slot`, and the lane's readback, *wprev and *after.
__device__ __forceinline__ void sw_apply(uint32_t* __restrict__ state,
                                         long long num_slots, long long slot,
                                         SwRows g, uint32_t hits, bool fresh,
                                         uint32_t divider, uint32_t now,
                                         uint32_t* wprev, uint32_t* after) {
  const uint32_t w = now - now % divider;
  const bool same = g.win == w && !fresh;
  // w - divider wraps when w < divider; the wrapped value never equals
  // a stored window (sliding_window.py:91-94).
  const bool adjacent = g.win == w - divider && !fresh;
  const uint32_t new_prev = same ? g.prev : (adjacent ? g.curr : 0u);
  const uint32_t base = same ? g.curr : 0u;

  const uint32_t elapsed = now - w;
  const float frac = __fdiv_rn(__uint2float_rn(divider - elapsed),
                               __uint2float_rn(divider));
  *wprev = __float2uint_rz(floorf(__fmul_rn(__uint2float_rn(new_prev), frac)));

  uint32_t a = base + hits;
  if (a < base) {  // one u32 add wraps at most once: saturate
    a = kU32Max;
  }
  *after = a;
  if (slot >= 0) {
    state[slot] = w;
    state[num_slots + slot] = a;
    state[2 * num_slots + slot] = new_prev;
  }
}

// One lane of K4: readback lane i of the u32[2, n] `out`: out[i] weighted
// prev, out[n + i] after.
__device__ __forceinline__ void sw_lane(uint32_t* __restrict__ state,
                                        long long num_slots, int32_t id,
                                        uint32_t hits, bool fresh,
                                        uint32_t divider, uint32_t now,
                                        uint32_t* __restrict__ out, int n,
                                        int i) {
  const long long slot = slot_index(id, num_slots);
  sw_apply(state, num_slots, slot, sw_gather(state, num_slots, slot), hits,
           fresh, divider, now, &out[i], &out[n + i]);
}

// K5's gather half: the TAT at `slot`; an inert slot (-1) or a fresh lane
// reads 0 (the apply half writes a non-updating lane's rows back as read).
struct GcraRows {
  uint32_t sec, frac;
};

__device__ __forceinline__ GcraRows gcra_gather(const uint32_t* state,
                                                long long num_slots, long long slot,
                                                bool fresh) {
  if (slot < 0 || fresh) {
    return GcraRows{0u, 0u};
  }
  return GcraRows{state[slot], state[num_slots + slot]};
}

// K5's compute-and-scatter half against state[2, num_slots]: the new TAT
// at `slot`; returns the lane's budget.
__device__ __forceinline__ int32_t gcra_apply(uint32_t* __restrict__ state,
                                              long long num_slots, long long slot,
                                              GcraRows g, uint32_t hits,
                                              uint32_t limit, uint32_t divider,
                                              uint32_t now) {
  // Signed seconds from now to the TAT, by two's-complement wrap.
  const int32_t rel = static_cast<int32_t>(g.sec - now);
  const float d = __fadd_rn(__int2float_rn(rel),
                            __fmul_rn(__uint2float_rn(g.frac), kFracUnit));
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
    state[slot] = upd ? now + __float2uint_rz(floor_d) : g.sec;
    state[num_slots + slot] = upd ? __float2uint_rz(new_frac_f) : g.frac;
  }
  return __float2int_rz(budget);
}

// One lane of K5: out[i], the budget.
__device__ __forceinline__ void gcra_lane(uint32_t* __restrict__ state,
                                          long long num_slots, int32_t id,
                                          uint32_t hits, uint32_t limit,
                                          bool fresh, uint32_t divider,
                                          uint32_t now,
                                          int32_t* __restrict__ out, int i) {
  const long long slot = slot_index(id, num_slots);
  out[i] = gcra_apply(state, num_slots, slot, gcra_gather(state, num_slots, slot, fresh),
                      hits, limit, divider, now);
}

// -- the device and mapped forms (mapped.cuh): one rows kernel each ------
//
// Lanes [i0, i0 + kMappedLanes) of the packed int32[5, n] batch at
// `packed` (device memory, or the device alias of pinned host words) a
// thread, the readback into `out` (likewise).  A thread issues its row
// loads (K4: slot, hits, fresh, divider -- never the limit row; K5: all
// five), then every gather, then the compute, scatters and readback
// stores; lanes past n (the scalar path's tail) are inert: slot -1,
// divider and limit 1.

__global__ void sw_serve_step_rows_kernel(uint32_t* __restrict__ state,
                                          long long num_slots,
                                          const int32_t* __restrict__ packed,
                                          int n, uint32_t now,
                                          uint32_t* __restrict__ out, bool vec) {
  const int i0 = (blockIdx.x * blockDim.x + threadIdx.x) * kMappedLanes;
  if (i0 >= n) {
    return;
  }
  const int m = min(kMappedLanes, n - i0);
  const long long stride = n;
  int32_t id[kMappedLanes], hits[kMappedLanes], fresh[kMappedLanes], div[kMappedLanes];
  load_lanes(packed + i0, m, vec, id);
  load_lanes(packed + stride + i0, m, vec, hits);
  load_lanes(packed + 3 * stride + i0, m, vec, fresh);
  load_lanes(packed + 4 * stride + i0, m, vec, div, 1);
  long long slot[kMappedLanes];
  SwRows g[kMappedLanes];
#pragma unroll
  for (int j = 0; j < kMappedLanes; ++j) {
    slot[j] = j < m ? slot_index(id[j], num_slots) : -1;
    g[j] = sw_gather(state, num_slots, slot[j]);
  }
  uint32_t wprev[kMappedLanes], after[kMappedLanes];
#pragma unroll
  for (int j = 0; j < kMappedLanes; ++j) {
    sw_apply(state, num_slots, slot[j], g[j], static_cast<uint32_t>(hits[j]),
             fresh[j] != 0, static_cast<uint32_t>(div[j]), now, &wprev[j], &after[j]);
  }
  if (vec) {
    *reinterpret_cast<uint4*>(out + i0) = make_uint4(wprev[0], wprev[1], wprev[2], wprev[3]);
    *reinterpret_cast<uint4*>(out + stride + i0) =
        make_uint4(after[0], after[1], after[2], after[3]);
  } else {
    for (int j = 0; j < m; ++j) {
      out[i0 + j] = wprev[j];
      out[stride + i0 + j] = after[j];
    }
  }
}

__global__ void gcra_serve_step_rows_kernel(uint32_t* __restrict__ state,
                                            long long num_slots,
                                            const int32_t* __restrict__ packed,
                                            int n, uint32_t now,
                                            int32_t* __restrict__ out, bool vec) {
  const int i0 = (blockIdx.x * blockDim.x + threadIdx.x) * kMappedLanes;
  if (i0 >= n) {
    return;
  }
  const int m = min(kMappedLanes, n - i0);
  const long long stride = n;
  int32_t id[kMappedLanes], hits[kMappedLanes], limit[kMappedLanes], fresh[kMappedLanes],
      div[kMappedLanes];
  load_lanes(packed + i0, m, vec, id);
  load_lanes(packed + stride + i0, m, vec, hits);
  load_lanes(packed + 2 * stride + i0, m, vec, limit, 1);
  load_lanes(packed + 3 * stride + i0, m, vec, fresh);
  load_lanes(packed + 4 * stride + i0, m, vec, div, 1);
  long long slot[kMappedLanes];
  GcraRows g[kMappedLanes];
#pragma unroll
  for (int j = 0; j < kMappedLanes; ++j) {
    slot[j] = j < m ? slot_index(id[j], num_slots) : -1;
    g[j] = gcra_gather(state, num_slots, slot[j], fresh[j] != 0);
  }
  int32_t budget[kMappedLanes];
#pragma unroll
  for (int j = 0; j < kMappedLanes; ++j) {
    budget[j] = gcra_apply(state, num_slots, slot[j], g[j], static_cast<uint32_t>(hits[j]),
                           static_cast<uint32_t>(limit[j]), static_cast<uint32_t>(div[j]),
                           now);
  }
  if (vec) {
    *reinterpret_cast<int4*>(out + i0) = make_int4(budget[0], budget[1], budget[2], budget[3]);
  } else {
    for (int j = 0; j < m; ++j) {
      out[i0 + j] = budget[j];
    }
  }
}

// A rows kernel: sw_serve_step_rows_kernel (Out uint32_t) or
// gcra_serve_step_rows_kernel (Out int32_t).
template <class Out>
using RowsKernel = void (*)(uint32_t*, long long, const int32_t*, int, uint32_t, Out*, bool);

// The rows launch of `kernel` over n lanes: `packed` (int32[5, n]) and
// `out` are addresses the device reads and writes, device memory or
// device aliases.
template <class Out>
int launch_algo_rows(RowsKernel<Out> kernel, void* state, long long num_slots,
                     const void* packed, int n, int now, void* out, void* stream) {
  if (n <= 0) {
    return 0;
  }
  kernel<<<mapped_blocks(n), kMappedThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(state), num_slots, static_cast<const int32_t*>(packed), n,
      static_cast<uint32_t>(now), static_cast<Out*>(out), mapped_vec(n, packed, out));
  return static_cast<int>(cudaGetLastError());
}

// The mapped launch: `words` (int32[5, n]) and `out` are HOST addresses of
// pinned memory, each reached through its device alias (mapped_aliases's
// error where one has none).  The kernel reads the words while it runs,
// so the caller keeps them until the stream passes it.
template <class Out>
int launch_algo_mapped(RowsKernel<Out> kernel, void* state, long long num_slots,
                       const void* words, int n, int now, void* out, void* stream) {
  if (n <= 0) {
    return 0;
  }
  void* dev_words = nullptr;
  void* dev_out = nullptr;
  const cudaError_t err = mapped_aliases(words, out, &dev_words, &dev_out);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  return launch_algo_rows(kernel, state, num_slots, dev_words, n, now, dev_out, stream);
}

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

// The device form: `packed` (int32[5, n]) and `out` in device memory.
extern "C" int rl_sw_serve_step(void* state, long long num_slots,
                                const void* packed, int n, int now, void* out,
                                void* stream) {
  return launch_algo_rows<uint32_t>(sw_serve_step_rows_kernel, state, num_slots, packed, n, now,
                                    out, stream);
}

extern "C" int rl_gcra_serve_step(void* state, long long num_slots,
                                  const void* packed, int n, int now,
                                  void* out, void* stream) {
  return launch_algo_rows<int32_t>(gcra_serve_step_rows_kernel, state, num_slots, packed, n, now,
                                   out, stream);
}

// The mapped form: `words` (int32[5, n]) and `out` (laid out as the
// device form's readback) are host addresses of pinned memory.  Returns
// the launch's error, or mapped_alias's where one has no device alias.
extern "C" int rl_sw_serve_step_mapped(void* state, long long num_slots,
                                       const void* words, int n, int now,
                                       void* out, void* stream) {
  return launch_algo_mapped<uint32_t>(sw_serve_step_rows_kernel, state, num_slots, words, n, now,
                                      out, stream);
}

extern "C" int rl_gcra_serve_step_mapped(void* state, long long num_slots,
                                         const void* words, int n, int now,
                                         void* out, void* stream) {
  return launch_algo_mapped<int32_t>(gcra_serve_step_rows_kernel, state, num_slots, words, n, now,
                                     out, stream);
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
