// The engine's device timing (backends/engine.py, _DeviceTimer): a pair of
// timing events around one chunk's launch, recorded while a gate holds
// the stream, so that the start event, the kernel and the end event run
// back to back once the host lets the stream go.  On a stream that is
// idle between chunks an ungated start event completes as soon as it is
// recorded, and the pair would time the host's whole enqueue of the
// launch (~100 us of Python) as well as the device work.
//
// The gate is the driver's cuStreamWaitValue32 on a pinned host word,
// found through the runtime (cudaGetDriverEntryPoint), so the library
// links nothing more than the others.  Each call below is one ctypes call
// on the launch path: rl_gate_open holds the stream and records the start
// event, rl_gate_close records the end event and lets the stream go.

#include <cstdint>

#include <cuda.h>
#include <cuda_runtime.h>

namespace {

using WaitValue32 = CUresult (*)(CUstream, CUdeviceptr, cuuint32_t, unsigned int);

WaitValue32 wait_value32() {
  static const WaitValue32 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuStreamWaitValue32", &p, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuStreamWaitValue32", &p, cudaEnableDefault, &status);
#endif
    return err == cudaSuccess && status == cudaDriverEntryPointSuccess
               ? reinterpret_cast<WaitValue32>(p)
               : nullptr;
  }();
  return fn;
}

// A not-ready answer is no error: leave no trace of it for the next
// launch's error check.
int answer(cudaError_t err) {
  if (err == cudaErrorNotReady) {
    (void)cudaGetLastError();
  }
  return static_cast<int>(err);
}

}  // namespace

// Two timing events (start, end) of the current device.
extern "C" int rl_timing_pair(void** start, void** end) {
  cudaEvent_t a = nullptr;
  cudaEvent_t b = nullptr;
  cudaError_t err = cudaEventCreate(&a);
  if (err == cudaSuccess) {
    err = cudaEventCreate(&b);
    if (err != cudaSuccess) {
      cudaEventDestroy(a);
    }
  }
  if (err == cudaSuccess) {
    *start = a;
    *end = b;
  }
  return static_cast<int>(err);
}

extern "C" int rl_timing_free(void* start, void* end) {
  const cudaError_t a = cudaEventDestroy(static_cast<cudaEvent_t>(start));
  const cudaError_t b = cudaEventDestroy(static_cast<cudaEvent_t>(end));
  return static_cast<int>(a != cudaSuccess ? a : b);
}

// Enqueue on `stream` a wait until `word` (the device alias of a pinned
// host word) reaches `ticket` (its bits as unsigned, compared cyclically:
// (int32_t)(*word - ticket) >= 0); then record `start`.  Returns 0, the
// driver's error, or cudaErrorNotSupported where the driver has no such
// wait.  Whatever it returns, the caller writes the ticket (rl_gate_close)
// once it has enqueued the launch.
extern "C" int rl_gate_open(void* stream, void* word, int ticket, void* start) {
  const WaitValue32 fn = wait_value32();
  if (fn == nullptr) {
    return static_cast<int>(cudaErrorNotSupported);
  }
  const CUresult r = fn(static_cast<CUstream>(stream), reinterpret_cast<CUdeviceptr>(word),
                        static_cast<cuuint32_t>(ticket), CU_STREAM_WAIT_VALUE_GEQ);
  if (r != CUDA_SUCCESS) {
    return static_cast<int>(r);
  }
  return static_cast<int>(cudaEventRecord(static_cast<cudaEvent_t>(start),
                                          static_cast<cudaStream_t>(stream)));
}

// Record `end` on `stream`, then write `ticket` to `host_word`: the
// stream held by rl_gate_open runs on.
extern "C" int rl_gate_close(void* stream, void* end, void* host_word, int ticket) {
  const cudaError_t err =
      cudaEventRecord(static_cast<cudaEvent_t>(end), static_cast<cudaStream_t>(stream));
  __atomic_store_n(static_cast<uint32_t*>(host_word), static_cast<uint32_t>(ticket),
                   __ATOMIC_RELEASE);
  return static_cast<int>(err);
}

// Nanoseconds from `start` to `end` into *ns (0 where not both are done);
// returns cudaEventElapsedTime's error.
extern "C" int rl_elapsed_ns(void* start, void* end, long long* ns) {
  float ms = 0.0f;
  const cudaError_t err = cudaEventElapsedTime(&ms, static_cast<cudaEvent_t>(start),
                                               static_cast<cudaEvent_t>(end));
  *ns = err == cudaSuccess ? static_cast<long long>(ms * 1e6) : 0;
  return answer(err);
}

// cudaEventQuery of `event`: 0 once done, cudaErrorNotReady before.
extern "C" int rl_event_query(void* event) {
  return answer(cudaEventQuery(static_cast<cudaEvent_t>(event)));
}
