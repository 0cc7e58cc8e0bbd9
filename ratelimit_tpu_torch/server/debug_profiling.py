"""Live-process introspection on the debug port.

Port of ratelimit_tpu/server/debug_profiling.py.  The reference serves
Go's net/http/pprof on its debug listener — index, CPU profile,
execution trace (reference src/server/server_impl.go:238-269).  Python
has no signal-based all-thread CPU profiler in the stdlib (cProfile is
per-thread), so the equivalents here are:

- ``GET /debug/threadz``            every thread's current stack (the
  goroutine-dump analog).
- ``GET /debug/profile?seconds=N``  statistical all-thread CPU
  profile: samples ``sys._current_frames()`` at ``hz`` (default 100)
  for N seconds and reports self/cumulative sample counts per
  function — the pprof-CPU analog, sampling like pprof does.
- ``GET /debug/xla_trace?seconds=N``  a ``torch.profiler`` capture of
  N seconds (host activity, and CUDA activity when the process holds a
  CUDA context: the kernels the dispatcher threads launch) written as
  a Chrome trace into the artifacts dir; the reply names the path.
  The path keeps the JAX package's name so operators' tooling works
  against either package; open the trace with Perfetto or
  chrome://tracing.

The two captures run one at a time: a contender answers 409.
"""

from __future__ import annotations

import os
import sys
import tempfile
import threading
import time
import traceback
from collections import Counter
from typing import Optional
from urllib.parse import parse_qs, urlsplit

_BLOCKING = threading.local()


class _AllowBlocking:
    """Context manager marking the CURRENT THREAD's blocking calls as
    sanctioned, with the justification at the call site (the JAX
    package's runtime lock sanitizer, analysis/sanitizer.py, reads the
    same mark; the port has no sanitizer yet).  Use it ONLY where
    holding a lock across the block is the design and nothing ever
    blocks on that lock (the one-capture-at-a-time gate below, whose
    contenders take ``acquire(blocking=False)`` and answer 409)."""

    __slots__ = ("why",)

    def __init__(self, why: str):
        if not why:
            raise ValueError("allow_blocking requires a justification")
        self.why = why

    def __enter__(self):
        _BLOCKING.depth = getattr(_BLOCKING, "depth", 0) + 1
        return self

    def __exit__(self, *exc) -> None:
        _BLOCKING.depth -= 1


def allow_blocking(why: str) -> _AllowBlocking:
    return _AllowBlocking(why)


def threadz_text() -> str:
    """All-thread stack dump (the goroutine dump analog)."""
    frames = sys._current_frames()
    out = []
    for t in threading.enumerate():
        out.append(
            f"--- thread {t.ident} name={t.name!r} "
            f"daemon={t.daemon} alive={t.is_alive()}\n"
        )
        fr = frames.get(t.ident)
        if fr is not None:
            out.extend(traceback.format_stack(fr))
        out.append("\n")
    return "".join(out)


def sample_cpu_profile(seconds: float, hz: int = 100) -> str:
    """Statistical all-thread CPU profile via sys._current_frames().

    Reports per-function sample counts: `self` (function on top of a
    stack) and `cum` (function anywhere on a stack) — the same two
    columns a pprof CPU profile leads with.  Sampling overhead is one
    frame walk per thread per tick; the sampler's own thread is
    excluded.
    """
    interval = 1.0 / max(1, hz)
    me = threading.get_ident()
    # Keyed by the (hashable, interned) code object during sampling;
    # human-readable ids are formatted once at report time — string
    # building per frame per tick would inflate the profiler's own
    # GIL-holding overhead inside the process it measures.
    self_counts: Counter = Counter()
    cum_counts: Counter = Counter()
    nticks = 0
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline:
        for tid, frame in sys._current_frames().items():
            if tid == me:
                continue
            seen = set()
            f = frame
            top = True
            while f is not None:
                code = f.f_code
                if top:
                    self_counts[code] += 1
                    top = False
                if code not in seen:
                    seen.add(code)
                    cum_counts[code] += 1
                f = f.f_back
        nticks += 1
        time.sleep(interval)

    def fid(code) -> str:
        return (
            f"{code.co_name} "
            f"({os.path.basename(code.co_filename)}:{code.co_firstlineno})"
        )

    total = sum(self_counts.values()) or 1
    lines = [
        f"# statistical cpu profile: {seconds}s at {hz}Hz, "
        f"{nticks} ticks, {total} thread-samples\n",
        f"{'self':>6} {'self%':>6} {'cum':>6}  function\n",
    ]
    for code, n in self_counts.most_common(60):
        lines.append(
            f"{n:>6} {100.0 * n / total:>5.1f}% "
            f"{cum_counts[code]:>6}  {fid(code)}\n"
        )
    return "".join(lines)


def _profile():
    """A torch.profiler session over host activity, and CUDA activity
    when the process holds a CUDA context, so the kernels launched on
    any thread (the dispatchers') are recorded."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities)


def torch_trace(trace_dir: str, seconds: float) -> None:
    """Capture `seconds` of this process into `trace_dir`/trace.json
    (Chrome trace format)."""
    with _profile() as prof:
        time.sleep(seconds)
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


def warm_torch_profiler() -> None:
    """Start and stop one empty session.  A process's first session
    imports torch.distributed and much of torch._dynamo and initializes
    kineto (and CUPTI on a card), holding the interpreter lock in
    stretches that can outlast a kernel deadline.  Paid during traffic,
    it stalls the dispatcher threads and the fault domain quarantines
    the banks; paid here, at boot, it costs no request anything."""
    with _profile():
        pass


def add_profiling_routes(
    server,
    artifacts_dir: Optional[str] = None,
    profiling_enabled: bool = False,
) -> None:
    """Mount /debug/threadz, /debug/profile, /debug/xla_trace (and a
    /debug/ and /debug/pprof/ index pointing at them).

    The two CAPTURE endpoints (profile, xla_trace) are refused with
    403 unless ``profiling_enabled`` (the DEBUG_PROFILING setting):
    both burn CPU / write artifacts in the live serving process, so
    they are an explicit operator opt-in, guarded one-capture-at-a-
    time.  threadz (a point-in-time stack read) stays always-on."""
    # tempfile.gettempdir() honors TMPDIR.
    artifacts = artifacts_dir or os.path.join(
        tempfile.gettempdir(), "ratelimit_tpu_torch_debug"
    )
    trace_lock = threading.Lock()
    if profiling_enabled:
        warm_torch_profiler()

    def _q(h, name: str, default: float, lo: float, hi: float) -> float:
        qs = parse_qs(urlsplit(h.path).query)
        try:
            v = float(qs.get(name, [default])[0])
        except ValueError:
            v = default
        return min(max(v, lo), hi)

    def threadz(h) -> None:
        h._reply(200, threadz_text().encode())

    def _gate(h) -> bool:
        if profiling_enabled:
            return True
        h._reply(
            403,
            b"profiling captures are disabled; start the server with "
            b"DEBUG_PROFILING=1 to enable /debug/profile and "
            b"/debug/xla_trace\n",
        )
        return False

    def profile(h) -> None:
        if not _gate(h):
            return
        seconds = _q(h, "seconds", 2.0, 0.1, 60.0)
        hz = int(_q(h, "hz", 100.0, 1.0, 1000.0))
        if not trace_lock.acquire(blocking=False):
            h._reply(409, b"a capture is already running\n")
            return
        try:
            with allow_blocking("one-capture-at-a-time gate; contenders get 409"):
                body = sample_cpu_profile(seconds, hz).encode()
        finally:
            trace_lock.release()
        # Reply AFTER release: replying first let a client's next
        # capture request race the handler thread to the lock and
        # draw a spurious 409.
        h._reply(200, body)

    def xla_trace(h) -> None:
        if not _gate(h):
            return
        seconds = _q(h, "seconds", 1.0, 0.1, 60.0)
        if not trace_lock.acquire(blocking=False):
            h._reply(409, b"a trace capture is already running\n")
            return
        try:
            trace_dir = os.path.join(artifacts, f"xla_trace_{time.time_ns()}")
            os.makedirs(trace_dir, exist_ok=True)
            with allow_blocking("one-capture-at-a-time gate; contenders get 409"):
                torch_trace(trace_dir, seconds)
            files = []
            for root, _dirs, names in os.walk(trace_dir):
                for name in names:
                    p = os.path.join(root, name)
                    files.append(
                        f"{os.path.getsize(p):>10} {os.path.relpath(p, trace_dir)}"
                    )
            status, body = 200, (
                f"trace written to {trace_dir}\n"
                + "\n".join(sorted(files))
                + "\nopen with: Perfetto (ui.perfetto.dev) or chrome://tracing\n"
            ).encode()
        except Exception as e:
            status, body = 500, f"trace capture failed: {e}\n".encode()
        finally:
            trace_lock.release()
        h._reply(status, body)  # after release, like profile()

    def debug_index(h) -> None:
        h._reply(200, render_debug_index(server).encode())

    server.add_route("GET", "/debug/threadz", threadz)
    server.add_route("GET", "/debug/profile", profile)
    server.add_route("GET", "/debug/xla_trace", xla_trace)
    server.add_route("GET", "/debug/", debug_index)
    # Historical alias (the Go pprof index path).
    server.add_route("GET", "/debug/pprof/", debug_index)


# One-line blurbs for the index page.  Endpoints registered WITHOUT a
# blurb still render (the index enumerates the live router, so it can
# never silently omit a route) — they just carry no description.
ENDPOINT_BLURBS = {
    "/stats": "counters/gauges/timers/histograms (plain text)",
    "/stats.json": "the same stat tree as JSON",
    "/metrics": "Prometheus text exposition (scrape target)",
    "/rlconfig": "current rate limit config dump",
    "/healthcheck": "liveness (200 OK / 500 NOT_HEALTHY)",
    "/debug/": "this index",
    "/debug/pprof/": "this index (Go pprof path alias)",
    "/debug/tracez": "slowest + most recent request traces",
    "/debug/hotkeys": "top-K hottest descriptor stems (JSON)",
    "/debug/faults": (
        "device-path fault domain: per-bank quarantine state, fault "
        "counters, restart history (JSON)"
    ),
    "/debug/events": (
        "lifecycle event journal, time-ordered with ?since= cursor (JSON)"
    ),
    "/debug/launches": (
        "per-launch device-batch timeline: phase durations + "
        "coalescing, ?since= cursor (JSON)"
    ),
    "/debug/timeseries": (
        "in-process capacity/latency history "
        "?since=&series=a,b (or ?summary=1 digest) (JSON)"
    ),
    "/debug/incidents": "captured anomaly incident reports (JSON)",
    "/debug/slo": "per-domain SLI / error-budget burn summary (JSON)",
    "/debug/overload": (
        "live overload-control state: shed floor, burns, promotion "
        "set, backpressure gate (JSON)"
    ),
    "/debug/flight": (
        "flight-ring capture ?format=jsonl|json (DEBUG_PROFILING=1)"
    ),
    "/debug/cluster": (
        "this replica's counter-handoff summary (JSON; admin POSTs "
        "under it need CLUSTER_HANDOFF_ENABLED=1)"
    ),
    "/debug/threadz": "all-thread stack dump",
    "/debug/profile": (
        "statistical CPU profile ?seconds=N (DEBUG_PROFILING=1)"
    ),
    "/debug/xla_trace": (
        "torch.profiler trace capture ?seconds=N (DEBUG_PROFILING=1)"
    ),
}


def render_debug_index(server) -> str:
    """The ``GET /debug/`` page, generated from the LIVE router: every
    registered GET route appears, so the index cannot drift from the
    handlers."""
    paths = sorted(
        path for method, path in server.router.routes if method == "GET"
    )
    lines = ["debug endpoints on this listener:"]
    for path in paths:
        lines.append(f"  {path:<22} {ENDPOINT_BLURBS.get(path, '')}".rstrip())
    return "\n".join(lines) + "\n"
