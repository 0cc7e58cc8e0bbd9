"""Micro-batching dispatcher: the implicit-pipelining analog.

Port of ratelimit_tpu/backends/dispatcher.py.  The launch/complete
split maps onto the torch engine's CUDA stream and events: the
collector's launch enqueues copies and the kernel on the engine stream
and returns; the completer waits on the submission's event.  Each side
stamps when its device call begins (the watchdog seam of the device
fault domain, backends/fault_domain.py): a kernel stalled on the card
holds the completer inside that event wait, and a stamp older than the
kernel deadline quarantines the bank.  With a launch flight recorder
attached (observability/launches.py), each launch leaves one record:
``launch_ns`` from submit_items entry until the kernel is enqueued on
the stream, ``complete_ns`` from the start of the event wait through
decide and scatter, stamped on the completer after the event has
completed.  A record that fails to stamp is logged and dropped; it
never fails the launch.

The reference gets cross-request batching for free from radix's
implicit pipelining (one Redis round trip aggregates commands from
concurrent goroutines within a flush window — reference
src/settings/settings.go:71-77, src/redis/driver_impl.go:94-99).  Here
the expensive round trip is a device launch, so the dispatcher plays
radix's role: concurrent RPC threads submit work items; a single
dispatcher thread accumulates them up to ``batch_window`` /
``batch_limit`` lanes, assembles ONE padded device batch, runs the
engine step, and scatters the decisions back to the waiting threads.

The dispatcher thread is also the only toucher of the engine's
SlotTable, so key->slot assignment needs no locks (SURVEY.md section 2
in-process concurrency row: single dispatcher owning the device queue).

``flush()`` drains everything submitted before it — the deterministic
test hook the reference implements as Flush()/AutoFlushForIntegration-
Tests for its async memcache writes (src/memcached/cache_impl.go:54,
176-178).
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from ..observability.launches import OUTCOME_FAULT, OUTCOME_OK
from ..utils.time import REAL_MONOTONIC
from .engine import HostDecisions

logger = logging.getLogger("ratelimit.dispatcher")


@dataclass(frozen=True)
class Lane:
    """One descriptor bound for the counter engine."""

    key: str
    expiry: int
    limit: int
    shadow: bool
    hits: int


# One record per lane: every per-lane scalar the engine needs, in a
# single structured array so the collector concatenates ONE array per
# item instead of five (np.concatenate cost is per-piece, and a 4096-
# lane batch is ~1k pieces).  Layout is C-friendly: i64 at offset 0,
# u32s after — 32 bytes, naturally aligned.  `divider` (window length
# in seconds) is consumed only by generic-algorithm engine banks
# (models/registry.py); fixed-window lanes stamp 0.  `algo` is the
# registry algo_id of the lane's algorithm — fixed-window lanes
# stamp 0, and today it exists for checkpoint/debug symmetry (banks
# are per-algorithm, so routing never reads it per lane).
LANE_DTYPE = np.dtype(
    [
        ("expiry", "<i8"),
        ("hits", "<u4"),
        ("limits", "<u4"),
        ("len", "<u4"),  # utf-8 byte length of this lane's key
        ("shadow", "<u4"),  # 0/1
        ("divider", "<u4"),  # window length in seconds (0 = unused)
        ("algo", "<u4"),  # models/registry.py algo_id
    ]
)


@dataclass
class LanePack:
    """One request's engine-bound lanes as pre-packed arrays.

    Built on the RPC thread (cuda_cache._make_item), so the dispatcher's
    serial collector never walks lanes in Python — it concatenates
    blobs/meta and hands them to the engine's fused native call
    (engine.submit_packed).  Keys are pre-encoded utf-8, concatenated;
    per-lane scalars live in one LANE_DTYPE record array.
    """

    key_blob: bytes
    meta: np.ndarray  # LANE_DTYPE[n]
    # uint8 view of `meta`, precomputed on the RPC thread: structured-
    # dtype np.concatenate takes a slow path (~9x), so the collector
    # concatenates raw u8 views and reinterprets once.
    meta_u8: np.ndarray = None  # type: ignore[assignment]

    def __post_init__(self):
        if self.meta_u8 is None:
            self.meta_u8 = self.meta.view(np.uint8)

    @property
    def count(self) -> int:
        return len(self.meta)

    @staticmethod
    def from_lanes(lanes: Sequence[Lane]) -> "LanePack":
        enc = [lane.key.encode("utf-8") for lane in lanes]
        n = len(enc)
        meta = np.empty(n, dtype=LANE_DTYPE)
        for j, (lane, b) in enumerate(zip(lanes, enc)):
            meta[j] = (
                lane.expiry,
                min(lane.hits, 0xFFFFFFFF),
                lane.limit,
                len(b),
                1 if lane.shadow else 0,
                0,  # divider: Lane is the fixed-window compat surface
                0,  # algo: fixed_window
            )
        return LanePack(key_blob=b"".join(enc), meta=meta)


@dataclass
class WorkItem:
    """One request's engine-bound lanes + completion callback.

    Either `lanes` (test/compat surface) or a pre-built `pack` (the
    serving path); `get_pack()` converts lazily.
    """

    now: int
    lanes: Sequence[Lane]
    apply: Callable[[HostDecisions], None]
    pack: Optional[LanePack] = None
    # Called (with the exception) when the item fails WITHOUT apply()
    # ever running — the seam for backends that never wait on the item
    # (write-behind drains its pending-hit accounting here; a silent
    # skip would inflate its decisions for the rest of the window).
    on_error: Optional[Callable[[BaseException], None]] = None
    # True (sync serving path): the completer only parks a
    # (batch_decisions, lo, hi) reference in `result` and signals;
    # slicing + apply() then run inside wait() on the waiting RPC
    # thread.  Status assembly AND per-item slicing were the
    # completer's largest serial legs (~4ms + ~4ms per 4096-lane/1024-
    # item batch, benchmarks/results/host_path.json) — on waiter
    # threads they parallelize across the RPC pool and overlap the
    # next batch's launch.  Backends that never wait (write-behind)
    # keep the default: their apply still runs on the completer.
    defer_apply: bool = False
    result: Optional[tuple] = None  # (HostDecisions, lo, hi)
    # Optional per-stage timestamp sink: when set, the pipeline stamps
    # perf_counter() at "launch" (collector hands the batch to the
    # device) and "complete" (readback+decide done, waiter signalled).
    # The submitter owns "submit"/"applied".  Powers the closed-loop
    # latency harness (benchmarks/closed_loop_p99.py) and, in serving,
    # the request tracer: the cache sets it on SAMPLED requests and
    # converts the stamps to dispatch/kernel spans after wait()
    # (observability/trace.py).  None on the unsampled hot path.
    trace: Optional[dict] = None
    # Launch-recorder stamps (observability/launches.py), set only
    # when a recorder is attached to the receiving dispatcher:
    # `submit_ns` is monotonic_ns at intake (the queue-wait baseline);
    # `corr` carries the request's correlation id so the launch record
    # can name its longest-queued rider.  Both stay 0 on the
    # recorder-off path.
    submit_ns: int = 0
    corr: int = 0
    event: threading.Event = field(default_factory=threading.Event)
    error: Optional[BaseException] = None

    @property
    def n_lanes(self) -> int:
        return self.pack.count if self.pack is not None else len(self.lanes)

    def get_pack(self) -> LanePack:
        if self.pack is None:
            # Lazy conversion has ONE toucher: the serving path
            # pre-builds pack on the RPC thread before submit; only
            # the collector converts lanes-based (test/compat) items.
            self.pack = LanePack.from_lanes(self.lanes)  # tpu-lint: disable=shared-state -- single lazy toucher (collector)
        return self.pack

    def fail(self, exc: BaseException) -> None:
        """Mark failed (apply never ran): set error, fire on_error
        best-effort, release the waiter."""
        self.error = exc
        if self.on_error is not None:
            try:
                self.on_error(exc)
            except Exception:
                pass
        self.event.set()

    def wait(self, timeout: float = 30.0) -> None:
        # The timeout is a liveness backstop: if the dispatcher died
        # between submit and processing (e.g. shutdown race), fail the
        # RPC instead of hanging the transport thread forever.
        if not self.event.wait(timeout):
            raise TimeoutError(
                f"batch dispatcher did not answer within {timeout}s"
            )
        if self.error is not None:
            raise self.error
        if self.defer_apply and self.result is not None:
            # Deferred slicing + status assembly: runs HERE, on the
            # waiting RPC thread (see defer_apply).  apply() errors
            # propagate to the caller exactly like completer-side
            # apply errors.
            (decisions, lo, hi), self.result = self.result, None
            self.apply(_slice(decisions, lo, hi))


class _FlushToken:
    __slots__ = ("event",)

    def __init__(self):
        self.event = threading.Event()


class _CallToken:
    """Run an arbitrary fn on the dispatcher thread (the slot-table
    owner) — used for consistent checkpoints without a serving lock.
    A ``device_call`` is stamped like a launch while it runs, so a call
    that waits on a stalled stream shows in ``stuck_age``."""

    __slots__ = ("fn", "event", "error", "device_call")

    def __init__(self, fn, device_call=False):
        self.fn = fn
        self.event = threading.Event()
        self.error = None
        self.device_call = device_call


_STOP = object()

#: How often run_on_thread polls its `abandon` predicate while it waits.
_ABANDON_POLL_S = 0.01


class DispatcherDead(RuntimeError):
    """The dispatcher's collector or completer thread has died; the
    backend is gone until restart (the Redis analog: a driver whose
    pool has zero active connections, driver_impl.go:31-52)."""


def _slice(d: HostDecisions, lo: int, hi: int) -> HostDecisions:
    # Positional construction (field order = dataclass order): this
    # runs per waiting request, so no getattr/dict-comprehension.
    return HostDecisions(
        d.codes[lo:hi],
        d.limit_remaining[lo:hi],
        d.befores[lo:hi],
        d.afters[lo:hi],
        d.over_limit[lo:hi],
        d.near_limit[lo:hi],
        d.within_limit[lo:hi],
        d.shadow_mode[lo:hi],
        d.set_local_cache[lo:hi],
    )


def submit_items(engine, items: List[WorkItem]):
    """Assemble one engine batch from `items` and LAUNCH it (no wait).

    Must be called from the single thread that owns `engine`'s
    SlotTable.  Returns the engine token for complete_items, or None
    if the batch failed (items are already errored+signalled) or was
    empty (items signalled).

    The serial work here is pure concatenation: each item arrives with a
    pre-packed LanePack (built on its RPC thread), and slot assignment
    + dedup happen in ONE fused native call inside submit_packed.
    """
    try:
        # Single walk over items: gather blobs/meta views and the max
        # `now` (which only drives gc/eviction; items in one batch
        # differ by at most the batch window).
        blobs = []
        metas = []
        now = None
        traces = []
        for it in items:
            p = it.get_pack()
            blobs.append(p.key_blob)
            metas.append(p.meta_u8)
            if now is None or it.now > now:
                now = it.now
            if it.trace is not None:
                traces.append(it.trace)
        if len(metas) == 1:
            blob, meta = blobs[0], items[0].pack.meta
        elif metas:
            blob = b"".join(blobs)
            meta = np.concatenate(metas).view(LANE_DTYPE)
        else:
            meta = ()
        if len(meta) == 0:
            for it in items:
                it.event.set()
            return None
        token = engine.submit_packed(now, blob, meta)
        if traces:
            # Stamped AFTER submit_packed returns: "launch" means the
            # device step is in flight — host-side assign/dedup/
            # transfer cost lands in intake->launch, so the
            # launch->complete stage is purely the device leg +
            # readback + decide (the part that moves to the chip on
            # real hardware).
            t_launch = time.perf_counter()
            for tr in traces:
                tr["launch"] = t_launch
        return token
    except BaseException as e:
        for it in items:
            it.fail(e)
        return _SUBMIT_FAILED


_SUBMIT_FAILED = object()  # device-step launch failure (vs None = empty)


def complete_items(engine, items: List[WorkItem], token) -> bool:
    """Wait for a submit_items launch, scatter decisions, signal
    waiters.  Thread-agnostic (touches no engine state).  Returns
    False when the device step failed (launch or readback)."""
    if token is None:
        return True  # empty batch
    if token is _SUBMIT_FAILED:
        return False  # submit already errored the items
    try:
        decisions = engine.step_complete(token)
    except BaseException as e:
        for it in items:
            it.fail(e)
        return False
    off = 0
    t_complete = None
    for it in items:
        n = it.n_lanes
        end = off + n
        if it.defer_apply:
            # Park a reference + bounds; the waiting RPC thread does
            # the slicing, list conversion and apply after event.set —
            # the completer's serial leg is just signalling.
            it.result = (decisions, off, end)
        else:
            try:
                it.apply(_slice(decisions, off, end))
            except BaseException as e:
                it.error = e
        off = end
        if it.trace is not None:
            if t_complete is None:
                t_complete = time.perf_counter()
            it.trace["complete"] = t_complete
        it.event.set()
    return True


def run_items(engine, items: List[WorkItem]) -> bool:
    """Synchronous submit+complete (inline mode, tests)."""
    return complete_items(engine, items, submit_items(engine, items))


class BatchDispatcher:
    """Two-stage pipelined dispatcher for one engine.

    The COLLECTOR thread owns the slot table and the device queue: it
    accumulates WorkItems (window/limit), assigns slots, and LAUNCHES
    the device step without waiting.  The COMPLETER thread waits on
    each launch's readback in order and answers the waiting RPCs.  Up
    to `pipeline_depth` launches are in flight, so the device->host
    transfer of batch N overlaps the collection+launch of batch N+1 —
    on a high-RTT link this multiplies request-response throughput by
    the pipeline depth (the counts donation chain keeps the compute
    order correct on device regardless).
    """

    def __init__(
        self,
        engine,
        batch_window_us: int = 200,
        batch_limit: int = 4096,
        name: str = "cuda-dispatcher",
        pipeline_depth: int = 2,
        unhealthy_after: int = 3,
        on_state=None,
        eager_idle: bool = True,
        stamp_clock=None,
    ):
        """`on_state(healthy: bool, reason: str)` is the backend-health
        seam (the Redis pool active-connection health analog,
        driver_impl.go:31-52 + settings.go:91-92): called with False
        after `unhealthy_after` CONSECUTIVE device-step failures or on
        dispatcher-thread death, and with True when a later step
        succeeds.  0 disables failure counting (death still reports)."""
        self.engine = engine
        self.window_s = batch_window_us / 1e6
        self.batch_limit = int(batch_limit)
        self.unhealthy_after = int(unhealthy_after)
        self.on_state = on_state
        # Launch the first item immediately when nothing else is
        # queued AND nothing is in flight: the batch window exists to
        # aggregate CONCURRENT arrivals (radix's implicit pipelining
        # flushes an idle pipeline immediately too); making a lone
        # request at idle wait out the window is pure latency tax
        # (~window + wakeup overshoot off the wire p50).  Under load
        # the in-flight check fails and the window shapes batches
        # exactly as before.
        self.eager_idle = bool(eager_idle)
        self._inflight = 0  # launches handed to the completer, not yet done
        self._inflight_hwm = 0  # high-water mark of the above
        # Intake high-water mark, written only by the collector under
        # the intake cv (one max() per drain swap, not per item).
        self._queue_hwm = 0
        # Same mark but resettable: the anomaly sampler drains it each
        # tick (queue_hwm_drain), so a between-scrapes burst is a
        # per-tick number instead of a forever-latched maximum.
        self._queue_hwm_tick = 0
        # Batch-shape histograms (stats.Histogram or None), wired by
        # CudaRateLimitCache.register_stats; observed once per launch
        # on the collector thread.  Lanes/items counts, not ms.
        self.batch_lanes_hist = None
        self.batch_items_hist = None
        # Largest launch so far, in lanes (collector-written gauge).
        self.max_launch_lanes = 0
        # Launch flight recorder (observability/launches.py), attached
        # by CudaRateLimitCache.attach_launch_recorder together with
        # this dispatcher's bank index and algorithm id.  None = off (one
        # attribute load + branch per LAUNCH, never per item).  The meta
        # deque carries the collector's per-launch measurements (shape,
        # queue wait, launch duration, corr) to the completer in
        # completion-queue order: one FIFO producer, one FIFO consumer,
        # so entry k always meets its own batch.
        self.launches = None
        self.launch_bank = 0
        self.launch_algo = 0
        self._launch_meta: deque = deque()
        # Proactive slot-table gc: without it, expired keys linger in
        # the table until the free list empties (Redis expires keys
        # lazily too, but also actively samples; fixed 10-key-space
        # traffic would otherwise hold the map/heap at table-capacity
        # high-water forever and skew the live_keys gauge).  Runs on
        # the collector (the table's owner), clocked by the ITEMS' own
        # time source (tests pin time; wall clock would mass-expire
        # their keys).
        self.gc_interval_s = 5.0
        self._last_item_now = None
        self._next_gc_monotonic = time.monotonic() + self.gc_interval_s
        self._state_lock = threading.Lock()
        self._consecutive_failures = 0
        self._reported_unhealthy = False
        self._dead: Optional[BaseException] = None
        # Watchdog liveness stamps (backends/fault_domain.py): the
        # collector marks when a device LAUNCH begins, the completer
        # when a readback WAIT (the event synchronize) begins; each
        # clears its own stamp when the call returns.  Single-writer
        # plain attributes read lock-free by the watchdog thread.
        # `stamp_clock` is the injectable MonotonicClock seam, so
        # hang-detection tests run on synthetic time.
        self._stamp_now = (stamp_clock or REAL_MONOTONIC).now
        self._launch_busy_since: Optional[float] = None
        self._complete_busy_since: Optional[float] = None
        # Successful device-step completions: the watchdog arms the
        # kernel deadline only after the first one, so a first launch
        # that builds the kernels with nvcc never reads as a hang.
        self.completed_launches = 0
        # Intake is a plain list + condition variable, drained by the
        # collector in ONE swap per wakeup: queue.Queue pays a lock
        # acquisition per get (~0.8 ms per 1024-item batch on the
        # serial collector thread); the swap costs one.
        self._buf: list = []
        self._buf_cv = threading.Condition()
        # Bounded: backpressure keeps at most pipeline_depth launches
        # in flight ahead of the completer.
        self._completion_q: "queue.Queue" = queue.Queue(
            maxsize=max(1, int(pipeline_depth))
        )
        self._thread = threading.Thread(
            target=self._collect_loop, name=name, daemon=True
        )
        self._completer = threading.Thread(
            target=self._complete_loop, name=name + "-complete", daemon=True
        )
        self._thread.start()
        self._completer.start()

    @property
    def dead(self) -> Optional[BaseException]:
        return self._dead

    def _enqueue(self, obj) -> None:
        # Check-dead and append under the ONE cv lock so an entry can
        # never slip in after the death drain (it would hang its RPC
        # for the full wait timeout).
        with self._buf_cv:
            if self._dead is not None:
                # Fast-fail instead of letting the RPC burn its full
                # wait timeout against a dispatcher that will never
                # answer.
                raise DispatcherDead(
                    f"batch dispatcher is dead: {self._dead!r}"
                ) from self._dead
            self._buf.append(obj)
            self._buf_cv.notify()

    def queue_depth(self) -> int:
        """Entries awaiting collection (stats gauge)."""
        return len(self._buf)

    def queue_depth_hwm(self) -> int:
        """Deepest intake drain seen (stats gauge): how far behind
        the collector has ever been — the backpressure early-warning
        the instantaneous queue_depth (usually 0 at scrape time)
        cannot show."""
        return self._queue_hwm

    def inflight(self) -> int:
        """Launches handed to the completer, not yet completed (the
        completion-queue occupancy; capped at pipeline_depth)."""
        return self._inflight

    def inflight_hwm(self) -> int:
        """High-water mark of in-flight launches: pipeline_depth is
        saturated when this pins at the configured depth."""
        return self._inflight_hwm

    def queue_hwm_drain(self) -> int:
        """Deepest intake drain since the LAST call, reset on read
        (the queue-saturation detector's per-tick input,
        observability/detectors.py).  Includes the current intake depth
        so a still-growing backlog registers before the collector swaps
        it."""
        with self._buf_cv:
            v = self._queue_hwm_tick
            self._queue_hwm_tick = 0
            return max(v, len(self._buf))

    def submit(self, item: WorkItem) -> None:
        if self.launches is not None:
            # Queue-wait baseline for the launch record.
            item.submit_ns = time.monotonic_ns()
        self._enqueue(item)

    def flush(self) -> None:
        """Block until everything submitted before this call has been
        processed (FIFO intake: the token trails all earlier items)."""
        token = _FlushToken()
        self._enqueue(token)
        token.event.wait()

    def run_on_thread(self, fn, timeout: float = 120.0, device_call: bool = False,
                      abandon=None):
        """Execute `fn()` on the dispatcher thread, after everything
        already queued; blocks for the result.  `device_call` stamps the
        call like a launch while it runs (a copy that waits on the
        bank's stream).  `abandon`, a predicate polled while waiting,
        gives up early: TimeoutError as at `timeout`, and the call still
        runs when its turn comes."""
        token = _CallToken(fn, device_call)
        self._enqueue(token)
        if abandon is None:
            done = token.event.wait(timeout)
        else:
            give_up = time.monotonic() + timeout
            done = token.event.wait(_ABANDON_POLL_S)
            while not done and time.monotonic() < give_up and not abandon():
                done = token.event.wait(_ABANDON_POLL_S)
        if not done:
            raise TimeoutError("dispatcher did not run the call in time")
        if token.error is not None:
            raise token.error

    def stuck_age(self, now: float) -> float:
        """Seconds the oldest in-progress device call (launch or
        readback wait) has been running, 0.0 when idle.  Lock-free
        reads of the single-writer stamps; `now` must come from the
        same clock as `stamp_clock`."""
        age = 0.0
        for since in (self._launch_busy_since, self._complete_busy_since):
            if since is not None and now - since > age:
                age = now - since
        return age

    def kill(self, exc: BaseException) -> None:
        """Abandon this dispatcher WITHOUT joining its threads: mark
        dead, fail everything queued or waiting for completion, report
        unhealthy.  The quarantine path uses this: a completer held in
        the event wait of a stalled stream cannot be joined (a CUDA
        stream cannot be cancelled), but the waiters must be released
        and new submits must fast-fail, so the fallback answers them.
        The threads are told to stop: each exits once its current call
        returns (the completer when the stall ends)."""
        self._die(exc)
        with self._buf_cv:
            self._buf.append(_STOP)
            self._buf_cv.notify()

    def exited(self) -> bool:
        """Whether both threads have returned (after kill or stop)."""
        return not (self._thread.is_alive() or self._completer.is_alive())

    def stop(self, timeout: float = 10.0) -> None:
        with self._buf_cv:
            # No dead gate: stop must always reach the collector.
            self._buf.append(_STOP)
            self._buf_cv.notify()
        self._thread.join(timeout=timeout)
        self._completer.join(timeout=timeout)

    # -- internals -------------------------------------------------------

    def _collect(self) -> Tuple[List[WorkItem], List[_FlushToken], bool]:
        """Block for the first entry, then accumulate until the window
        closes, the lane budget fills, or a flush/stop arrives.

        Entries are drained in whole-buffer SWAPS (one lock hold per
        wakeup, not per item); anything past a budget/token/stop cut
        is pushed back to the intake front, order preserved."""
        batch: List[WorkItem] = []
        tokens: List[_FlushToken] = []
        stopping = False
        lanes = 0
        deadline = None
        # Hot-loop hoist (tpu-lint hot-path-cost): the cv once per
        # _collect, not one attribute probe per wakeup.  `self._buf`
        # itself must stay an attribute read — _die() (on the
        # completer thread) swaps the list object under the cv, so a
        # hoisted alias could drain a buffer nobody owns anymore.
        buf_cv = self._buf_cv

        while True:
            with buf_cv:
                while not self._buf:
                    if deadline is None:
                        buf_cv.wait()  # idle: block for work
                    else:
                        timeout = deadline - time.monotonic()
                        if timeout <= 0 or not buf_cv.wait(timeout):
                            if not self._buf:
                                return batch, tokens, stopping
                drained = self._buf  # tpu-lint: disable=hot-path-cost -- self._buf is re-read at every use on purpose: _die() swaps the list object
                self._buf = []
                n_drained = len(drained)
                if n_drained > self._queue_hwm:
                    self._queue_hwm = n_drained
                if n_drained > self._queue_hwm_tick:
                    self._queue_hwm_tick = n_drained

            cut = None
            try:
                for i, obj in enumerate(drained):
                    if obj is _STOP:
                        stopping = True
                        cut = i + 1
                        break
                    if isinstance(obj, (_FlushToken, _CallToken)):
                        tokens.append(obj)
                        cut = i + 1
                        break  # flush/call short-circuits the window
                    batch.append(obj)
                    lanes += obj.n_lanes
                    if lanes >= self.batch_limit:
                        cut = i + 1
                        break
            except BaseException:
                # A bad entry crashed classification: everything this
                # swap took out of the shared buffer would otherwise be
                # orphaned in these locals — _die() can only fail what
                # it can see.  Push it all back before propagating.
                with buf_cv:
                    self._buf[:0] = batch + tokens + list(drained[i:])
                raise
            if cut is not None and cut < len(drained):
                with buf_cv:
                    self._buf[:0] = drained[cut:]
            if stopping or tokens or lanes >= self.batch_limit:
                return batch, tokens, stopping
            if deadline is None:
                if (
                    self.eager_idle
                    and batch
                    and not self._buf
                    and self._inflight == 0
                ):
                    # Idle system, lone arrival: launch now.  The
                    # lock-free _buf/_inflight reads race benignly — a
                    # missed just-arrived item rides the next batch.
                    return batch, tokens, stopping
                deadline = time.monotonic() + self.window_s
            elif time.monotonic() >= deadline:
                return batch, tokens, stopping

    def _launch(self, batch: List[WorkItem]) -> None:
        """Launch on the collector thread, hand to the completer."""
        lanes_total = sum(it.n_lanes for it in batch)
        if lanes_total > self.max_launch_lanes:
            self.max_launch_lanes = lanes_total
        if self.batch_lanes_hist is not None:
            # One observe per LAUNCH (not per item).
            self.batch_lanes_hist.observe(lanes_total)
        if self.batch_items_hist is not None:
            self.batch_items_hist.observe(len(batch))
        lr = self.launches
        queue_wait = corr = t0 = 0
        if lr is not None:
            # Launch-record front half: queue_wait is oldest submit ->
            # here; the oldest item's corr joins the record to the
            # request rings.  Once per LAUNCH, on this thread only.
            t0 = time.monotonic_ns()
            oldest = 0
            for it in batch:
                s = it.submit_ns
                if s and (oldest == 0 or s < oldest):
                    oldest = s
                    corr = it.corr
            if oldest:
                queue_wait = t0 - oldest
        self._launch_busy_since = self._stamp_now()
        try:
            token = submit_items(self.engine, batch)
        finally:
            self._launch_busy_since = None
        if token is _SUBMIT_FAILED:
            if lr is not None:
                self._record_launch(
                    lr,
                    lanes_total,
                    len(batch),
                    int(getattr(self.engine, "stat_dedup_groups", 0)),
                    queue_wait,
                    time.monotonic_ns() - t0,
                    0,
                    OUTCOME_FAULT,
                    corr,
                )
            self._note_step(False)
        elif token is not None:
            if lr is not None:
                # Appended strictly before the matching _put_completion:
                # the completer poplefts one entry per batch.
                self._launch_meta.append(  # tpu-lint: disable=shared-state -- deque append/popleft are GIL-atomic; one FIFO producer (collector) and one FIFO consumer (completer)
                    (
                        lanes_total,
                        len(batch),
                        int(getattr(self.engine, "stat_dedup_groups", 0)),
                        queue_wait,
                        time.monotonic_ns() - t0,
                        corr,
                    )
                )
            with self._state_lock:
                self._inflight += 1
                if self._inflight > self._inflight_hwm:
                    self._inflight_hwm = self._inflight
            self._put_completion(("batch", batch, token))

    def _put_completion(self, entry) -> None:
        """Bounded put that fails entries fast if the completer dies
        while the queue is full (instead of blocking the collector
        forever on a queue nobody drains)."""
        while self._dead is None:
            try:
                self._completion_q.put(entry, timeout=0.2)
                return
            except queue.Full:
                continue
        # Dead path, reached at most once per call (the loop above
        # exits to here): formatting happens outside the retry loop.
        err = DispatcherDead(f"batch dispatcher is dead: {self._dead!r}")
        kind, payload, _token = entry
        if kind == "batch":
            for it in payload:
                it.fail(err)
        elif kind == "token":
            if isinstance(payload, _CallToken):
                payload.error = err
            payload.event.set()

    def _note_step(self, ok: bool) -> None:
        """Track consecutive device-step failures -> health state (the
        Redis active-connection health analog)."""
        cb = None
        with self._state_lock:
            if ok:
                self._consecutive_failures = 0
                if self._reported_unhealthy:
                    self._reported_unhealthy = False
                    cb = (True, "device steps succeeding again")
            else:
                self._consecutive_failures += 1
                if (
                    self.unhealthy_after > 0
                    and self._consecutive_failures >= self.unhealthy_after
                    and not self._reported_unhealthy
                ):
                    self._reported_unhealthy = True
                    cb = (
                        False,
                        f"{self._consecutive_failures} consecutive "
                        "device-step failures",
                    )
        if cb is not None and self.on_state is not None:
            try:
                self.on_state(*cb)
            except Exception:
                pass

    def _die(self, exc: BaseException) -> None:
        """A dispatcher thread crashed outside per-batch handling:
        mark dead, fail everything queued/in-flight fast, and report
        unhealthy.  New submits raise DispatcherDead immediately."""
        with self._buf_cv:
            if self._dead is None:
                self._dead = exc
            drained = self._buf
            self._buf = []
        err = DispatcherDead(f"batch dispatcher died: {exc!r}")
        err.__cause__ = exc
        leftovers = list(drained)
        while True:
            try:
                leftovers.append(self._completion_q.get_nowait())
            except queue.Empty:
                break
        for obj in leftovers:
            if isinstance(obj, WorkItem):
                obj.fail(err)
            elif isinstance(obj, (_FlushToken, _CallToken)):
                if isinstance(obj, _CallToken):
                    obj.error = err
                obj.event.set()
            elif isinstance(obj, tuple):
                kind, payload, _token = obj
                if kind == "batch":
                    for it in payload:
                        it.fail(err)
                elif kind == "token":
                    if isinstance(payload, _CallToken):
                        payload.error = err
                    payload.event.set()
        if self.on_state is not None:
            try:
                self.on_state(False, f"dispatcher thread died: {exc!r}")
            except Exception:
                pass

    def _collect_loop(self) -> None:
        try:
            while True:
                batch, tokens, stopping = self._collect()
                if batch:
                    # The LATEST batch's clock, not an all-time max: a
                    # single item with an anomalous future `now` (clock
                    # step) must not latch and mass-expire live keys on
                    # every later gc tick — a stale-low now merely gc's
                    # less until the next batch.
                    self._last_item_now = max(it.now for it in batch)
                    self._launch(batch)
                if (
                    self._last_item_now is not None
                    and time.monotonic() >= self._next_gc_monotonic
                ):
                    self._next_gc_monotonic = (
                        time.monotonic() + self.gc_interval_s
                    )
                    self.engine.gc(self._last_item_now)
                for t in tokens:
                    if isinstance(t, _CallToken):
                        # Calls (checkpoints) run HERE — the collector
                        # owns the slot table, and engine counts
                        # reflect every launch so far (donation chain),
                        # so the snapshot is consistent without waiting
                        # for completions.
                        self._run_call(t)
                    else:
                        # Flushes wait for COMPLETION of everything
                        # before them: route through the completer.
                        self._put_completion(("token", t, None))
                if stopping:
                    self._drain()
                    self._completion_q.put(("stop", None, None))
                    return
        except BaseException as e:  # noqa: BLE001 — liveness boundary
            self._die(e)

    def _complete_loop(self) -> None:
        try:
            while True:
                kind, payload, token = self._completion_q.get()
                if kind == "stop":
                    return
                if kind == "token":
                    payload.event.set()
                else:
                    lr = self.launches
                    t0 = time.monotonic_ns() if lr is not None else 0
                    self._complete_busy_since = self._stamp_now()
                    try:
                        ok = complete_items(self.engine, payload, token)
                    finally:
                        self._complete_busy_since = None
                    if lr is not None:
                        # Stamped after the CUDA event has completed
                        # and the decisions are scattered.
                        try:
                            meta = self._launch_meta.popleft()
                        except IndexError:
                            # Recorder attached between this batch's
                            # launch and its completion: no front-half
                            # measurements, still one record.
                            meta = (0, len(payload), 0, 0, 0, 0)
                        self._record_launch(
                            lr,
                            meta[0],
                            meta[1],
                            meta[2],
                            meta[3],
                            meta[4],
                            time.monotonic_ns() - t0,
                            OUTCOME_OK if ok else OUTCOME_FAULT,
                            meta[5],
                        )
                    if ok:
                        self.completed_launches += 1
                    with self._state_lock:
                        self._inflight -= 1
                    self._note_step(ok)
        except BaseException as e:  # noqa: BLE001 — liveness boundary
            self._die(e)

    def _record_launch(self, lr, *fields) -> None:
        """Stamp one launch record for this dispatcher's bank.  A
        recorder that raises loses the record, never the launch: the
        dispatcher thread must not die into the fault domain's fallback
        over an observability hook."""
        try:
            lr.record(self.launch_bank, self.launch_algo, *fields)
        except Exception:
            logger.exception("%s: launch record dropped", self._thread.name)

    def _run_call(self, t: "_CallToken") -> None:
        if t.device_call:
            self._launch_busy_since = self._stamp_now()
        try:
            t.fn()
        except BaseException as e:
            t.error = e
        finally:
            if t.device_call:
                self._launch_busy_since = None
        t.event.set()

    def _drain(self) -> None:
        """Launch everything still queued at stop time so no waiter
        hangs (items racing stop() land behind the _STOP sentinel)."""
        with self._buf_cv:
            drained = self._buf
            self._buf = []
        leftovers: List[WorkItem] = []
        for obj in drained:
            if isinstance(obj, WorkItem):
                leftovers.append(obj)
            elif isinstance(obj, _CallToken):
                if leftovers:
                    self._launch(leftovers)
                    leftovers = []
                self._run_call(obj)
            elif isinstance(obj, _FlushToken):
                if leftovers:
                    self._launch(leftovers)
                    leftovers = []
                self._put_completion(("token", obj, None))
        if leftovers:
            self._launch(leftovers)
