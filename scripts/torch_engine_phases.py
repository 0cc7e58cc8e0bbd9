"""The engine's phase records on the card, through the benchmark's own
driver: what each host phase of a chunk costs, what the card's idle time
is spent on, and what the records cost.  Card only:

    python3 scripts/torch_engine_phases.py [--seed N] [--seconds 10]
        [--pairs 6] [--window-s 5] [--alternate-blocks 6] [--out PATH]

It makes one traced run of the benchmark's ``fw_engine_4096`` cell
(``harness.run_cell``, as ``benchmark_cuda/run.py --trace 1`` does).
Before the driver's profiler capture, and through the driver's own loop
(its ``capture_chunks`` chunks a call, with the restamping, table sweeps
and sampling of every other chunk), it attaches a launch recorder to the
driver's engine and:

1. runs --pairs alternating pairs of --window-s windows, attached against
   detached (decisions a second of each);
2. runs --alternate-blocks calls with the recorder attached to every
   other chunk, and reads the host clock around ``submit_packed`` and
   ``step_complete`` as the driver does: the records' cost a chunk, both
   sides on the same host;
3. takes a torch.profiler capture of one call with the recorder attached
   (retaken until it holds one kernel a chunk), and reads from it the
   median of each phase, the spans against the host clock around the two
   calls, the CUDA events' device time against the profiler's kernel
   time, whether each kernel lies inside its chunk's enqueue-to-wait
   interval on the shared clock (observability/phases.py), and the idle
   gaps named by the host phase that covers them.

Every chunk stays in the driver's record, so the run's judge checks the
attached chunks with the rest.  Prints one JSON line (the card's name
and power limit, the run's result line and the readings) and, with
--out, writes it there too.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "benchmark_cuda"), ROOT]

CELL = "fw_engine_4096"
KERNEL = "unique_step_rows_kernel"


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()


class HostTimers:
    """The host clock around the engine's two calls, as the driver reads
    it, each chunk's (submit_ns, complete_ns, attached) in ``rows``; with
    ``alternate``, the recorder is attached to every other submission."""

    def __init__(self, engine, recorder):
        self.engine, self.recorder = engine, recorder
        self.rows, self.alternate, self.sent = [], False, 0
        submit, complete = engine.submit_packed, engine.step_complete
        pending = collections.deque()
        clock = time.perf_counter_ns

        def submit_packed(now, blob, meta):
            if self.alternate:
                engine.attach_launch_recorder(recorder if self.sent % 2 == 0 else None)
            self.sent += 1
            t0 = clock()
            token = submit(now, blob, meta)
            pending.append(clock() - t0)
            return token

        def step_complete(token):
            t0 = clock()
            out = complete(token)
            self.rows.append((pending.popleft(), clock() - t0, token[5] is not None))
            return out

        engine.submit_packed, engine.step_complete = submit_packed, step_complete

    def undo(self) -> None:
        del self.engine.submit_packed, self.engine.step_complete
        self.engine.attach_launch_recorder(None)


def window_pairs(engine, recorder, work, chunks: int, lanes: int, pairs: int, window_s: float):
    """Alternating attached and detached windows of whole driver calls:
    decisions a second of each, and the attached side's cost."""
    out = []
    for k in range(pairs):
        rates = {}
        for attached in ((False, True) if k % 2 == 0 else (True, False)):
            engine.attach_launch_recorder(recorder if attached else None)
            calls, t0 = 0, time.perf_counter()
            while calls == 0 or time.perf_counter() - t0 < window_s:
                work()
                calls += 1
            rates["attached" if attached else "detached"] = calls * chunks * lanes / (
                time.perf_counter() - t0)
        out.append(rates)
    engine.attach_launch_recorder(None)
    cost = [1.0 - p["attached"] / p["detached"] for p in out]
    return {"pairs": out, "cost_per_pair": cost, "cost_median": statistics.median(cost)}


def alternating_cost(timers: HostTimers, work, blocks: int) -> dict:
    """The records' cost a chunk, chunks attached and detached in turn:
    medians (us) of each side's two calls and the excess over the chunk
    period."""
    timers.rows.clear()
    timers.alternate, timers.sent = True, 0
    t0 = time.perf_counter_ns()
    for _ in range(blocks):
        work()
    period = (time.perf_counter_ns() - t0) / max(len(timers.rows), 1)
    timers.alternate = False
    timers.engine.attach_launch_recorder(None)
    rows = np.asarray(timers.rows, dtype=np.int64)
    out = {}
    for attached, key in ((1, "attached"), (0, "detached")):
        side = rows[rows[:, 2] == attached]
        out[key] = {"submit_us": med_us(side[:, 0]), "complete_us": med_us(side[:, 1]),
                    "chunks": len(side)}
    excess = sum(out["attached"][k] - out["detached"][k] for k in ("submit_us", "complete_us"))
    out.update(excess_us=excess, period_us=period / 1e3, excess_share=excess * 1e3 / period)
    return out


def phase_capture(torch, timers: HostTimers, work, chunks: int, tries: int):
    """A profiler capture of one driver call with the recorder attached,
    retaken until it holds one kernel and one record a chunk: device
    activities as (name, start_ns, dur_ns) on the trace's clock, the
    records, the host timers, the host window, the clock offsets before
    and after, and the tries; None where no capture was whole."""
    from torch.profiler import ProfilerActivity, profile

    from ratelimit_tpu_torch.observability.phases import clock_offset

    cuda = torch.autograd.DeviceType.CUDA
    engine, recorder = timers.engine, timers.recorder
    for attempt in range(1, tries + 1):
        engine.attach_launch_recorder(recorder)
        since = recorder.phases_stamped()
        timers.rows.clear()
        before = clock_offset()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic_ns()
            work()
            torch.cuda.synchronize()
            t1 = time.monotonic_ns()
        after = clock_offset()
        engine.attach_launch_recorder(None)
        acts = sorted(
            ((e.name(), int(e.start_ns()), int(e.duration_ns()))
             for e in prof.profiler.kineto_results.events() if e.device_type() == cuda),
            key=lambda a: a[1],
        )
        kernels = [a for a in acts if KERNEL in a[0]]
        records = recorder.snapshot_phases(since)
        if len(kernels) == chunks == len(records):
            return dict(acts=acts, kernels=kernels, records=records, timers=list(timers.rows),
                        window_ns=t1 - t0, before=before, after=after, tries=attempt)
    return None


def med_us(xs) -> float:
    return float(np.median(np.asarray(xs, dtype=np.float64))) / 1e3


def analyse(got: dict) -> dict:
    from ratelimit_tpu_torch.observability import phases as P

    rec = got["records"]
    offset = (got["before"][0] + got["after"][0]) // 2
    out = {name: med_us(rec[key]) for name, key in (
        ("assign_dedup_us.engine", "assign_ns"), ("stage_us.engine", "stage_ns"),
        ("enqueue_us.engine", "enqueue_ns"), ("wait_us.engine", "wait_ns"),
        ("decide_us.engine", "decide_ns"), ("device_us.engine", "device_ns"),
        ("submit_us.span", "submit_ns"), ("complete_us.span", "complete_ns"))}
    timers = np.asarray(got["timers"], dtype=np.int64)
    out["submit_us.timer"] = med_us(timers[:, 0])
    out["complete_us.timer"] = med_us(timers[:, 1])
    out["submit_span_over_timer"] = out["submit_us.span"] / out["submit_us.timer"]
    out["complete_span_over_timer"] = out["complete_us.span"] / out["complete_us.timer"]
    out["kernel_us.profiler"] = med_us([k[2] for k in got["kernels"]])
    out["device_minus_profiler_us"] = out["device_us.engine"] - out["kernel_us.profiler"]
    # Kernels against their chunks' enqueue-to-wait interval, on the
    # trace's clock.
    inside, worst = 0, 0
    for r, (_name, start, _dur) in zip(rec, got["kernels"]):
        lo = int(r["submit_t0_ns"]) + int(r["assign_ns"]) + int(r["stage_ns"]) + offset
        hi = int(r["complete_t0_ns"]) + int(r["wait_ns"]) + offset
        if lo <= start <= hi:
            inside += 1
        else:
            worst = max(worst, lo - start if start < lo else start - hi)
    out["kernels_inside_share"] = inside / len(rec)
    out["worst_outside_us"] = worst / 1e3
    out["clock_offset_ns"] = [got["before"][0], got["after"][0]]
    out["clock_skew_ns"] = [got["before"][1], got["after"][1]]
    intervals = P.phase_intervals(rec, offset)
    gaps = P.idle_gaps([(a[1], a[2]) for a in got["acts"]])
    idle = sum(g[1] - g[0] for g in gaps) / 1e9
    out["idle_share_by_phase"] = {k: v / idle for k, v in sorted(
        P.idle_by_phase(gaps, intervals).items())}
    out["idle_gaps"] = P.name_gaps(gaps, intervals)
    busy = sum(a[2] for a in got["acts"]) / 1e9
    out["device_idle_pct"] = 100.0 * (1.0 - busy / (got["window_ns"] / 1e9))
    out["chunks"] = len(rec)
    out["tries"] = got["tries"]
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=2**33 + 26)
    ap.add_argument("--seconds", type=float, default=10.0,
                    help="the driver's timed window before the recorded runs")
    ap.add_argument("--pairs", type=int, default=6)
    ap.add_argument("--window-s", type=float, default=5.0)
    ap.add_argument("--alternate-blocks", type=int, default=6,
                    help="driver calls with the recorder on every other chunk")
    ap.add_argument("--out", default=None, help="also write the JSON line to this file")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    import capture as bench_capture
    import harness

    from ratelimit_tpu_torch.observability.launches import LaunchRecorder

    cell = harness.Cell(CELL)
    chunks, lanes = int(cell.traffic["capture_chunks"]), int(cell.traffic["lanes"])
    driver = harness.part("drivers", cell.traffic["driver"])
    made, result = [], {"card": smi(), "seed": args.seed}
    build, take = driver.build_engine, bench_capture.take

    def build_engine(cell_, device):
        made.append(build(cell_, device))
        return made[-1]

    def take_after_phases(torch_, work, tries):
        # `work` drives `chunks` chunks through the driver's loop; the
        # driver's own capture follows, so its readings stay its own.
        recorder = LaunchRecorder(4096)
        timers = HostTimers(made[-1], recorder)
        try:
            result["window_pairs"] = window_pairs(made[-1], recorder, work, chunks, lanes,
                                                  args.pairs, args.window_s)
            result["alternating"] = alternating_cost(timers, work, args.alternate_blocks)
            got = phase_capture(torch_, timers, work, chunks, tries)
            result["phase_capture"] = analyse(got) if got is not None else None
        finally:
            timers.undo()
        return take(torch_, work, tries)

    driver.build_engine, bench_capture.take = build_engine, take_after_phases
    try:
        line = harness.run_cell(CELL, args.seed, args.seconds, True)
    finally:
        driver.build_engine, bench_capture.take = build, take
    result["line"] = {k: line[k] for k in ("correct", "metrics", "breakdown", "checks")
                      if k in line}
    text = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text, flush=True)
    return 0 if line["correct"] and result.get("phase_capture") else 1


if __name__ == "__main__":
    sys.exit(main())
