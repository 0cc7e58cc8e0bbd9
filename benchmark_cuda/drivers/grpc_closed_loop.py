"""Drive the program's Runner over gRPC with closed-loop clients in
processes of their own (``procs`` of ``threads`` threads, a channel a
thread; drivers/grpc_client.py), so that the server's interpreter is not
shared with its clients.

The Runner boots from the configuration's settings and rules, in this
process, on free local ports.  The shapes its traffic uses (chunks of
at most procs x threads lanes, served by value) run once before the
window through the program's own warm-up; the clients send their first
requests before it too.  Every request the clients sent is kept with its
answer and its send and reply times, and after the window the program's
counters, for the reference.

Traced (``trace_settings``), the launch recorder keeps the whole window,
which runs as an untraced one does, so its tails are the same; after it,
while the clients keep sending, the program's tracer samples every
request for ``trace_s`` seconds, and then torch.profiler captures
``capture_s`` seconds of the card, taken again (``capture_tries``) until
its kernels match the launch count.  A profiler session's start holds
the interpreter lock for about a quarter of a second, past the fault
domain's 0.25 s kernel deadline, so the traced run gives the deadline
5 s: otherwise the capture itself quarantines the bank and the mirror
answers.
"""

from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import capture  # noqa: E402
from common import device_info, limits_of, settings_env, warm_buckets  # noqa: E402
from keyspace import WINDOW_DIGITS, KeySpace  # noqa: E402

#: Every listener on a free local port.
LISTEN = {
    "HOST": "127.0.0.1", "PORT": "0", "GRPC_HOST": "127.0.0.1", "GRPC_PORT": "0",
    "DEBUG_HOST": "127.0.0.1", "DEBUG_PORT": "0",
}


def run(cell, seed, seconds, trace, device, started):
    import torch

    from ratelimit_tpu_torch.observability import TRACER
    from ratelimit_tpu_torch.runner import Runner
    from ratelimit_tpu_torch.settings import new_settings

    tr, cfg = cell.traffic, cell.config
    procs, threads = int(tr["procs"]), int(tr["threads"])
    params = dict(
        seed=seed, threads=threads, keys=cell.keys, domain=cfg["domain"],
        descriptor_key=cfg["descriptor_key"], warm_rpcs=tr["warm_rpcs"],
        draws_per_thread=tr["draws_per_thread"], deadline_s=tr["deadline_s"],
    )
    clients = [
        subprocess.Popen(
            [sys.executable, os.path.join(HERE, "grpc_client.py"), json.dumps(dict(params, proc=p))],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for p in range(procs)
    ]
    root = tempfile.mkdtemp(prefix="bench_rules_")
    runner = None
    try:
        conf = os.path.join(root, "ratelimit", "config")
        os.makedirs(conf)
        with open(os.path.join(conf, f"{cfg['domain']}.yaml"), "w") as f:
            f.write(cfg["rules_yaml"])
        env = dict(cfg["settings"], RUNTIME_ROOT=root, RUNTIME_SUBDIRECTORY="ratelimit", **LISTEN)
        if trace:
            env.update(tr["trace_settings"])
        with settings_env(env):
            runner = Runner(new_settings(), device=device)
        runner.start()
        for engine in runner.cache.engines():
            warm_buckets(engine, range(1, procs * threads + 1))
        space = KeySpace(cell.keys, cfg["domain"], cfg["descriptor_key"], seed)
        spans = []
        if trace:
            TRACER.add_exporter(lambda t: spans.append((t.start_unix, t.duration_ms))
                                if t.root_name == "grpc.should_rate_limit" else None)
        for c in clients:
            c.stdin.write(f"port {runner.grpc_server.bound_port}\n")
            c.stdin.flush()
        for c in clients:
            line = c.stdout.readline()
            if line.strip() != "ready":
                raise RuntimeError(f"a client did not start: {line!r} {c.stderr.read()[-2000:]}")
        # Set-up's objects leave the collector's scan set, as the runner
        # does with its own at start (GC_TUNING).
        gc.collect()
        gc.freeze()
        t0 = time.time() + 0.1
        m0 = time.monotonic_ns() + 100_000_000
        for c in clients:
            c.stdin.write(f"start {t0!r}\n")
            c.stdin.flush()
        time.sleep(max(0.0, t0 + seconds - time.time()))
        t1 = time.time()
        m1 = time.monotonic_ns()
        got = None
        if trace:
            TRACER.configure(sample_rate=1.0)
            time.sleep(float(tr["trace_s"]))
            TRACER.configure(sample_rate=0.0)
            t2 = time.time()
        if trace and device != "cpu":
            got = capture.take(torch, lambda: time.sleep(float(tr["capture_s"])),
                               int(tr["capture_tries"]))
            if got is None:
                raise RuntimeError(f"no whole profiler capture in {tr['capture_tries']} tries")
        for c in clients:
            c.stdin.write("stop\n")
            c.stdin.flush()
        logs = []
        for c in clients:
            out, err = c.communicate(timeout=120)
            if c.returncode != 0:
                raise RuntimeError(f"a client exited {c.returncode}: {err[-2000:]}")
            logs.append(json.loads(out.strip().splitlines()[-1]))
        rpcs = {k: np.concatenate([np.asarray(g[k]) for g in logs]) for k in logs[0]}
        runner.cache.flush()
        peak = device_info(torch, device)
        fd = getattr(runner.cache, "fault_domain", None)
        summary = fd.summary() if fd is not None else {"fallback_decisions": 0, "faults": {}}
        records = runner.launches.snapshot() if runner.launches is not None else None
        state = read_state(runner.cache.engines()[0], space)
    finally:
        if runner is not None:
            runner.stop()
            if trace:
                TRACER.clear_exporters()
        for c in clients:
            if c.poll() is None:
                c.kill()
                c.wait()
        for dirpath, dirnames, filenames in os.walk(root, topdown=False):
            for f in filenames:
                os.unlink(os.path.join(dirpath, f))
            os.rmdir(dirpath)

    in_window = (rpcs["t_send"] >= t0) & (rpcs["t_send"] < t1)
    ok = rpcs["err"] == 0
    fallback = int(summary["fallback_decisions"])
    if fallback or any(summary["faults"].values()):
        print(f"fault domain: {fallback} fallback answers, faults {summary['faults']}",
              file=sys.stderr)
    out = dict(
        setup_s=t0 - started,
        window_s=t1 - t0,
        decisions=int(np.count_nonzero(ok & (rpcs["t_recv"] <= t1) & (rpcs["t_send"] >= t0))),
        rpc_latency_us=rpcs["lat_us"][in_window].tolist(),
        attempted=int(np.count_nonzero(in_window)),
        failed=int(np.count_nonzero(in_window & ~ok)) + fallback,
        device=peak,
    )
    if trace:
        out["handler_us"] = [d * 1e3 for s, d in spans if t1 <= s < t2]
        if records is not None:
            out["launch_records"] = records[(records["ts_ns"] >= m0) & (records["ts_ns"] < m1)]
        if got is not None:
            got["busy_s"] = capture.busy_s(got["activities"])
            out["device"] = dict(peak, busy_s=got["busy_s"], window_s=got["window_s"])
            out["breakdown"] = capture.breakdown(got["activities"])
        out["capture"] = got
    out["observed"] = dict(
        algorithm=cfg["algorithm"], unit=int(cfg["limits"]["divider_s"]),
        limits=limits_of(cell, space), rpcs=rpcs, state=state,
    )
    return out


def read_state(engine, space):
    """The program's fixed-window counters after the window: int64[n, 3]
    of (address id, window, count) for every key it holds."""
    stems = {stem: i for i, stem in enumerate(space.stems)}
    counts = engine.export_counts()
    ent = engine.slot_table.export_entries()
    raw = ent.key_blob.tobytes()
    rows, off = [], 0
    for n, slot in zip(ent.key_lens.tolist(), ent.slots.tolist()):
        key = raw[off:off + n]
        off += n
        window = key[-WINDOW_DIGITS:]
        if window.isdigit():
            rows.append((stems.get(key[:-WINDOW_DIGITS], -1), int(window), int(counts[slot])))
        else:  # a key no request of the traffic makes
            rows.append((-1, -1, int(counts[slot])))
    return np.array(rows, dtype=np.int64).reshape(-1, 3)
