"""Drive the program's counter engine as its dispatcher does: one
``CounterEngine.submit_packed`` a chunk of ``lanes`` descriptors (keys as
a length-prefixed blob, per-lane scalars as ``LANE_DTYPE`` records), then
its ``step_complete``, with ``depth`` chunks in flight.

The engine is the one the program's runner builds for the configuration
(``_make_engine`` for the fixed-window bank, ``make_algorithm_banks`` for
an algorithm bank).  The traffic is ``pool_chunks`` chunks of zipfian
addresses drawn from the seed at set-up, sent in turn: more chunks than
a window of one second takes, so each window's addresses are as diverse
as fresh draws.  A fixed-window chunk's keys carry the window of the
clock it is sent at, stamped into the chunk's one blob (only the digits
that changed) when it is sent in a new window.  The engine's
``now`` is the real clock's unix second, and the slot table is swept of
expired keys every GC_INTERVAL_S, as the dispatcher's collector does.

Every answer and the final state of a sample of keys drawn from the seed
(``sample_share`` of the addresses, the ``sample_hottest`` most frequent
and the deny-listed one) are kept for the reference.  Traced, a further
``capture_chunks`` chunks run after the window under torch.profiler.
"""

from __future__ import annotations

import collections
import gc
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import capture  # noqa: E402
import harness  # noqa: E402
import roofline  # noqa: E402
from common import device_info, limits_of, program_settings  # noqa: E402
from common import warm_buckets  # noqa: E402
from keyspace import WINDOW_DIGITS, KeySpace, stamp_window  # noqa: E402

#: Seconds between the slot table's sweeps of expired keys, as the
#: program's dispatcher runs them (BatchDispatcher.gc_interval_s).
GC_INTERVAL_S = 5.0

def build_engine(cell, device):
    """The engine the program's runner builds for this configuration."""
    from ratelimit_tpu_torch import runner as program

    s = program_settings(cell)
    algo = cell.config["algorithm"]
    if algo == "fixed_window":
        return program._make_engine(s, device, None, s.tpu_num_slots)
    return program.make_algorithm_banks(s, device)[algo]


def run(cell, seed, seconds, trace, device, started):
    import torch

    from ratelimit_tpu_torch.backends.dispatcher import LANE_DTYPE
    from ratelimit_tpu_torch.models.registry import get_algorithm

    tr, cfg = cell.traffic, cell.config
    algo = cfg["algorithm"]
    fixed = algo == "fixed_window"
    unit = int(cfg["limits"]["divider_s"])
    lease = unit if fixed else 2 * unit  # expiry past the window's start
    lanes, n_pool, depth = int(tr["lanes"]), int(tr["pool_chunks"]), int(tr["depth"])

    engine = build_engine(cell, device)
    space = KeySpace(cell.keys, cfg["domain"], cfg["descriptor_key"], seed)
    limits = limits_of(cell, space)
    rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 1])
    pool = space.draw(rng, n_pool * lanes).astype(np.int32).reshape(n_pool, lanes)
    srng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 2])
    sampled = srng.random(space.ids) < float(tr["sample_share"])
    sampled[space.hottest(int(tr["sample_hottest"]))] = True
    sampled[space.count:] = True  # the deny-listed address
    sample_idx = [np.flatnonzero(sampled[ids]) for ids in pool]
    distinct = [len(np.unique(ids)) for ids in pool]

    packs = [space.pack(ids, WINDOW_DIGITS if fixed else 0) for ids in pool]
    metas = []
    for ids, (_blob, lens, _at) in zip(pool, packs):
        meta = np.zeros(lanes, dtype=LANE_DTYPE)
        meta["hits"] = 1
        meta["limits"] = limits[ids]
        meta["len"] = lens
        if not fixed:
            meta["divider"] = unit
            meta["algo"] = get_algorithm(algo).algo_id
        metas.append(meta)
    warm_buckets(engine, distinct)
    stamped = [None] * n_pool  # the window chunk c's keys and expiry carry

    chunks_now, chunks_pool, codes, remaining = [], [], [], []
    submit_us, complete_us, chunk_us = [], [], []
    inflight = collections.deque()
    state = {"i": 0, "decided": 0, "gc_at": time.monotonic() + GC_INTERVAL_S}

    def submit():
        now = int(time.time())
        window = now - now % unit
        if time.monotonic() >= state["gc_at"]:
            state["gc_at"] = time.monotonic() + GC_INTERVAL_S
            engine.gc(now)
        c = state["i"] % n_pool
        state["i"] += 1
        if stamped[c] != window:
            blob, _lens, at = packs[c]
            if fixed:
                stamp_window(blob, at, window, stamped[c])
            metas[c]["expiry"] = window + lease
            stamped[c] = window
        t0 = time.perf_counter()
        token = engine.submit_packed(now, packs[c][0], metas[c])
        t1 = time.perf_counter()
        inflight.append((token, c, now, t0))
        submit_us.append((t1 - t0) * 1e6)

    def complete():
        token, c, now, t0 = inflight.popleft()
        t1 = time.perf_counter()
        d = engine.step_complete(token)
        t2 = time.perf_counter()
        complete_us.append((t2 - t1) * 1e6)
        chunk_us.append((t2 - t0) * 1e6)
        idx = sample_idx[c]
        codes.append(d.codes[idx])
        remaining.append(d.limit_remaining[idx])
        chunks_now.append(now)
        chunks_pool.append(c)
        state["decided"] += len(d.codes)

    def drive(until=None, count=None):
        sent = 0
        while (until is None or time.time() < until) and (count is None or sent < count):
            submit()
            sent += 1
            if len(inflight) >= depth:
                complete()
        while inflight:
            complete()

    # Set-up's objects leave the collector's scan set, as the program's
    # runner does with GC_TUNING (its default).
    gc.collect()
    gc.freeze()
    t_start = time.time()
    setup_s = t_start - started
    drive(until=t_start + seconds)
    window_s = time.time() - t_start
    decided, timed = state["decided"], len(chunk_us)
    attempted = timed * lanes
    peak = device_info(torch, device)

    run_out = dict(
        setup_s=setup_s, window_s=window_s, decisions=decided, chunk_latency_us=chunk_us[:timed],
        submit_us=submit_us[:timed], complete_us=complete_us[:timed],
        attempted=attempted, failed=0, device=peak,
    )
    if trace:
        got = None
        if device != "cpu":
            n = int(tr["capture_chunks"])
            marks = []

            def work():
                # Every try's chunks are decided and stay in the record.
                marks.append(len(chunks_pool))
                drive(count=n)

            got = capture.take(torch, work, int(tr["capture_tries"]))
            if got is not None and len(got["kernels"]) == n:
                ran = chunks_pool[marks[-1]:]
                per_key = harness.part("reference", algo).BYTES_PER_KEY
                got["least_s"] = sum(roofline.least_seconds(per_key, distinct[c]) for c in ran)
                got["kernel_s"] = sum(k[2] for k in got["kernels"]) / 1e6
                got["busy_s"] = capture.busy_s(got["activities"])
                run_out["device"] = dict(peak, busy_s=got["busy_s"], window_s=got["window_s"])
                run_out["breakdown"] = capture.breakdown(got["activities"])
            else:
                raise RuntimeError(f"no whole profiler capture of {n} chunks in "
                                   f"{tr['capture_tries']} tries")
        run_out["capture"] = got

    run_out["observed"] = dict(
        algorithm=algo, unit=unit, lease=lease, pool=pool, sample_idx=sample_idx,
        limits=limits, sampled=sampled, now=np.array(chunks_now, dtype=np.int64),
        chunk_pool=np.array(chunks_pool, dtype=np.int64),
        codes=np.concatenate(codes) if codes else np.zeros(0, np.int32),
        remaining=np.concatenate(remaining) if remaining else np.zeros(0, np.int64),
        state=read_state(engine, space, sampled, fixed),
    )
    return run_out


def read_state(engine, space, sampled, fixed: bool):
    """The program's state of the sampled addresses after the window:
    fixed window, int64[n, 3] of (address id, window, count); GCRA,
    int64[n, 3] of (address id, TAT seconds, TAT fraction)."""
    stems = {space.stems[i]: i for i in np.flatnonzero(sampled).tolist()}
    rows = []
    if fixed:
        counts = engine.export_counts()
        ent = engine.slot_table.export_entries()
        raw = ent.key_blob.tobytes()
        off = 0
        for n, slot in zip(ent.key_lens.tolist(), ent.slots.tolist()):
            key = raw[off:off + n]
            off += n
            i = stems.get(key[:-WINDOW_DIGITS])
            if i is not None:
                rows.append((i, int(key[-WINDOW_DIGITS:]), int(counts[slot])))
    else:
        st = engine.export_state()
        sec, frac = st["tat_sec"], st["tat_frac"]
        for key, slot, _expiry in engine.slot_table.entries():
            i = stems.get(key.encode("utf-8"))
            if i is not None:
                rows.append((i, int(sec[slot]), int(frac[slot])))
    return np.array(rows, dtype=np.int64).reshape(-1, 3)
