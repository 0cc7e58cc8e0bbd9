"""Drive the program's counter engine over a per-day table restored at
mid-day, as a messaging deployment's dispatcher does after a restart.

The deployment (``configs/messaging_day_fw.json``) limits messages per
recipient and per UTC day: a marketing message sends the nested
descriptor (``message_type: marketing``, ``to_number``, 5 a day) and
``to_number`` (100 a day), in that order, each a lane of its own; any
other message sends ``to_number`` alone.  Key id ``r`` is recipient r's
``to_number`` key and id ``count + r`` its marketing key, each with its
own limit.

Set-up:

- the morning, the day's first ``morning.messages`` messages, is drawn
  from the configuration's own ``morning.day_seed`` (it is part of the
  deployment, not of ``--seed``): counts a recipient under the zipfian
  law by a multinomial draw, the marketing share of them by a binomial
  one.  The program's ``checkpoint.write_snapshot`` writes it once per
  checkout under ``.bench_cache/`` (with the morning's counts a key id
  beside it for the reference), and later runs reuse both, as the nvcc
  build is reused;
- the engine the program's runner builds for the configuration restores
  it through ``checkpoint.restore_engine``, its age guard reading the
  cell's clock;
- ``pool_chunks`` chunks of messages drawn from ``--seed``, each at most
  ``lanes`` descriptors (a marketing message's two lanes in one chunk),
  and the engine's warm-up of the buckets they pad to.

The window sends the pool in turn through ``submit_packed`` +
``step_complete``, ``depth`` chunks in flight, and sweeps the slot table
every GC_INTERVAL_S as the dispatcher does (nothing expires before
midnight).  The clock is 12:00:00 UTC of ``morning.day_start``'s day
plus the seconds since the run began, so no run straddles midnight and
every run is at the same point of its day.

Every answer to a lane of a sampled key id (``sample_share`` of the ids,
both keys of the ``sample_hottest`` most frequent recipients) and those
ids' state after the window are kept for the reference, which starts
from the morning's counts.  Traced, a further ``capture_chunks`` chunks
run under torch.profiler.
"""

from __future__ import annotations

import collections
import gc
import hashlib
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import capture  # noqa: E402
import harness  # noqa: E402
from common import device_info, program_settings, warm_buckets  # noqa: E402

#: Seconds between the slot table's sweeps, as the program's dispatcher
#: runs them (BatchDispatcher.gc_interval_s).
GC_INTERVAL_S = 5.0
#: Unix seconds of a window start print as 10 digits.
WINDOW_DIGITS = 10
#: Digits of a recipient's number past its "+1".
NUMBER_DIGITS = 10
#: The bank's role in the runner's topology (one lane).
ROLE = "lane0of1"
#: Bumped whenever the cached morning's layout changes.
MORNING_FORMAT = 1


class Deployment:
    """The configuration's recipients, their keys and the zipfian law."""

    def __init__(self, cfg: dict, keys: dict):
        self.count = int(keys["count"])
        self.theta = float(keys["zipf"])
        self.number_base = int(keys["number_base"])
        self.marketing_share = float(cfg["messages"]["marketing_share"])
        self.unit = int(cfg["limits"]["divider_s"])
        self.day = int(cfg["morning"]["day_start"])
        self.noon = self.day + self.unit // 2
        self.expiry = self.day + self.unit
        self.limits = (int(cfg["limits"]["to_number"]), int(cfg["limits"]["marketing_to_number"]))
        weights = np.arange(1, self.count + 1, dtype=np.float64) ** -self.theta
        self.p = weights / weights.sum()
        self.cdf = np.cumsum(self.p)
        self.cdf /= self.cdf[-1]
        rng = np.random.default_rng([int(cfg["morning"]["day_seed"]), 0x726B])
        #: rank (0 = hottest) -> recipient
        self.rank_to_id = rng.permutation(self.count).astype(np.int64)
        domain = cfg["domain"]
        window = str(self.day).encode("ascii")
        if len(window) != WINDOW_DIGITS:
            raise ValueError(f"day start {self.day} is not {WINDOW_DIGITS} digits")
        # The service's keys (limiter/cache_key.py): <domain>_<k>_<v>_..._<window>.
        self.templates = [
            f"{domain}_{prefix}to_number_+1{'0' * NUMBER_DIGITS}_".encode("ascii") + window
            for prefix in ("", "message_type_marketing_")
        ]
        self.width = max(len(t) for t in self.templates)

    @property
    def ids(self) -> int:
        """Key ids: each recipient's to_number key, then its marketing key."""
        return 2 * self.count

    def limit_of_ids(self) -> np.ndarray:
        out = np.full(self.ids, self.limits[0], dtype=np.int64)
        out[self.count:] = self.limits[1]
        return out

    def draw(self, rng: np.random.Generator, n: int) -> np.ndarray:
        """`n` recipients under the zipfian law."""
        ranks = np.searchsorted(self.cdf, rng.random(n), side="left")
        return self.rank_to_id[np.minimum(ranks, self.count - 1)]

    def hottest(self, k: int) -> np.ndarray:
        return self.rank_to_id[:k].copy()

    def key_rows(self, ids: np.ndarray):
        """(rows uint8[n, width], lengths int64[n]): the key of each id,
        padded to the longest template."""
        ids = np.asarray(ids, dtype=np.int64)
        marketing = ids >= self.count
        recipients = ids - self.count * marketing
        rows = np.zeros((len(ids), self.width), dtype=np.uint8)
        lens = np.empty(len(ids), dtype=np.int64)
        for kind, template in enumerate(self.templates):
            sel = marketing == bool(kind)
            rows[sel, :len(template)] = np.frombuffer(template, dtype=np.uint8)
            lens[sel] = len(template)
            at = len(template) - WINDOW_DIGITS - 1 - NUMBER_DIGITS
            numbers = self.number_base + recipients[sel]
            for d in range(NUMBER_DIGITS):
                rows[sel, at + d] = 48 + (numbers // 10 ** (NUMBER_DIGITS - 1 - d)) % 10
        return rows, lens

    def pack(self, ids: np.ndarray):
        """The key blob of `ids` in order and each key's length."""
        rows, lens = self.key_rows(ids)
        return rows[np.arange(self.width)[None, :] < lens[:, None]], lens

    def parse(self, blob: np.ndarray, lens: np.ndarray) -> np.ndarray:
        """Key id of each key of a blob, -1 for a key of no template (of
        another window, say)."""
        lens = np.asarray(lens, dtype=np.int64)
        starts = np.cumsum(lens) - lens
        out = np.full(len(lens), -1, dtype=np.int64)
        for kind, template in enumerate(self.templates):
            sel = np.flatnonzero(lens == len(template))
            at = len(template) - WINDOW_DIGITS - 1 - NUMBER_DIGITS
            for part in np.array_split(sel, max(1, len(sel) // (1 << 18))):
                got = blob[starts[part, None] + np.arange(len(template))[None, :]]
                want = np.frombuffer(template, dtype=np.uint8)
                digits = got[:, at:at + NUMBER_DIGITS].astype(np.int64) - 48
                same = (np.delete(got, np.s_[at:at + NUMBER_DIGITS], axis=1)
                        == np.delete(want, np.s_[at:at + NUMBER_DIGITS])).all(axis=1)
                same &= ((digits >= 0) & (digits <= 9)).all(axis=1)
                r = digits @ (10 ** np.arange(NUMBER_DIGITS - 1, -1, -1, dtype=np.int64))
                r -= self.number_base
                same &= (r >= 0) & (r < self.count)
                out[part[same]] = r[same] + kind * self.count
        return out


def morning_counts(dep: Deployment, cfg: dict) -> np.ndarray:
    """uint32 count of every key id at mid-day, from the day's seed."""
    rng = np.random.default_rng([int(cfg["morning"]["day_seed"]), 0x6D6F726E])
    by_rank = rng.multinomial(int(cfg["morning"]["messages"]), dep.p)
    to_number = np.zeros(dep.count, dtype=np.int64)
    to_number[dep.rank_to_id] = by_rank
    marketing = rng.binomial(to_number, dep.marketing_share)
    return np.concatenate([to_number, marketing]).astype(np.uint32)


def morning_files(cell, dep: Deployment, num_slots: int):
    """(snapshot path, morning counts a key id): drawn and written once
    per checkout, read back afterwards."""
    cfg = cell.config
    spec = json.dumps(dict(format=MORNING_FORMAT, keys=cell.keys, morning=cfg["morning"],
                           messages=cfg["messages"], limits=cfg["limits"], domain=cfg["domain"],
                           num_slots=num_slots), sort_keys=True)
    folder = os.path.join(harness.ROOT, ".bench_cache", "morning",
                          hashlib.sha256(spec.encode()).hexdigest()[:16])
    snap, base_path = os.path.join(folder, "bank0.npz"), os.path.join(folder, "counts.npy")
    if os.path.exists(snap) and os.path.exists(base_path):
        return snap, np.load(base_path)
    from ratelimit_tpu_torch.backends import checkpoint
    from ratelimit_tpu_torch.backends.slot_table import EntryArrays

    os.makedirs(folder, exist_ok=True)
    base = morning_counts(dep, cfg)
    live = np.flatnonzero(base)
    if len(live) > num_slots:
        raise ValueError(f"{len(live)} live keys past {num_slots} slots")
    rng = np.random.default_rng([int(cfg["morning"]["day_seed"]), 0x736C6F74])
    slots = rng.permutation(len(live)).astype(np.int64)  # first-sight order
    device = np.zeros(num_slots, dtype=np.uint32)
    device[slots] = base[live]
    # The keys of one kind share a length, so a kind's blob is its rows.
    blobs, lens = [], []
    for part in np.array_split(live, max(1, len(live) // (1 << 20))):
        b, n = dep.pack(part)
        blobs.append(b)
        lens.append(n)
    entries = EntryArrays(np.concatenate(blobs), np.concatenate(lens), slots,
                          np.full(len(live), dep.expiry, dtype=np.int64))
    tmp = f"{base_path}.tmp.{os.getpid()}.npy"
    np.save(tmp, base)
    os.replace(tmp, base_path)
    checkpoint.write_snapshot(snap, num_slots, {"counts": device}, entries, ROLE, "fixed_window")
    return snap, base


def chunk_pool(dep: Deployment, rng, lanes: int, n_pool: int):
    """`n_pool` chunks of key ids, whole messages each, at most `lanes`."""
    need = n_pool * lanes
    ids = np.zeros(0, dtype=np.int64)
    ends = np.zeros(0, dtype=np.int64)  # lane offset past each message
    while len(ends) == 0 or ends[-1] < need:
        m = int(need / (1 + dep.marketing_share)) + 1024
        recipients = dep.draw(rng, m)
        marketing = rng.random(m) < dep.marketing_share
        # A marketing message's lanes: the nested key first.
        per = np.stack([np.where(marketing, recipients + dep.count, -1), recipients], axis=1)
        ids = np.concatenate([ids, per[per >= 0]])
        ends = np.cumsum(1 + marketing) if len(ends) == 0 else np.concatenate(
            [ends, ends[-1] + np.cumsum(1 + marketing)])
    pool, start = [], 0
    for _ in range(n_pool):
        stop = ends[np.searchsorted(ends, start + lanes, side="right") - 1]
        pool.append(ids[start:stop])
        start = stop
    return pool


def build_engine(cell, device):
    """The engine the program's runner builds for this configuration."""
    from ratelimit_tpu_torch import runner as program

    s = program_settings(cell)
    return program._make_engine(s, device, None, s.tpu_num_slots)


def table_counters(engine):
    """(probe cells, lookups) of the engine's slot table gauges, or None
    where the program keeps none."""
    probes, lookups = getattr(engine, "stat_probes", None), getattr(engine, "stat_lookups", None)
    return None if probes is None or lookups is None else (int(probes), int(lookups))


def run(cell, seed, seconds, trace, device, started):
    import torch

    from ratelimit_tpu_torch.backends import checkpoint
    from ratelimit_tpu_torch.backends.dispatcher import LANE_DTYPE

    t_clock = time.monotonic()
    tr, cfg = cell.traffic, cell.config
    lanes, n_pool, depth = int(tr["lanes"]), int(tr["pool_chunks"]), int(tr["depth"])
    dep = Deployment(cfg, cell.keys)

    def clock() -> int:
        return dep.noon + int(time.monotonic() - t_clock)

    engine = build_engine(cell, device)
    snap, base = morning_files(cell, dep, engine.model.num_slots)
    if not checkpoint.restore_engine(engine, snap, ROLE, wall_now=clock):
        raise RuntimeError(f"the program refused the morning's snapshot {snap}")

    rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 1])
    pool = chunk_pool(dep, rng, lanes, n_pool)
    srng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 2])
    sampled = srng.random(dep.ids) < float(tr["sample_share"])
    hot = dep.hottest(int(tr["sample_hottest"]))
    sampled[hot] = sampled[hot + dep.count] = True
    sample_idx = [np.flatnonzero(sampled[ids]) for ids in pool]
    limits = dep.limit_of_ids()
    packs, metas, distinct = [], [], []
    for ids in pool:
        blob, lens = dep.pack(ids)
        meta = np.zeros(len(ids), dtype=LANE_DTYPE)
        meta["hits"] = 1
        meta["limits"] = limits[ids]
        meta["len"] = lens
        meta["expiry"] = dep.expiry
        packs.append(blob)
        metas.append(meta)
        distinct.append(len(np.unique(ids)))
    warm_buckets(engine, distinct)

    chunks_now, chunks_pool, codes, remaining = [], [], [], []
    submit_us, complete_us, chunk_us = [], [], []
    inflight = collections.deque()
    state = {"i": 0, "decided": 0, "gc_at": time.monotonic() + GC_INTERVAL_S}

    def submit():
        now = clock()
        if time.monotonic() >= state["gc_at"]:
            state["gc_at"] = time.monotonic() + GC_INTERVAL_S
            engine.gc(now)
        c = state["i"] % n_pool
        state["i"] += 1
        t0 = time.perf_counter()
        token = engine.submit_packed(now, packs[c], metas[c])
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

    gc.collect()
    gc.freeze()
    counters_before = table_counters(engine)
    t_start = time.time()
    setup_s = t_start - started
    drive(until=t_start + seconds)
    window_s = time.time() - t_start
    counters_after = table_counters(engine)
    decided = state["decided"]
    attempted = sum(len(pool[c]) for c in chunks_pool)
    peak = device_info(torch, device)

    run_out = dict(
        setup_s=setup_s, window_s=window_s, decisions=decided, chunk_latency_us=chunk_us[:],
        submit_us=submit_us[:], complete_us=complete_us[:], attempted=attempted, failed=0,
        device=peak,
        restore_ns=getattr(engine, "stat_restore_ns", None),
        index_bytes=getattr(engine, "stat_index_bytes", None),
        probes=None if counters_before is None else (
            counters_after[0] - counters_before[0], counters_after[1] - counters_before[1]),
    )
    if trace:
        got = None
        if device != "cpu":
            n = int(tr["capture_chunks"])
            got = capture.take(torch, lambda: drive(count=n), int(tr["capture_tries"]))
            if got is None or len(got["kernels"]) != n:
                raise RuntimeError(f"no whole profiler capture of {n} chunks in "
                                   f"{tr['capture_tries']} tries")
            got["busy_s"] = capture.busy_s(got["activities"])
            run_out["device"] = dict(peak, busy_s=got["busy_s"], window_s=got["window_s"])
            run_out["breakdown"] = capture.breakdown(got["activities"])
        run_out["capture"] = got

    run_out["observed"] = dict(
        algorithm=cfg["algorithm"], unit=dep.unit, lease=dep.unit, day=dep.day, pool=pool,
        sample_idx=sample_idx, limits=limits, sampled=sampled, base=base,
        now=np.array(chunks_now, dtype=np.int64),
        chunk_pool=np.array(chunks_pool, dtype=np.int64),
        codes=np.concatenate(codes) if codes else np.zeros(0, np.int32),
        remaining=np.concatenate(remaining) if remaining else np.zeros(0, np.int64),
        state=read_state(engine, dep, sampled),
    )
    return run_out


def read_state(engine, dep: Deployment, sampled: np.ndarray) -> np.ndarray:
    """int64[n, 3] of (key id, window, count): the program's state of the
    sampled key ids after the window, read from the table's arrays in
    bulk (no Python object a key); a key of no template reads as id -1."""
    ent = engine.slot_table.export_entries().arrays()
    counts = engine.export_counts()
    ids = dep.parse(np.asarray(ent.key_blob, dtype=np.uint8), ent.key_lens)
    keep = (ids < 0) | sampled[np.maximum(ids, 0)]
    slots = np.asarray(ent.slots, dtype=np.int64)[keep]
    windows = np.where(ids[keep] < 0, -1, dep.day)
    return np.stack([ids[keep], windows, counts[slots].astype(np.int64)], axis=1)
