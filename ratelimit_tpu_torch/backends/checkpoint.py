"""Counter-state checkpoint files and bank snapshots.

Port of ratelimit_tpu/backends/checkpoint.py.  The counters live on the
card, so a process restart would forgive every open window: this module
writes an atomic snapshot of each bank (state rows and slot table) to
``bank{idx}.npz`` in TPU_CHECKPOINT_DIR, periodically and at the end of
the drain, and restores them at boot.  The files are the JAX package's,
byte for byte in layout: either package restores the other's.

Restore needs no window bookkeeping: cache keys embed their window
start, so restored keys whose window has passed expire through the
slot table's gc, and a slot whose key is gone is zeroed on reuse.  A
crash between snapshots forgives at most one interval of hits.

A snapshot needs exclusive access to its bank (the dispatcher thread,
``cache.run_exclusive``).  Only the copy runs there: the state rows and
the slot table's entries as arrays (``copy_engine``).  Decoding the
keys, compressing and writing happen afterwards on the caller's thread,
so RPCs queued behind a snapshot of a full table wait for two copies,
not for a Python pass over every live key.  (The reference decodes
every key on the dispatcher thread; at 2^18 live keys that outlasts the
kernel deadline.)
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Optional

import numpy as np

from .slot_table import EntryArrays

logger = logging.getLogger("ratelimit.checkpoint")

FORMAT_VERSION = 1

# Restore-age guard: the longest fixed-window unit is a DAY, so no live
# counter can still be enforceable once a snapshot is older than that.
# Older snapshots are refused (skip and start fresh).
MAX_RESTORE_AGE_S = 86400.0


def bank_roles(cache) -> list:
    """Topology names for each cache.engines() position: lanes by
    index/count, the per-second bank by name, algorithm banks by
    algorithm, plain banks otherwise.  Restore refuses a file whose role
    is not its bank's, so a topology change never feeds one bank's keys
    into a different-purpose engine."""
    engines = cache.engines()
    lanes = getattr(cache, "lanes", None)
    per_second = getattr(cache, "per_second_engine", None)
    algo_banks = getattr(cache, "algorithm_banks", None) or {}
    algo_by_id = {id(e): name for name, e in algo_banks.items()}
    roles = []
    for idx, e in enumerate(engines):
        if lanes is not None and idx < len(lanes) and e is lanes[idx]:
            roles.append(f"lane{idx}of{len(lanes)}")
        elif per_second is not None and e is per_second:
            roles.append("per_second")
        elif id(e) in algo_by_id:
            roles.append("algo_" + algo_by_id[id(e)])
        else:
            roles.append(f"bank{idx}")
    return roles


def copy_engine(engine) -> tuple:
    """The part of a snapshot that needs exclusive access to `engine`:
    (state dict, the slot table's entries copied as they stand).  The
    state dict is ``{"counts": ...}`` for fixed-window banks and one
    named row per state array for algorithm banks (models/registry.py
    state_rows).  The copy's ``.entries()`` and ``.arrays()`` run
    later, anywhere."""
    return engine.export_state(), engine.slot_table.export_entries()


def write_snapshot(
    path: str,
    num_slots: int,
    state: dict,
    entries,
    role: str = "",
    algorithm: str = "fixed_window",
) -> int:
    """Serialize and atomically write a snapshot (no pickle: keys are
    stored as concatenated utf-8 bytes and a length array, so restore
    runs with allow_pickle=False).  `state` and `entries` are as
    ``copy_engine`` returns them: the state dict and a slot table's
    copy; `role` names the bank's place in the topology ("lane1of4",
    "per_second", "algo_gcra") and `algorithm` its kernel, both checked
    by restore_engine.  Returns the bytes written."""
    arr = entries.arrays()
    tmp = f"{path}.tmp.{os.getpid()}"
    meta = json.dumps(
        {
            "version": FORMAT_VERSION,
            "num_slots": num_slots,
            "role": role,
            "algorithm": algorithm,
            "state_rows": sorted(state),
            "saved_at": time.time(),
        }
    )
    arrays = {"state_" + name: a for name, a in state.items()}
    if list(state) == ["counts"]:
        # Fixed-window snapshots keep the historical layout.
        arrays = {"counts": state["counts"]}
    with open(tmp, "wb") as f:
        np.savez_compressed(
            f,
            meta=np.frombuffer(meta.encode(), dtype=np.uint8),
            key_lens=arr.key_lens,
            key_blob=arr.key_blob,
            slots=arr.slots,
            expiries=arr.expiries,
            **arrays,
        )
    os.replace(tmp, path)
    return os.path.getsize(path)


def save_engine(engine, path: str, role: str = "") -> None:
    """snapshot + write_snapshot in one call (tests, shutdown).  Callers
    on the serving path copy under exclusivity and write outside it
    (CheckpointManager.checkpoint)."""
    state, copied = copy_engine(engine)
    write_snapshot(
        path, engine.model.num_slots, state, copied, role,
        getattr(engine, "algorithm", "fixed_window"),
    )


def _read_snapshot(path, role, num_slots, algorithm, max_age_s, wall_now):
    """(state, entries, saved_at) of the snapshot at `path`, or None when
    it is missing or refused by a guard (version, age, role, num_slots,
    algorithm) or unreadable: each refusal is logged."""
    if not os.path.exists(path):
        return None
    try:
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(bytes(z["meta"]).decode())
            if meta.get("version") != FORMAT_VERSION:
                logger.warning("checkpoint %s: unknown version, skipping", path)
                return None
            saved_at = meta.get("saved_at", 0)
            age_s = wall_now() - saved_at
            if max_age_s and age_s > max_age_s:
                logger.warning(
                    "checkpoint %s: snapshot is %.0fs old (> %.0fs, the longest "
                    "window unit): refusing to resurrect expired counters, "
                    "starting fresh",
                    path, age_s, max_age_s,
                )
                return None
            saved_role = meta.get("role", "")
            if role and saved_role and saved_role != role:
                logger.warning(
                    "checkpoint %s: bank role %r != expected %r (topology "
                    "changed), skipping",
                    path, saved_role, role,
                )
                return None
            if meta.get("num_slots") != num_slots:
                logger.warning(
                    "checkpoint %s: num_slots %s != engine %s, skipping",
                    path, meta.get("num_slots"), num_slots,
                )
                return None
            saved_algo = meta.get("algorithm", "fixed_window")
            if saved_algo != algorithm:
                logger.warning(
                    "checkpoint %s: algorithm %r != engine %r (kernel state is "
                    "not interchangeable), skipping",
                    path, saved_algo, algorithm,
                )
                return None
            if "counts" in z.files:
                state = {"counts": z["counts"]}
            else:
                state = {
                    name[len("state_"):]: z[name]
                    for name in z.files
                    if name.startswith("state_")
                }
            entries = EntryArrays(
                z["key_blob"], z["key_lens"], z["slots"], z["expiries"]
            ).entries()
    except Exception as e:
        logger.warning("checkpoint %s unreadable (%s), starting fresh", path, e)
        return None
    return state, entries, saved_at


def restore_engine(
    engine,
    path: str,
    role: str = "",
    max_age_s: float = MAX_RESTORE_AGE_S,
    wall_now=time.time,
) -> bool:
    """Restore one engine bank from `path`; returns False, leaving the
    engine fresh, if the snapshot is missing or incompatible: another
    format version, older than ``max_age_s`` (one day, the longest
    window unit; 0 disables the guard; ``wall_now`` is the clock seam),
    another bank `role` (when both sides carry one), another
    ``num_slots`` or another algorithm.  Needs exclusive access to the
    engine (CheckpointManager.restore runs it on the dispatcher)."""
    algorithm = getattr(engine, "algorithm", "fixed_window")
    got = _read_snapshot(
        path, role, engine.model.num_slots, algorithm, max_age_s, wall_now
    )
    if got is None:
        return False
    state, entries, saved_at = got
    engine.import_state({k: v.astype(np.uint32) for k, v in state.items()})
    table_cls = type(engine.slot_table)
    if getattr(engine.slot_table, "refresh_expiry", False):
        # Algorithm banks keep the refresh-on-touch lease policy.
        engine.slot_table = table_cls.from_entries(
            engine.model.num_slots, entries, refresh_expiry=True
        )
    else:
        engine.slot_table = table_cls.from_entries(engine.model.num_slots, entries)
    engine.stat_live_keys = len(engine.slot_table)
    logger.warning(
        "restored %d live keys from %s (saved %.0fs ago)",
        len(entries), path, time.time() - saved_at,  # tpu-lint: disable=timing-discipline -- cross-restart age: wall stamps are all that survive a process boundary
    )
    return True


class CheckpointManager:
    """Periodic background snapshots of a cache's banks (CudaRateLimitCache
    or WriteBehindRateLimitCache) to ``bank{idx}.npz`` files, one per
    cache.engines() position."""

    def __init__(self, cache, directory: str, interval_s: float = 30.0):
        if interval_s <= 0:
            raise ValueError(
                f"checkpoint interval must be positive, got {interval_s} "
                "(leave TPU_CHECKPOINT_DIR empty to disable checkpointing)"
            )
        self.cache = cache
        self.directory = directory
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: Per bank of the last checkpoint(): {"role", "exclusive_ms",
        #: "bytes", "keys"}, or {"role", "skipped": why}.
        self.last: list = []
        os.makedirs(directory, exist_ok=True)

    def _bank_path(self, idx: int) -> str:
        return os.path.join(self.directory, f"bank{idx}.npz")

    def restore(self) -> int:
        """Restore every bank, each under its engine's exclusivity;
        returns how many were restored.  The fault domain's mirror seeds
        are then retaken from the restored tables: a seed the
        supervisor took before the restore would forgive the restored
        windows in a quarantine.  A backend with decision state on the
        host (write-behind's view) rebuilds it from the restored bank
        (``cache.on_restored``)."""
        restored = 0
        roles = bank_roles(self.cache)
        for idx, engine in enumerate(self.cache.engines()):
            done = []

            def restore(e=engine, i=idx, out=done):
                out.append(restore_engine(e, self._bank_path(i), roles[i]))

            self.cache.run_exclusive(engine, restore)
            restored += done[0]
        fd = getattr(self.cache, "fault_domain", None)
        if restored and fd is not None:
            fd.snapshot_now()
        if restored and hasattr(self.cache, "on_restored"):
            self.cache.on_restored()
        return restored

    def checkpoint(self) -> None:
        """Snapshot every bank now.  Only the copy runs under the bank's
        exclusivity (copy_engine); decoding, compression and the disk
        write happen on this thread.

        A quarantined bank (backends/fault_domain.py) has no live
        dispatcher: its HOST MIRROR, the state that serves, is written
        instead, so a process restart during a quarantine restores the
        mirror's counters.  A bank with no mirror (DEVICE_FAILURE_MODE
        allow or deny) keeps its previous file.  One broken bank never
        starves the others of snapshots."""
        roles = bank_roles(self.cache)
        fd = getattr(self.cache, "fault_domain", None)
        last = []
        for idx, engine in enumerate(self.cache.engines()):
            algorithm = getattr(engine, "algorithm", "fixed_window")
            if fd is not None and fd.is_quarantined(idx):
                snap = fd.mirror_snapshot(idx)
                if snap is None:
                    last.append({"role": roles[idx], "skipped": "no mirror"})
                    continue
                state, copied = snap
                entries = copied.arrays()
                nbytes = write_snapshot(
                    self._bank_path(idx), engine.model.num_slots, state, entries,
                    roles[idx], algorithm,
                )
                last.append({"role": roles[idx], "mirror": True, "bytes": nbytes,
                             "keys": len(entries.key_lens)})
                continue
            grabbed = {}

            def grab(e=engine, out=grabbed):
                t0 = time.perf_counter()
                out["state"], out["entries"] = copy_engine(e)
                out["exclusive_ms"] = (time.perf_counter() - t0) * 1e3

            try:
                self.cache.run_exclusive(engine, grab)
            except Exception:
                # The bank faulted between the quarantine check and the
                # snapshot token (dead dispatcher): skip it this round;
                # the fault domain's mirror covers the next.
                logger.exception("bank %d snapshot skipped", idx)
                last.append({"role": roles[idx], "skipped": "faulted"})
                continue
            entries = grabbed["entries"].arrays()
            nbytes = write_snapshot(
                self._bank_path(idx), engine.model.num_slots, grabbed["state"],
                entries, roles[idx], algorithm,
            )
            last.append({
                "role": roles[idx],
                "exclusive_ms": grabbed["exclusive_ms"],
                "bytes": nbytes,
                "keys": len(entries.key_lens),
            })
        self.last = last  # tpu-lint: disable=shared-state -- one writer at a time: stop() joins the loop thread before its final checkpoint, and each round publishes a fresh list in one assignment

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="checkpointer", daemon=True
        )
        self._thread.start()

    def stop(self, final_checkpoint: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        if final_checkpoint:
            try:
                self.checkpoint()
            except Exception:
                logger.exception("final checkpoint failed")

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.checkpoint()
            except Exception:
                logger.exception("periodic checkpoint failed")
