"""Host-side cache-key -> HBM-slot assignment.

Redis gives the reference an unbounded keyspace with TTL eviction for
free; the TPU counter table is a fixed array, so the host owns the
mapping.  Design (SURVEY.md section 7 "hard parts (a)"):

- exact mapping via a dict (no hash-collision false sharing between
  tenants);
- keys embed their window start (cache_key.py), so each new window is
  a new key and dead keys are reclaimed by expiry;
- expiry = window end + optional jitter (the EXPIRATION_JITTER
  analog, settings.go:46, fixed_cache_impl.go:71-74), tracked in a
  lazy-deletion min-heap;
- when the table fills and nothing has expired, the soonest-expiring
  live key is evicted (its slot is zeroed on reuse via the batch's
  ``fresh`` flag, so eviction merely forgives the remainder of that
  key's window -- the same failure mode as Redis maxmemory eviction).

The table is SINGLE-TOUCHER by design: the dispatcher collector
thread owns it (SURVEY.md section 2 — checkpoints route through
run_on_thread instead of locking), so its state carries no locks.
"""
# tpu-lint: disable-file=shared-state -- single toucher: the dispatcher collector owns the table; checkpoints route through run_on_thread

from __future__ import annotations

import heapq
from typing import Dict, List, NamedTuple, Tuple

import numpy as np


class EntryArrays(NamedTuple):
    """A table's live (key, slot, expiry) entries as the arrays of a
    checkpoint file: the utf-8 keys back to back, their lengths, their
    slots and expiries."""

    key_blob: np.ndarray  # uint8
    key_lens: np.ndarray  # int64
    slots: np.ndarray  # int64
    expiries: np.ndarray  # int64

    @classmethod
    def from_entries(cls, entries) -> "EntryArrays":
        encoded = [e[0].encode("utf-8") for e in entries]
        return cls(
            np.frombuffer(b"".join(encoded), dtype=np.uint8),
            np.array([len(b) for b in encoded], dtype=np.int64),
            np.array([e[1] for e in entries], dtype=np.int64),
            np.array([e[2] for e in entries], dtype=np.int64),
        )

    def arrays(self) -> "EntryArrays":
        return self

    def select(self, mask: np.ndarray) -> "EntryArrays":
        """The entries where `mask` is True, in order."""
        mask = np.asarray(mask, dtype=bool)
        return EntryArrays(
            self.key_blob[np.repeat(mask, self.key_lens)],
            self.key_lens[mask],
            self.slots[mask],
            self.expiries[mask],
        )

    def keys(self) -> List[str]:
        """The keys alone, decoded: one str per entry and no tuple, so a
        pass over a full table leaves the cyclic collector nothing to
        trace."""
        raw = self.key_blob.tobytes()
        ends = np.cumsum(self.key_lens).tolist()
        return [raw[a:b].decode("utf-8") for a, b in zip([0] + ends[:-1], ends)]

    def entries(self) -> List[Tuple[str, int, int]]:
        raw = self.key_blob.tobytes()
        out = []
        off = 0
        for n, slot, expiry in zip(
            self.key_lens.tolist(), self.slots.tolist(), self.expiries.tolist()
        ):
            out.append((raw[off : off + n].decode("utf-8"), slot, expiry))
            off += n
        return out


def stamp_table_stats(engine, table) -> None:
    """Stamp `engine`'s gauges of `table`'s own counters
    (NativeSlotTable.stats): ``stat_lookups``, ``stat_probes``,
    ``stat_rehashes``, ``stat_rehash_ns`` and ``stat_index_bytes``.  A
    table that keeps none (the Python one) leaves them as they are."""
    stats = getattr(table, "stats", None)
    if stats is None:
        return
    s = stats()
    engine.stat_lookups = s.lookups
    engine.stat_probes = s.probes
    engine.stat_rehashes = s.rehashes
    engine.stat_rehash_ns = s.rehash_ns
    engine.stat_index_bytes = s.index_bytes


class _MapCopy:
    """A Python table's entries, copied in one C-level pass under the
    table owner's exclusivity and turned into triples or arrays after."""

    def __init__(self, items):
        self._items = items

    def entries(self) -> List[Tuple[str, int, int]]:
        return [(k, s, e) for k, (s, e) in self._items]

    def arrays(self) -> EntryArrays:
        return EntryArrays.from_entries(self.entries())


class SlotTable:
    def __init__(self, num_slots: int, refresh_expiry: bool = False):
        """``refresh_expiry=True`` extends a live key's expiry on every
        assign (to the max of old and new): stable-stem algorithms
        (sliding-window/GCRA, models/registry.py windowed_keys=False)
        re-use ONE key across window rollovers and carry state the
        slot must keep while the key stays hot — without refresh, a
        continuously hot key would be reclaimed ``expiry - first
        sight`` seconds in and its window/TAT state forgiven.
        Fixed-window keys embed their window (a new window is a new
        key), so the default stays append-only."""
        self.num_slots = int(num_slots)
        self.refresh_expiry = bool(refresh_expiry)
        self._map: Dict[str, Tuple[int, int]] = {}  # key -> (slot, expiry)
        self._free: List[int] = list(range(self.num_slots - 1, -1, -1))
        self._heap: List[Tuple[int, str]] = []  # (expiry, key), lazy-deleted
        self._pinned: set = set()  # keys in the batch being assembled
        self._batch_active = False
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._map)

    def assign(self, key: str, now: int, expiry: int) -> Tuple[int, bool]:
        """Slot for `key`, allocating on first sight.

        Returns ``(slot, fresh)``; ``fresh`` means the slot was just
        (re)assigned and the device must zero it before adding.
        """
        entry = self._map.get(key)
        if entry is not None:
            # Pin existing keys too: a slot already handed out in this
            # batch must not be evicted for a later lane (it would
            # alias two live keys inside one device step).
            if self._batch_active:
                self._pinned.add(key)
            if self.refresh_expiry and expiry > entry[1]:
                # Touch extends the lease; the superseded heap entry
                # lazy-deletes (gc/_evict_one skip entries whose expiry
                # no longer matches the map).
                self._map[key] = (entry[0], expiry)
                heapq.heappush(self._heap, (expiry, key))
            return entry[0], False

        if not self._free:
            self.gc(now)
        if not self._free:
            self._evict_one()

        slot = self._free.pop()
        self._map[key] = (slot, expiry)
        heapq.heappush(self._heap, (expiry, key))
        if self._batch_active:
            self._pinned.add(key)
        return slot, True

    def begin_batch(self) -> None:
        """Start pinning: keys assigned until ``end_batch`` cannot be
        evicted, so two live keys in one device batch never share a
        slot."""
        self._batch_active = True
        self._pinned.clear()

    def end_batch(self) -> None:
        self._batch_active = False
        self._pinned.clear()

    def assign_batch(self, keys, now: int, expiries):
        """Assign every key (pinned together); returns (slots, fresh)
        numpy arrays.  Same surface as NativeSlotTable.assign_batch."""
        import numpy as np

        n = len(keys)
        slots = np.empty(n, dtype=np.int64)
        fresh = np.empty(n, dtype=bool)
        self.begin_batch()
        try:
            for j, (key, expiry) in enumerate(zip(keys, expiries)):
                slots[j], fresh[j] = self.assign(key, now, expiry)
        finally:
            self.end_batch()
        return slots, fresh

    def entries(self) -> List[Tuple[str, int, int]]:
        """Live (key, slot, expiry) triples (checkpoint export)."""
        return [(k, s, e) for k, (s, e) in self._map.items()]

    def export_entries(self) -> _MapCopy:
        """The live entries, copied at once; ``.entries()`` and
        ``.arrays()`` of the copy run later, off the owner thread."""
        return _MapCopy(list(self._map.items()))

    def release_arrays(self, moved: EntryArrays) -> np.ndarray:
        """Drop each entry of `moved` that the table still holds as
        given (same key, slot and expiry) and free its slot; returns the
        freed slots, as NativeSlotTable.release_arrays does.  A key
        since reclaimed by gc, or whose slot went to another key, stays.
        A refreshing table extends a live key's lease on every touch,
        so there a later expiry still matches."""
        freed = []
        for key, slot, expiry in moved.entries():
            cur = self._map.get(key)
            if cur is None or cur[0] != slot:
                continue
            if cur[1] != expiry and not (self.refresh_expiry and cur[1] > expiry):
                continue
            del self._map[key]
            self._free.append(slot)
            freed.append(slot)
        return np.asarray(freed, dtype=np.int64)

    @classmethod
    def from_entries(
        cls,
        num_slots: int,
        entries: List[Tuple[str, int, int]],
        refresh_expiry: bool = False,
    ) -> "SlotTable":
        """Rebuild a table from checkpointed entries (restore path)."""
        t = cls(num_slots, refresh_expiry=refresh_expiry)
        used = set()
        for key, slot, expiry in entries:
            slot = int(slot)
            if slot < 0 or slot >= num_slots or slot in used:
                continue  # corrupt/duplicate entry: drop, don't crash
            if key in t._map:
                continue  # duplicate key: keep the first entry's slot
            used.add(slot)
            t._map[key] = (slot, int(expiry))
            heapq.heappush(t._heap, (int(expiry), key))
        t._free = [s for s in range(num_slots - 1, -1, -1) if s not in used]
        return t

    def gc(self, now: int) -> int:
        """Reclaim slots of expired keys; returns how many were freed.

        Keys pinned by the in-flight batch are skipped and re-queued —
        reclaiming a slot already handed out earlier in the same batch
        (a key expiring at the batch's `now`) would alias two live keys
        in one device step (same rule as _evict_one)."""
        freed = 0
        skipped = []
        while self._heap and self._heap[0][0] <= now:
            expiry, key = heapq.heappop(self._heap)
            entry = self._map.get(key)
            if entry is None or entry[1] != expiry:
                continue
            if self._batch_active and key in self._pinned:
                skipped.append((expiry, key))
                continue
            del self._map[key]
            self._free.append(entry[0])
            freed += 1
        for item in skipped:
            heapq.heappush(self._heap, item)
        return freed

    def _evict_one(self) -> None:
        """Evict the soonest-expiring live key (table full, nothing
        expired).  Keys pinned by the in-flight batch are skipped and
        re-queued so a batch never self-collides."""
        skipped: List[Tuple[int, str]] = []
        try:
            while self._heap:
                expiry, key = heapq.heappop(self._heap)
                entry = self._map.get(key)
                if entry is None or entry[1] != expiry:
                    continue  # lazy-deleted
                if key in self._pinned:
                    skipped.append((expiry, key))
                    continue
                del self._map[key]
                self._free.append(entry[0])
                self.evictions += 1
                return
        finally:
            for item in skipped:
                heapq.heappush(self._heap, item)
        raise RuntimeError(
            "slot table exhausted: batch holds more live keys than "
            f"slots ({self.num_slots}); raise TPU_NUM_SLOTS above the "
            "max batch size"
        )
