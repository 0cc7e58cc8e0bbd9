"""ctypes binding for the C++ slot table (native/slot_table.cpp) and
the fused host decide pass (native/decide.cpp).

Port of ratelimit_tpu/backends/native_slot_table.py.  The port
compiles the same sources, read as they are, with g++ into its own
library under ratelimit_tpu_torch/_build/ (listed in .gitignore); it
never loads the reference package's library and has no environment
override for the library path.  Same contract as the Python SlotTable
(backends/slot_table.py), which stays the fallback when no compiler is
present.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

from .slot_table import EntryArrays

logger = logging.getLogger("ratelimit.native")

_LIB: Optional[ctypes.CDLL] = None
_LIB_LOCK = threading.Lock()
_LIB_FAILED = False

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
# The port's own translation unit includes native/slot_table.cpp and
# adds the handoff's release (csrc/slot_release.cpp).
_SRCS = [
    os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc", "slot_release.cpp"
    ),
    os.path.join(_NATIVE_DIR, "decide.cpp"),
]
#: Every source the build reads, the included slot table too.
_DIGEST_SRCS = _SRCS + [os.path.join(_NATIVE_DIR, "slot_table.cpp")]
_SO = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "_build",
    "libslottable.so",
)
# Content stamp beside the .so: the binary is NOT checked in (a
# committed binary with a fresh clone mtime silently wins over newer
# sources); instead the build records the sha256
# of the sources it compiled, and the loader rebuilds on any mismatch.
# mtimes never participate, so git checkouts can't fake freshness.
_STAMP = _SO + ".stamp"


def _src_digest() -> Optional[str]:
    h = hashlib.sha256()
    try:
        for s in _DIGEST_SRCS:
            with open(s, "rb") as f:
                h.update(f.read())
    except OSError:
        return None
    return h.hexdigest()


def _build(digest: Optional[str] = None) -> bool:
    if not all(os.path.exists(s) for s in _DIGEST_SRCS):
        return False
    # Build to a temp path + atomic rename: concurrent processes never
    # dlopen a half-written .so, and a rebuild never truncates a file
    # another running process has mapped (the old inode survives).
    tmp = f"{_SO}.tmp.{os.getpid()}"
    try:
        os.makedirs(os.path.dirname(_SO), exist_ok=True)
        subprocess.run(
            ["g++", "-O2", "-std=c++20", "-shared", "-fPIC", "-o", tmp]
            + _SRCS,
            check=True,
            capture_output=True,
            timeout=120,
        )
        os.replace(tmp, _SO)
        digest = digest or _src_digest()
        if digest:
            stamp_tmp = f"{_STAMP}.tmp.{os.getpid()}"
            with open(stamp_tmp, "w") as f:
                f.write(digest)
            os.replace(stamp_tmp, _STAMP)
        return True
    except (OSError, subprocess.SubprocessError) as e:
        logger.warning("native slot table build failed (%s); using Python", e)
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def _signatures(lib: ctypes.CDLL) -> None:
    # All pointer parameters are declared c_void_p and passed as RAW
    # ADDRESS INTS (arr.ctypes.data): building a typed POINTER object
    # per argument (data_as) costs ~2.6us each, and the hot calls take
    # 10-27 pointers — at small serving batches that marshaling was
    # ~40% of the whole native call (profile, round 4).  The C side is
    # unchanged; int addresses are valid c_void_p values.  Every array
    # passed is a live local of the calling function, so the missing
    # keep-alive reference data_as provided is not needed.
    i64, vp = ctypes.c_int64, ctypes.c_void_p
    lib.sk_create.restype = vp
    lib.sk_create.argtypes = [i64]
    lib.sk_destroy.restype = None
    lib.sk_destroy.argtypes = [vp]
    lib.sk_len.restype = i64
    lib.sk_len.argtypes = [vp]
    lib.sk_evictions.restype = i64
    lib.sk_evictions.argtypes = [vp]
    lib.sk_arena_bytes.restype = i64
    lib.sk_arena_bytes.argtypes = [vp]
    lib.sk_gc.restype = i64
    lib.sk_gc.argtypes = [vp, i64]
    lib.sk_begin_batch.restype = None
    lib.sk_begin_batch.argtypes = [vp]
    lib.sk_end_batch.restype = None
    lib.sk_end_batch.argtypes = [vp]
    lib.sk_assign_batch.restype = i64
    lib.sk_assign_batch.argtypes = [vp, vp, vp, i64, i64, vp, vp, vp]
    lib.sk_assign_dedup_batch.restype = i64
    lib.sk_assign_dedup_batch.argtypes = [
        vp, vp, vp, i64, i64, vp, vp, vp,
        vp, vp, vp, vp, vp, vp,
    ]
    lib.sk_export_size.restype = i64
    lib.sk_export_size.argtypes = [vp, vp]
    lib.sk_export.restype = None
    lib.sk_export.argtypes = [vp, vp, vp, vp, vp]
    lib.sk_import.restype = i64
    lib.sk_import.argtypes = [vp, vp, vp, vp, vp, i64]
    lib.sk_release_batch.restype = i64
    lib.sk_release_batch.argtypes = [vp, vp, vp, vp, vp, i64, vp]
    lib.sk_decide_reconstruct.restype = None
    lib.sk_decide_reconstruct.argtypes = [
        vp, vp, i64,  # afters_g, totals, g
        vp, vp, vp, vp, vp, i64,  # inv, prefix, hits, limits, shadow, n
        ctypes.c_float, ctypes.c_int32, ctypes.c_int32,  # ratio, codes
        vp, vp, vp, vp, vp, vp, vp, vp, vp,  # outputs
    ]


def expected_symbols() -> frozenset:
    """Every symbol the ctypes table declares, derived from
    _signatures itself (single source of truth: a symbol added there
    is automatically part of the load-time preflight)."""

    class _Slot:
        def __init__(self):
            self.__dict__ = {}

    class _Recorder:
        def __init__(self):
            self.names = set()

        def __getattr__(self, name):
            self.names.add(name)
            slot = _Slot()
            self.__dict__[name] = slot
            return slot

    rec = _Recorder()
    _signatures(rec)  # type: ignore[arg-type]
    return frozenset(rec.names)


def _missing_symbols(lib: ctypes.CDLL) -> List[str]:
    missing = []
    for name in sorted(expected_symbols()):
        if not hasattr(lib, name):
            missing.append(name)
    return missing


def _staleness_hint() -> str:
    """One-line mtime comparison for the load-failure message.  The
    stamp (content hash) is the rebuild authority; mtimes are only
    quoted as a human-readable hint about HOW the tree got stale."""
    try:
        so_mtime = os.path.getmtime(_SO)
        src_mtime = max(os.path.getmtime(s) for s in _SRCS)
    except OSError:
        return ""
    if so_mtime < src_mtime:
        return (
            " (.so predates native/*.cpp by "
            f"{src_mtime - so_mtime:.0f}s — stale build)"
        )
    return ""


def _verify_symbols(lib: ctypes.CDLL, path: str) -> bool:
    """Preflight the exported symbol set BEFORE any signature is
    declared, so a stale/foreign .so fails the load with a rebuild
    hint instead of an AttributeError at first call."""
    missing = _missing_symbols(lib)
    if not missing:
        return True
    logger.warning(
        "native library %s is missing exported symbol(s) %s%s; "
        "delete it to rebuild",
        path,
        ", ".join(missing),
        _staleness_hint(),
    )
    return False


def loaded_path() -> Optional[str]:
    """Path of the .so actually loaded (None when unavailable)."""
    lib = _get_lib()
    return getattr(lib, "_name", None) if lib is not None else None


def _get_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_FAILED
    if _LIB is not None or _LIB_FAILED:
        return _LIB
    with _LIB_LOCK:
        if _LIB is not None or _LIB_FAILED:
            return _LIB
        digest = _src_digest()
        stamp = None
        try:
            with open(_STAMP) as f:
                stamp = f.read().strip()
        except OSError:
            pass
        # Rebuild unless the existing .so's stamp matches the current
        # source CONTENT (mtimes are meaningless after a git checkout).
        # Sources unreadable (a packaged install shipping only the
        # binary): trust an existing .so — there is nothing to be
        # stale against.
        needs_build = (
            not os.path.exists(_SO)
            if digest is None
            else stamp != digest
        )
        if needs_build and not _build(digest):
            _LIB_FAILED = True
            return None
        # Load + preflight the whole expected symbol set up front: a
        # stale .so (e.g. a cached build artifact with a satisfied
        # stamp) fails HERE with a rebuild hint, never with an
        # AttributeError at the first call — rebuild once, then fall
        # back to Python.
        err: object = "missing exported symbols"
        for attempt in (0, 1):
            try:
                lib = ctypes.CDLL(_SO)
            except OSError as e:
                err = e
                lib = None
            if lib is not None and _verify_symbols(lib, _SO):
                _signatures(lib)
                _LIB = lib
                return _LIB
            if attempt == 0 and not _build():
                break
        logger.warning(
            "native slot table load failed (%s); using Python — "
            "delete ratelimit_tpu_torch/_build/ to rebuild",
            err,
        )
        _LIB_FAILED = True
    return _LIB


def available() -> bool:
    return _get_lib() is not None


def _pack_keys(keys: List[str]) -> Tuple[np.ndarray, np.ndarray]:
    encoded = [k.encode("utf-8") for k in keys]
    lens = np.fromiter((len(b) for b in encoded), dtype=np.int64, count=len(encoded))
    blob = np.frombuffer(b"".join(encoded), dtype=np.uint8)
    return blob, lens


def _ptr(a: np.ndarray) -> int:
    """Raw data address for a c_void_p parameter (see _signatures)."""
    return a.ctypes.data


def decide_reconstruct(
    afters_g: np.ndarray,
    totals: np.ndarray,
    inv: np.ndarray,
    prefix: np.ndarray,
    hits: np.ndarray,
    limits: np.ndarray,
    shadow: np.ndarray,
    near_ratio: float,
    ok_code: int,
    over_code: int,
):
    """One C pass over a deduped chunk: per-lane before/after
    reconstruction from per-group device afters + the threshold state
    machine (native/decide.cpp — the fused mirror of
    engine._decide_host + limiter.base.decide_batch).

    Returns (codes i32, remaining i64, befores i64, afters i64,
    over i64, near i64, within i64, shadow i64, set_lc bool), all
    length n.  Raises RuntimeError if the native lib is unavailable
    (callers normally gate on available() first).
    """
    lib = _get_lib()
    if lib is None:
        raise RuntimeError(
            "native decide library unavailable — check available() "
            "before calling decide_reconstruct()"
        )
    n = len(hits)
    g = len(afters_g)
    afters_g = np.ascontiguousarray(afters_g, dtype=np.uint32)
    totals = np.ascontiguousarray(totals, dtype=np.uint64)
    inv = np.ascontiguousarray(inv, dtype=np.int32)
    prefix = np.ascontiguousarray(prefix, dtype=np.uint64)
    hits = np.ascontiguousarray(hits, dtype=np.uint32)
    limits = np.ascontiguousarray(limits, dtype=np.uint32)
    shadow = np.ascontiguousarray(shadow, dtype=np.uint8)
    out_codes = np.empty(n, dtype=np.int32)
    # The seven int64 outputs share ONE allocation; the C side's
    # per-field pointers are row offsets into it (7 fewer argument
    # marshals and allocations per call — small-batch latency).
    out_i64 = np.empty((7, n), dtype=np.int64)
    out_set_lc = np.empty(n, dtype=np.bool_)
    base = out_i64.ctypes.data
    row = n * 8
    lib.sk_decide_reconstruct(
        _ptr(afters_g),
        _ptr(totals),
        g,
        _ptr(inv),
        _ptr(prefix),
        _ptr(hits),
        _ptr(limits),
        _ptr(shadow),
        n,
        ctypes.c_float(near_ratio),
        int(ok_code),
        int(over_code),
        _ptr(out_codes),
        base,  # remaining
        base + row,  # befores
        base + 2 * row,  # afters
        base + 3 * row,  # over
        base + 4 * row,  # near
        base + 5 * row,  # within
        base + 6 * row,  # shadow
        _ptr(out_set_lc),
    )
    return (
        out_codes,
        out_i64[0],
        out_i64[1],
        out_i64[2],
        out_i64[3],
        out_i64[4],
        out_i64[5],
        out_i64[6],
        out_set_lc,
    )


class NativeSlotTable:
    """Drop-in for backends.slot_table.SlotTable backed by C++."""

    def __init__(self, num_slots: int):
        lib = _get_lib()
        if lib is None:
            raise RuntimeError("native slot table library unavailable")
        self._lib = lib
        self.num_slots = int(num_slots)
        self._handle = lib.sk_create(self.num_slots)

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.sk_destroy(handle)
            self._handle = None

    def __len__(self) -> int:
        return int(self._lib.sk_len(self._handle))

    @property
    def evictions(self) -> int:
        return int(self._lib.sk_evictions(self._handle))

    @property
    def arena_bytes(self) -> int:
        """Key-arena footprint incl. uncompacted tombstone bytes."""
        return int(self._lib.sk_arena_bytes(self._handle))

    def gc(self, now: int) -> int:
        return int(self._lib.sk_gc(self._handle, int(now)))

    def begin_batch(self) -> None:
        """Start cross-call pinning (same protocol as the Python
        table): every key touched until end_batch cannot be evicted."""
        self._lib.sk_begin_batch(self._handle)

    def end_batch(self) -> None:
        self._lib.sk_end_batch(self._handle)

    def assign_batch(
        self, keys: List[str], now: int, expiries: List[int]
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Assign every key in one FFI call; returns (slots, fresh)."""
        n = len(keys)
        if n == 0:
            return np.zeros(0, np.int64), np.zeros(0, bool)
        blob, lens = _pack_keys(keys)
        exp = np.asarray(expiries, dtype=np.int64)
        out_slots = np.empty(n, dtype=np.int64)
        out_fresh = np.empty(n, dtype=np.uint8)
        rc = self._lib.sk_assign_batch(
            self._handle,
            _ptr(blob),
            _ptr(lens),
            n,
            int(now),
            _ptr(exp),
            _ptr(out_slots),
            _ptr(out_fresh),
        )
        if rc != 0:
            raise RuntimeError(
                "slot table exhausted: batch holds more live keys than "
                f"slots ({self.num_slots}); raise TPU_NUM_SLOTS above the "
                "max batch size"
            )
        return out_slots, out_fresh.astype(bool)

    def assign(self, key: str, now: int, expiry: int) -> Tuple[int, bool]:
        slots, fresh = self.assign_batch([key], now, [expiry])
        return int(slots[0]), bool(fresh[0])

    def assign_dedup_packed(
        self,
        key_blob: np.ndarray,
        key_lens: np.ndarray,
        now: int,
        expiries: np.ndarray,
        hits: np.ndarray,
        limits: np.ndarray,
    ):
        """Fused assign + duplicate-slot aggregation in ONE C call (the
        native version of engine._dedup_chunk folded into the key walk).

        `key_blob` is the concatenated utf-8 keys (uint8 array),
        `key_lens` int64 per-key lengths; hits/limits uint32 per lane.
        Returns (inv, uniq_slots, totals, prefix, fresh_g, limit_max)
        with groups in sorted-slot order (np.unique parity — the
        sharded engine's bank routing relies on it).
        """
        n = len(key_lens)
        if n == 0:
            z = np.zeros(0, dtype=np.int32)
            return (
                z,
                z,
                np.zeros(0, np.uint64),
                np.zeros(0, np.uint64),
                np.zeros(0, bool),
                np.zeros(0, np.uint32),
            )
        key_lens = np.ascontiguousarray(key_lens, dtype=np.int64)
        expiries = np.ascontiguousarray(expiries, dtype=np.int64)
        hits = np.ascontiguousarray(hits, dtype=np.uint32)
        limits = np.ascontiguousarray(limits, dtype=np.uint32)
        out_group = np.empty(n, dtype=np.int32)
        out_uniq = np.empty(n, dtype=np.int32)
        out_totals = np.empty(n, dtype=np.uint64)
        out_prefix = np.empty(n, dtype=np.uint64)
        out_freshg = np.empty(n, dtype=np.uint8)
        out_limitmax = np.empty(n, dtype=np.uint32)
        g = self._lib.sk_assign_dedup_batch(
            self._handle,
            _ptr(key_blob),
            _ptr(key_lens),
            n,
            int(now),
            _ptr(expiries),
            _ptr(hits),
            _ptr(limits),
            _ptr(out_group),
            _ptr(out_uniq),
            _ptr(out_totals),
            _ptr(out_prefix),
            _ptr(out_freshg),
            _ptr(out_limitmax),
        )
        if g < 0:
            raise RuntimeError(
                "slot table exhausted: batch holds more live keys than "
                f"slots ({self.num_slots}); raise TPU_NUM_SLOTS above the "
                "max batch size"
            )
        g = int(g)
        return (
            out_group,
            out_uniq[:g],
            out_totals[:g],
            out_prefix,
            out_freshg[:g].astype(bool),
            out_limitmax[:g],
        )

    # -- checkpoint surface ---------------------------------------------

    def entries(self) -> List[Tuple[str, int, int]]:
        return self.export_entries().entries()

    def export_entries(self) -> EntryArrays:
        """The live entries as arrays, in one native pass; decoding the
        keys (``.entries()``) can run later, off the owner thread."""
        total_bytes = ctypes.c_int64(0)
        n = int(self._lib.sk_export_size(self._handle, ctypes.byref(total_bytes)))
        blob = np.empty(total_bytes.value if n else 0, dtype=np.uint8)
        lens = np.empty(n, dtype=np.int64)
        slots = np.empty(n, dtype=np.int64)
        expiries = np.empty(n, dtype=np.int64)
        if n:
            self._lib.sk_export(
                self._handle, _ptr(blob), _ptr(lens), _ptr(slots), _ptr(expiries)
            )
        return EntryArrays(blob, lens, slots, expiries)

    def release_arrays(self, moved: EntryArrays) -> np.ndarray:
        """Drop each entry of `moved` that the table still holds as
        given (same key, slot and expiry) and free its slot, in one C
        call (csrc/slot_release.cpp); returns the freed slots."""
        n = len(moved.slots)
        if n == 0:
            return np.zeros(0, dtype=np.int64)
        blob = np.ascontiguousarray(moved.key_blob, dtype=np.uint8)
        lens = np.ascontiguousarray(moved.key_lens, dtype=np.int64)
        slots = np.ascontiguousarray(moved.slots, dtype=np.int64)
        exp = np.ascontiguousarray(moved.expiries, dtype=np.int64)
        out = np.zeros(n, dtype=np.uint8)
        self._lib.sk_release_batch(
            self._handle, _ptr(blob), _ptr(lens), _ptr(slots), _ptr(exp), n, _ptr(out)
        )
        return slots[out.astype(bool)]

    @classmethod
    def from_entries(cls, num_slots: int, entries) -> "NativeSlotTable":
        t = cls(num_slots)
        if entries:
            keys = [e[0] for e in entries]
            blob, lens = _pack_keys(keys)
            slots = np.asarray([e[1] for e in entries], dtype=np.int64)
            exp = np.asarray([e[2] for e in entries], dtype=np.int64)
            t._lib.sk_import(
                t._handle, _ptr(blob), _ptr(lens), _ptr(slots), _ptr(exp), len(keys)
            )
        return t
