"""Descriptor-resolution cache: one dict hit from proto entries to
packed lanes.

The per-request Python pipeline — ``get_limit`` trie walk, key-stem
assembly, utf-8 encode, crc32 lane routing, per-lane ``LANE_DTYPE``
record construction — is window-independent for everything except the
window suffix and the hits addend.  A ``ResolutionCache`` memoizes all
of it per interned ``(domain, descriptor.entries)``: the matched
:class:`RateLimitRule` (or None / unlimited), its stats handles (which
the stats Manager already interns per key, so they survive reloads),
the encoded utf-8 key stem, the lane index (``crc32(stem) % n_lanes``),
the per-second-bank flag, and a pre-filled ``LANE_DTYPE`` template
record where only ``expiry`` and ``hits`` are stamped per request.

The reference memoizes only the cheap half of this (pooled
``bytes.Buffer`` key building, cache_key.go:17-29) and gets the rest
free from Go; here the full resolution is the measured host-path tax
(benchmarks/results/host_path.json) so the whole pipeline collapses
onto one dict hit.

Invalidation is a config **generation counter**: every
:class:`RateLimitConfig` carries a monotonically increasing
``generation`` (config/loader.py); entries record the generation they
were resolved under and miss when it moves.  A FAILED reload keeps the
old config object AND its old generation (service/ratelimit.py keeps
the previous config on ConfigError), so the warm cache survives bad
pushes.  Request-supplied overrides (``descriptor.limit is not None``)
bypass the cache entirely, and the entry map is capacity-bounded with
the same clear-on-full policy as the key-stem cache (rare full reset
beats per-entry LRU bookkeeping on the hot path).

Thread model: resolve() runs concurrently on RPC handler threads with
no lock — dict get/set are single atomic ops under the GIL, a racing
double-resolve builds equivalent entries (last write wins), and the
hit/miss tallies are plain ints whose rare lost increments are an
accepted stats-only race (the same trade the stem cache makes).

This module is dependency-light on purpose: the lane record dtype is
injected by the backend (``lane_dtype=LANE_DTYPE``) so the limiter
layer never imports the device stack.
"""

from __future__ import annotations

from typing import Optional, Tuple
from zlib import crc32

import numpy as np

from ..api import Descriptor, Unit
from ..models.registry import DEFAULT_ALGORITHM, get_algorithm
from ..utils.time import unit_to_divider
from .cache_key import CacheKey, build_stem

_MISSING_BANK_WARNED: set = set()


def _warn_missing_bank(algo: str) -> None:
    """One log line per (process, algorithm): a rule asked for an
    algorithm the backend has no engine bank for; it keeps limiting
    with the default kernel instead."""
    if algo in _MISSING_BANK_WARNED:
        return
    _MISSING_BANK_WARNED.add(algo)
    import logging

    logging.getLogger("ratelimit").warning(
        "rule requests algorithm %r but the backend has no bank for "
        "it; falling back to %s enforcement (enable the bank via "
        "TPU_ALGORITHM_BANKS)",
        algo,
        DEFAULT_ALGORITHM,
    )


class WindowState:
    """Everything about one (resolved descriptor, window) pair: the
    finished :class:`CacheKey`, its utf-8 encoding (the pack blob
    piece), and the template lane record with ``expiry`` pre-stamped
    to ``window_start + divider`` — per request only ``hits`` remains.
    ``template_bytes`` is the record's raw encoding: the packer joins
    these (bytes.join is ~an order cheaper than per-row structured-
    array assignment) and reinterprets the blob as one LANE_DTYPE
    array.

    For rules running a non-default algorithm in SHADOW mode the state
    additionally carries the candidate bank's pack pieces
    (``algo_key_bytes``/``algo_template_bytes``): the stable-stem key
    and a template whose expiry leases the slot for two windows past
    the current one (refresh-on-touch keeps it alive while hot).  An
    ENFORCING algorithm rule needs no extra fields — its primary
    key/template ARE the stable-stem ones.

    Immutable after construction; the owning entry swaps the whole
    object on window rollover so concurrent readers see either the old
    window's state or the new one, never a mix."""

    __slots__ = (
        "window",
        "cache_key",
        "key_bytes",
        "template",
        "template_bytes",
        "algo_key_bytes",
        "algo_template_bytes",
        "_arr",
    )

    def __init__(
        self,
        window: int,
        cache_key: CacheKey,
        key_bytes: bytes,
        template: Optional[np.void],
        arr: Optional[np.ndarray],
        algo_key_bytes: bytes = b"",
        algo_template_bytes: bytes = b"",
    ):
        self.window = window
        self.cache_key = cache_key
        self.key_bytes = key_bytes
        self.template = template
        self.template_bytes = arr.tobytes() if arr is not None else b""
        self.algo_key_bytes = algo_key_bytes
        self.algo_template_bytes = algo_template_bytes
        # The 1-element array backing `template` (np.void records are
        # views; keep the base alive explicitly).
        self._arr = arr


class ResolvedDescriptor:
    """One interned (domain, entries) resolution: rule + everything
    window-independent, plus a single-slot per-window memo."""

    __slots__ = (
        "generation",
        "rule",
        "unlimited",
        "per_second",
        "stem",
        "stem_bytes",
        "stem_hash",
        "n_lanes",
        "lane",
        "unit",
        "divider",
        "algorithm",
        "algo_id",
        "algo_shadow",
        "_lane_dtype",
        "_win",
        "hot",
    )

    def __init__(
        self,
        generation: int,
        rule,
        stem: str,
        n_lanes: int,
        lane_dtype,
        algorithms: frozenset = frozenset(),
    ):
        self.generation = generation
        self.rule = rule
        self.unlimited = rule is not None and rule.unlimited
        self.stem = stem
        self.stem_bytes = stem.encode("utf-8")
        # One crc32 per resolution (cold path): the lane route below
        # and the flight recorder's key-stem hash share it, so ring
        # records and lane hashing agree by construction.
        self.stem_hash = crc32(self.stem_bytes)
        self.n_lanes = n_lanes
        self.lane = self.stem_hash % n_lanes if n_lanes > 1 else 0
        self._lane_dtype = lane_dtype
        self._win: Optional[WindowState] = None
        # Hot-key sketch handle (observability/hotkeys.py), pinned by
        # the serving loop on first observation so the per-request
        # cost is one counter bump — None until tracked, and the
        # handle itself goes dead (key=None) on sketch eviction.
        self.hot = None
        if rule is not None and not rule.unlimited:
            self.unit = rule.limit.unit
            self.divider = unit_to_divider(self.unit)
            self.per_second = self.unit == Unit.SECOND
            # Algorithm-table routing (models/registry.py): resolved
            # once per entry so the serving loop reads plain attrs.
            # An algorithm the backend has NO bank for folds back to
            # the default — the rule keeps limiting (fixed-window)
            # instead of erroring every request it matches.
            algo = getattr(rule, "algorithm", DEFAULT_ALGORITHM)
            if algo != DEFAULT_ALGORITHM and algo not in algorithms:
                _warn_missing_bank(algo)
                algo = DEFAULT_ALGORITHM
            self.algorithm = algo
            self.algo_id = (
                0
                if algo == DEFAULT_ALGORITHM
                else get_algorithm(algo).algo_id
            )
            self.algo_shadow = self.algo_id != 0 and bool(
                getattr(rule, "algo_shadow", False)
            )
        else:
            self.unit = None
            self.divider = 0
            self.per_second = False
            self.algorithm = DEFAULT_ALGORITHM
            self.algo_id = 0
            self.algo_shadow = False

    def rehash_lanes(self, n_lanes: int) -> None:
        """Lane-count change (new cache topology): recompute the route
        for the new modulus.  The amnesia envelope is the same as a
        restart with a changed TPU_NUM_LANES — old windows' counters
        age out in the old lane while the key counts afresh."""
        self.lane = self.stem_hash % n_lanes if n_lanes > 1 else 0  # tpu-lint: disable=shared-state -- idempotent re-derivation: every racer computes the same value
        self.n_lanes = n_lanes  # tpu-lint: disable=shared-state -- idempotent re-derivation (same n_lanes input)

    def _algo_template_bytes(self, w: int) -> bytes:
        """Lane record for this entry's non-default algorithm bank:
        stable-stem key length, the rule's divider (the kernel's
        window/emission math needs it), and an expiry leasing the slot
        TWO windows past the current one — the algorithm banks'
        refresh-on-touch slot tables extend it while the key stays
        hot, so per-slot window/TAT state survives exactly as long as
        it matters."""
        rule = self.rule
        arr = np.empty(1, dtype=self._lane_dtype)
        arr[0] = (
            w + 2 * self.divider,  # expiry lease (refreshed on touch)
            1,  # hits pre-stamped to the common addend
            rule.limit.requests_per_unit,
            len(self.stem_bytes),
            1 if rule.shadow_mode else 0,
            self.divider,
            self.algo_id,
        )
        return arr.tobytes()

    def window_state(self, now: int) -> WindowState:
        """The memoized per-window state, rebuilt once per rollover.
        Byte-identical to CacheKeyGenerator output for fixed-window
        rules: key string is ``stem + str(window_start)``.  Rules
        ENFORCING a non-default algorithm key by the bare stem (their
        kernels track windows per slot); rules SHADOWING one keep the
        fixed-window primary and carry the candidate bank's pack
        pieces alongside."""
        # Inline window_start(now, unit): the divider is resolved once
        # at entry construction, so the hot path skips the per-call
        # Unit coercion + divider lookup (measured ~1.5us/descriptor).
        w = now - now % self.divider
        ws = self._win
        if ws is not None and ws.window == w:
            return ws
        algo_enforced = self.algo_id != 0 and not self.algo_shadow
        if algo_enforced:
            # Stable-stem identity: one key across window rollovers,
            # never routed to the per-second bank (algorithm banks are
            # unit-agnostic — the divider rides the lane record).
            ws = WindowState(
                w,
                CacheKey(self.stem, False, len(self.stem_bytes)),
                self.stem_bytes,
                None,
                None,
                algo_key_bytes=self.stem_bytes,
                algo_template_bytes=(
                    self._algo_template_bytes(w)
                    if self._lane_dtype is not None
                    else b""
                ),
            )
            self._win = ws  # tpu-lint: disable=shared-state -- whole-object swap: readers see the old or the new WindowState, never a mix (class docstring)
            return ws
        suffix = str(w)
        key_str = self.stem + suffix
        key_bytes = self.stem_bytes + suffix.encode("ascii")
        template = arr = None
        algo_tpl = b""
        if self._lane_dtype is not None:
            rule = self.rule
            arr = np.empty(1, dtype=self._lane_dtype)
            arr[0] = (
                w + self.divider,  # expiry base (jitter stamped later)
                1,  # hits pre-stamped to the common addend; the packer
                #    only overwrites when the request carries hits != 1
                rule.limit.requests_per_unit,
                len(key_bytes),
                1 if rule.shadow_mode else 0,
                0,  # divider: fixed-window kernels never read it
                0,  # algo: fixed_window
            )
            template = arr[0]
            if self.algo_shadow:
                algo_tpl = self._algo_template_bytes(w)
        ws = WindowState(
            w,
            CacheKey(key_str, self.per_second, len(self.stem_bytes)),
            key_bytes,
            template,
            arr,
            algo_key_bytes=self.stem_bytes if self.algo_shadow else b"",
            algo_template_bytes=algo_tpl,
        )
        self._win = ws  # single-slot swap: readers see old or new
        return ws


class ResolutionCache:
    """Per-service map from interned ``(domain, entries)`` to a
    :class:`ResolvedDescriptor`.  See module docstring for the
    invalidation and threading contract."""

    def __init__(
        self,
        prefix: str = "",
        n_lanes: int = 1,
        lane_dtype=None,
        capacity: int = 1 << 16,
        algorithms: frozenset = frozenset(),
    ):
        self.prefix = prefix
        self.n_lanes = max(1, int(n_lanes))
        self.lane_dtype = lane_dtype
        self.capacity = int(capacity)
        # Non-default algorithms the owning backend has banks for;
        # rules asking for anything else fold to the default kernel
        # (see ResolvedDescriptor).
        self.algorithms = frozenset(algorithms)
        self._entries: dict = {}
        # Stats-only tallies; benign GIL races accepted (see module
        # docstring).  Exported as counters via register_stats on the
        # owning backend.
        self.hits = 0
        self.misses = 0
        self.clears = 0

    def __len__(self) -> int:
        return len(self._entries)

    def resolve(self, config, domain: str, descriptor: Descriptor):
        """One dict hit on the hot path.  Returns None for
        request-supplied overrides (the caller falls back to the
        uncached ``get_limit`` + key-generator path); otherwise a
        :class:`ResolvedDescriptor` valid for ``config.generation``."""
        if descriptor.limit is not None:
            return None
        ck: Tuple[str, tuple] = (domain, descriptor.entries)
        e = self._entries.get(ck)
        if e is not None and e.generation == config.generation:
            if e.n_lanes != self.n_lanes:
                e.rehash_lanes(self.n_lanes)
            self.hits += 1  # tpu-lint: disable=shared-state -- stats-only tally; a lost increment skews a debug counter, never a decision
            return e
        self.misses += 1  # tpu-lint: disable=shared-state -- stats-only tally; a lost increment skews a debug counter, never a decision
        rule = config.get_limit(domain, descriptor)
        e = ResolvedDescriptor(
            config.generation,
            rule,
            build_stem(self.prefix, domain, descriptor.entries),
            self.n_lanes,
            self.lane_dtype if rule is not None and not rule.unlimited else None,
            algorithms=self.algorithms,
        )
        if len(self._entries) >= self.capacity:
            # Same clear-on-full policy as the stem cache: a key-
            # cardinality blowup resets the map (and is counted, so
            # it is visible on /metrics instead of silent).
            self._entries.clear()  # tpu-lint: disable=shared-state -- idempotent resolution cache; a racing clear only costs re-resolution
            self.clears += 1  # tpu-lint: disable=shared-state -- stats-only tally; a lost increment skews a debug counter, never a decision
        self._entries[ck] = e
        return e

    def clear(self) -> None:
        self._entries.clear()
        self.clears += 1
