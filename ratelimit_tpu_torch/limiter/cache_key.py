"""Cache-key generation.

Key layout is wire-compatible with the reference
(src/limiter/cache_key.go:48-80):

    <prefix><domain>_<key>_<value>_..._<window_start>

where entries with empty values still contribute a trailing underscore
(``key__``), and ``window_start = (now // divider) * divider``.  A key is
the identity of one (descriptor, window) counter; a new window produces a
brand-new key, which is how fixed windows "expire" without TTLs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

from ..api import Descriptor, Unit
from ..config import RateLimitRule
from ..utils.time import window_start


@dataclass(frozen=True, slots=True)
class CacheKey:
    key: str
    # True when the limit's unit is SECOND; routes to the dedicated
    # per-second counter bank (dual-Redis analog, cache_key.go:34-40).
    per_second: bool
    # utf-8 byte length of the window-independent stem prefix of
    # ``key``.  Lane routing hashes the stem (not the full key) so a
    # key keeps its lane across window rollovers and so the cached
    # (limiter/resolution.py) and uncached paths route identically; 0
    # means unknown (hand-built keys) and falls back to the full key.
    stem_blen: int = 0


EMPTY_KEY = CacheKey("", False)


def build_stem(prefix: str, domain: str, entries: Sequence) -> str:
    """The window-independent key prefix
    (``<prefix><domain>_<k>_<v>_..._``) — the single construction site
    shared by CacheKeyGenerator and the descriptor-resolution cache so
    the two paths can never drift byte-wise."""
    parts = [prefix, domain, "_"]
    append = parts.append  # hoisted: 4 loads/lane otherwise (tpu-lint)
    for entry in entries:
        append(entry.key)
        append("_")
        append(entry.value)
        append("_")
    return "".join(parts)


class CacheKeyGenerator:
    """Builds counter keys; memoizes the window-independent STEM
    (``<prefix><domain>_<k>_<v>_..._``) per (domain, entries), so hot
    descriptors cost one dict hit + one concat instead of rebuilding
    the whole key every request (the reference pools bytes.Buffers for
    the same reason, cache_key.go:17-29).  The stem is rule-agnostic
    (the unit only affects the appended window), so config reloads
    never invalidate it."""

    def __init__(self, prefix: str = "", stem_cache_entries: int = 1 << 16):
        self.prefix = prefix
        self._stems: dict = {}
        self._stem_cap = int(stem_cache_entries)
        # Full-clear tally (clear-on-full capacity policy); exported
        # as `...stem_cache_clears` so a key-cardinality blowup is
        # visible on /metrics instead of silent.
        self.clears = 0

    def __len__(self) -> int:
        return len(self._stems)

    def generate(
        self, domain: str, descriptor: Descriptor, rule: Optional[RateLimitRule], now: int
    ) -> CacheKey:
        """Build the counter key for one descriptor at time `now`.

        Returns an empty key for descriptors with no matching rule so
        result arrays stay index-aligned with the request
        (cache_key.go:51-56).
        """
        if rule is None or rule.unlimited:
            # Unlimited rules never reach a counter; the service layer
            # answers them directly (reference ratelimit.go:140-144
            # nils them out before DoLimit; guarded here too so the
            # cache seam can't crash on Unit.UNKNOWN).
            return EMPTY_KEY
        unit = rule.limit.unit
        window = window_start(now, unit)
        per_second = unit == Unit.SECOND
        ck = (domain, descriptor.entries)
        ce = self._stems.get(ck)
        if ce is None:
            if len(self._stems) >= self._stem_cap:
                # Rare full reset beats per-entry LRU bookkeeping on
                # the hot path; regeneration is just the uncached cost.
                self._stems.clear()  # tpu-lint: disable=shared-state -- idempotent interning cache; a racing clear only costs regeneration
                self.clears += 1  # tpu-lint: disable=shared-state -- stats-only tally; a lost increment skews a debug counter, never a decision
            stem = build_stem(self.prefix, domain, descriptor.entries)
            # [stem, (last_window, last_CacheKey), stem_byte_len] —
            # the finished CacheKey is cached per window, so a hot
            # descriptor costs one dict hit + one comparison until its
            # window rolls.
            ce = self._stems[ck] = [stem, None, len(stem.encode("utf-8"))]
        pair = ce[1]  # ONE atomic read: window and key travel together
        if (
            pair is not None
            and pair[0] == window
            and pair[1].per_second == per_second
        ):
            return pair[1]
        out = CacheKey(ce[0] + str(window), per_second, ce[2])
        # Single-slot tuple swap: a concurrent reader sees either the
        # old (window, key) pair or the new one, never a mix — two
        # threads straddling a window rollover each get the key for
        # THEIR window.
        ce[1] = (window, out)
        return out
