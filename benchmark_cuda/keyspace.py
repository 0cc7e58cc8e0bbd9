"""The one traffic generator: client addresses under a bounded zipfian
distribution, and the rate-limit keys the service builds from them.

Every draw comes from ``--seed``.  A configuration fixes the deployment's
address space (``keys.count``), its skew (``keys.zipf``, YCSB's zipfian
constant) and the deny-listed address of its rules; a traffic mix may
override the count and the skew.  Ranks map onto addresses through a
seeded permutation, as YCSB's scrambled zipfian spreads its hot keys, so
two seeds draw the same sizes and skew over different addresses.  The
deny-listed address takes one fixed rank, so every seed sends it the
same share.

Address ``i`` of the space is ``10.a.b.c`` with ``i = a<<16 | b<<8 | c``;
the id ``count`` is the deny-listed address.  A key is what the service
builds for a ``remote_address`` descriptor (limiter/cache_key.py of the
program, envoyproxy/ratelimit's cache_key.go):
``<domain>_<descriptor key>_<address>_`` and, for a fixed window, the
window's start in unix seconds after it.  A stable-stem algorithm
(GCRA) keys by the stem alone.
"""

from __future__ import annotations

import numpy as np

#: Unix seconds print as 10 digits until the year 2286.
WINDOW_DIGITS = 10


class KeySpace:
    """The addresses of one deployment and the zipfian law over them."""

    def __init__(self, keys: dict, domain: str, descriptor_key: str, seed: int):
        self.count = int(keys["count"])
        self.theta = float(keys["zipf"])
        self.blocked = keys.get("blocked")
        self.blocked_rank = int(keys.get("blocked_rank", 0))
        rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32, 0x6B657973])
        weights = np.arange(1, self.count + 1, dtype=np.float64) ** -self.theta
        self._cdf = np.cumsum(weights)
        self._cdf /= self._cdf[-1]
        # rank (0 = hottest) -> address id; the deny-listed address takes
        # its fixed rank.
        self.rank_to_id = rng.permutation(self.count).astype(np.int64)
        if self.blocked is not None:
            self.rank_to_id[self.blocked_rank] = self.count
        addrs = [f"10.{i >> 16}.{(i >> 8) & 255}.{i & 255}" for i in range(self.count)]
        if self.blocked is not None:
            addrs.append(self.blocked)
        self.addresses = addrs
        self.stems = [f"{domain}_{descriptor_key}_{a}_".encode("utf-8") for a in addrs]
        self.stem_len = np.array([len(s) for s in self.stems], dtype=np.int64)
        self._keys = {}

    @property
    def ids(self) -> int:
        """Number of address ids (the deny-listed one included)."""
        return len(self.addresses)

    def draw(self, rng: np.random.Generator, n: int) -> np.ndarray:
        """`n` address ids under the zipfian law."""
        ranks = np.searchsorted(self._cdf, rng.random(n), side="left")
        return self.rank_to_id[np.minimum(ranks, self.count - 1)]

    def hottest(self, k: int) -> np.ndarray:
        """The ids of the `k` most frequent addresses."""
        return self.rank_to_id[:k].copy()

    def pack(self, ids: np.ndarray, suffix: int = 0):
        """The key blob of `ids` in order, each key its stem and `suffix`
        placeholder bytes: (blob uint8, per-key byte length int64, each
        key's suffix offset in the blob int64)."""
        keys = self._keys.get(suffix)
        if keys is None:
            keys = self._keys[suffix] = [s + b"0" * suffix for s in self.stems]
        ids = np.asarray(ids, dtype=np.int64)
        blob = np.frombuffer(b"".join([keys[i] for i in ids.tolist()]), dtype=np.uint8).copy()
        lens = self.stem_len[ids] + suffix
        return blob, lens, np.cumsum(lens) - suffix


def stamp_window(blob: np.ndarray, suffix_at: np.ndarray, window: int, old: int = None) -> None:
    """Write the window's start (unix seconds) into every key's suffix;
    where the suffixes already hold window `old`, only the digits that
    differ."""
    digits = str(int(window)).encode("ascii")
    if len(digits) != WINDOW_DIGITS:
        raise ValueError(f"window {window} is not {WINDOW_DIGITS} digits")
    before = str(int(old)).encode("ascii") if old is not None else bytes(WINDOW_DIGITS)
    for k in range(WINDOW_DIGITS):
        if digits[k] != before[k]:
            blob[suffix_at + k] = digits[k]
