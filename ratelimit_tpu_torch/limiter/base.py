"""The fixed-window threshold state machine.

A pure-function restatement of reference
src/limiter/base_limiter.go:76-197 (``GetResponseDescriptorStatus`` +
``checkOverLimitThreshold`` + ``checkNearLimitThreshold``), factored so
the same arithmetic runs three ways:

- ``decide``        -- scalar, one descriptor (unit tests, slow path);
- ``decide_batch``  -- vectorized over numpy arrays (host batch path);
- ``ops.counter_kernel`` -- the same formulas inside the jitted device
  kernel (kept in sync by tests that compare all three).

Semantics (using the reference's names):

- ``before``/``after`` are the counter value before/after this
  descriptor's own increment, in pipeline order;
- over-limit when ``after > limit``;
- near-limit threshold is ``floor(float32(limit) * near_ratio)``
  (base_limiter.go:94 computes in float32);
- partial-hit attribution for ``hits > 1``: when a batch of hits
  straddles a threshold, only the portion past the threshold counts
  toward the more severe stat (base_limiter.go:150-179).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ..api import Code


def near_limit_threshold(limit: int, near_ratio: float) -> int:
    """floor(float32(limit) * float32(near_ratio)), matching the Go
    float32 arithmetic at base_limiter.go:94."""
    return int(math.floor(float(np.float32(limit) * np.float32(near_ratio))))


@dataclass
class LimitDecision:
    """Outcome for one descriptor: response fields + stat deltas."""

    code: Code
    limit_remaining: int
    # Stat deltas, to be added to the rule's counters.
    over_limit: int = 0
    near_limit: int = 0
    within_limit: int = 0
    over_limit_with_local_cache: int = 0
    shadow_mode: int = 0
    # True when the backend should insert the key into the host
    # over-limit cache (first transition past the limit;
    # base_limiter.go:103-115).
    set_local_cache: bool = False


def decide(
    limit: int,
    before: int,
    after: int,
    hits: int,
    near_ratio: float,
    shadow_mode: bool = False,
    over_limit_with_local_cache: bool = False,
) -> LimitDecision:
    """Scalar decision for one descriptor (base_limiter.go:76-135)."""
    if over_limit_with_local_cache:
        d = LimitDecision(
            code=Code.OVER_LIMIT,
            limit_remaining=0,
            over_limit=hits,
            over_limit_with_local_cache=hits,
        )
    else:
        near = near_limit_threshold(limit, near_ratio)
        if after > limit:
            d = LimitDecision(code=Code.OVER_LIMIT, limit_remaining=0)
            if before >= limit:
                d.over_limit = hits
            else:
                d.over_limit = after - limit
                d.near_limit = limit - max(near, before)
            d.set_local_cache = True
        else:
            d = LimitDecision(code=Code.OK, limit_remaining=limit - after)
            if after > near:
                d.near_limit = hits if before >= near else after - near
            d.within_limit = hits

    if d.code == Code.OVER_LIMIT and shadow_mode:
        d.code = Code.OK
        d.shadow_mode = hits
    return d


@dataclass
class BatchDecisions:
    """Vectorized decisions: arrays indexed like the input batch."""

    codes: np.ndarray  # int32, values from api.Code
    limit_remaining: np.ndarray  # uint32
    over_limit: np.ndarray  # uint32 stat deltas
    near_limit: np.ndarray
    within_limit: np.ndarray
    over_limit_with_local_cache: np.ndarray
    shadow_mode: np.ndarray
    set_local_cache: np.ndarray  # bool


def decide_batch(
    limits: np.ndarray,
    befores: np.ndarray,
    afters: np.ndarray,
    hits: np.ndarray,
    near_ratio: float,
    shadow_mask: np.ndarray,
    local_cache_mask: np.ndarray,
) -> BatchDecisions:
    """Vectorized equivalent of ``decide`` over int64 numpy arrays.

    All inputs are 1-D and index-aligned.  ``local_cache_mask`` marks
    descriptors short-circuited by the host over-limit cache (those
    never reached the counter engine; befores/afters are ignored).
    """
    limits = np.asarray(limits, dtype=np.int64)
    befores = np.asarray(befores, dtype=np.int64)
    afters = np.asarray(afters, dtype=np.int64)
    hits = np.asarray(hits, dtype=np.int64)
    shadow_mask = np.asarray(shadow_mask, dtype=bool)
    lc = np.asarray(local_cache_mask, dtype=bool)

    near = np.floor(
        limits.astype(np.float32) * np.float32(near_ratio)
    ).astype(np.int64)

    engine_over = ~lc & (afters > limits)
    ok = ~lc & ~engine_over
    over = lc | engine_over

    n = limits.shape[0]
    d = BatchDecisions(
        codes=np.full(n, int(Code.OK), dtype=np.int32),
        limit_remaining=np.zeros(n, dtype=np.int64),
        over_limit=np.zeros(n, dtype=np.int64),
        near_limit=np.zeros(n, dtype=np.int64),
        within_limit=np.zeros(n, dtype=np.int64),
        over_limit_with_local_cache=np.zeros(n, dtype=np.int64),
        shadow_mode=np.zeros(n, dtype=np.int64),
        set_local_cache=engine_over.copy(),
    )

    # Local-cache short-circuit (base_limiter.go:84-89).
    d.over_limit[lc] = hits[lc]
    d.over_limit_with_local_cache[lc] = hits[lc]

    # Engine over-limit with partial-hit attribution
    # (base_limiter.go:150-165).
    fully_over = engine_over & (befores >= limits)
    partly_over = engine_over & ~fully_over
    d.over_limit[fully_over] = hits[fully_over]
    d.over_limit[partly_over] = (afters - limits)[partly_over]
    d.near_limit[partly_over] = (limits - np.maximum(near, befores))[partly_over]

    # OK path with near-limit attribution (base_limiter.go:116-123,
    # 167-179).
    d.limit_remaining[ok] = (limits - afters)[ok]
    d.within_limit[ok] = hits[ok]
    near_ok = ok & (afters > near)
    fully_near = near_ok & (befores >= near)
    partly_near = near_ok & ~fully_near
    d.near_limit[fully_near] = hits[fully_near]
    d.near_limit[partly_near] = (afters - near)[partly_near]

    d.codes[over] = int(Code.OVER_LIMIT)

    # Per-rule shadow mode flips the code but keeps stats
    # (base_limiter.go:126-132).
    shadowed = over & shadow_mask
    d.codes[shadowed] = int(Code.OK)
    d.shadow_mode[shadowed] = hits[shadowed]
    return d
