"""The backend seam: RateLimitCache.

Equivalent of reference src/limiter/cache.go:11-29 -- the single
interface a counter backend must implement.  Implementations live in
``ratelimit_tpu.backends`` (tpu engine, in-memory exact) and the
dispatcher wraps one to add micro-batching.
"""

from __future__ import annotations

from typing import List, Optional, Protocol, Sequence

from ..api import DescriptorStatus, RateLimitRequest
from ..config import RateLimitRule


class RateLimitCache(Protocol):
    def do_limit(
        self,
        request: RateLimitRequest,
        limits: Sequence[Optional[RateLimitRule]],
    ) -> List[DescriptorStatus]:
        """Decide every descriptor in `request`.

        `limits[i]` is the rule for descriptor i, or None when no rule
        matched (those come back OK with no current_limit).  Must return
        one status per descriptor, index-aligned.
        """
        ...

    def flush(self) -> None:
        """Block until all asynchronously queued work is applied.

        A no-op for synchronous backends; the micro-batching dispatcher
        uses it to make tests deterministic (the reference's
        memcached Flush()/AutoFlushForIntegrationTests lesson,
        src/memcached/cache_impl.go:54,176-178).
        """
        ...
