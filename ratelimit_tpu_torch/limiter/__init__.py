from .cache import RateLimitCache
from .cache_key import CacheKey, CacheKeyGenerator, build_stem
from .base import LimitDecision, decide, decide_batch
from .local_cache import LocalCache
from .resolution import ResolutionCache, ResolvedDescriptor

__all__ = [
    "RateLimitCache",
    "CacheKey",
    "CacheKeyGenerator",
    "build_stem",
    "LimitDecision",
    "decide",
    "decide_batch",
    "LocalCache",
    "ResolutionCache",
    "ResolvedDescriptor",
]
