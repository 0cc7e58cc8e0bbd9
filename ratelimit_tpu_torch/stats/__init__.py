from .manager import (
    Counter,
    Manager,
    RateLimitStats,
    ServiceStats,
    ShouldRateLimitStats,
    StatsStore,
)

__all__ = [
    "Counter",
    "Manager",
    "RateLimitStats",
    "ServiceStats",
    "ShouldRateLimitStats",
    "StatsStore",
]
