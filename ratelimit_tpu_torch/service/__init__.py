from .ratelimit import CacheError, RateLimitService, ServiceError

__all__ = ["CacheError", "RateLimitService", "ServiceError"]
