from .loader import (
    ConfigError,
    ConfigFile,
    RateLimitConfig,
    RateLimitRule,
    load_config,
)

__all__ = [
    "ConfigError",
    "ConfigFile",
    "RateLimitConfig",
    "RateLimitRule",
    "load_config",
]
