"""Limiter-algorithm models.

The registry (``.registry``) is torch-free metadata; the fixed-window
model imports torch, so its names resolve LAZILY here (PEP 562) -- the
config loader validates ``algorithm:`` names through this package
without importing the device stack.
"""

from .registry import (
    ALGO_FIXED_WINDOW,
    ALGO_GCRA,
    ALGO_SLIDING_WINDOW,
    ALGORITHM_NAMES,
    ALGORITHMS,
    DEFAULT_ALGORITHM,
    AlgorithmSpec,
    get_algorithm,
)

_FIXED_WINDOW_NAMES = {
    "DeviceBatch",
    "DeviceDecisions",
    "FixedWindowModel",
    "CODE_OK",
    "CODE_OVER_LIMIT",
    "state_from_numpy",
    "state_to_numpy",
}

__all__ = [
    "ALGO_FIXED_WINDOW",
    "ALGO_GCRA",
    "ALGO_SLIDING_WINDOW",
    "ALGORITHM_NAMES",
    "ALGORITHMS",
    "DEFAULT_ALGORITHM",
    "AlgorithmSpec",
    "get_algorithm",
] + sorted(_FIXED_WINDOW_NAMES)


def __getattr__(name: str):
    if name in _FIXED_WINDOW_NAMES:
        from . import fixed_window

        return getattr(fixed_window, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
