from .threads import ThreadExceptionRecorder, install_thread_excepthook
from .time import (
    MonotonicBatchClock,
    PinnedTimeSource,
    RealTimeSource,
    TimeSource,
    calculate_reset,
    reset_seconds,
    unit_to_divider,
    window_start,
)

__all__ = [
    "TimeSource",
    "RealTimeSource",
    "PinnedTimeSource",
    "MonotonicBatchClock",
    "unit_to_divider",
    "calculate_reset",
    "reset_seconds",
    "window_start",
    "ThreadExceptionRecorder",
    "install_thread_excepthook",
]
