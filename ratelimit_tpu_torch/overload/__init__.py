"""Adaptive overload control: SLO-burn load shedding, hot-key
promotion, detector-triggered backpressure (controller.py, the port of
ratelimit_tpu/overload/)."""

from .controller import (
    BACKPRESSURE_TRIGGERS,
    DEFAULT_DOMAIN_PRIORITY,
    FLIGHT_CODE_SHED,
    OTHER_PRIORITY,
    OverloadController,
    PromotionCache,
    REASON_BACKPRESSURE,
    REASON_SLO_BURN,
)

__all__ = [
    "BACKPRESSURE_TRIGGERS",
    "DEFAULT_DOMAIN_PRIORITY",
    "FLIGHT_CODE_SHED",
    "OTHER_PRIORITY",
    "OverloadController",
    "PromotionCache",
    "REASON_BACKPRESSURE",
    "REASON_SLO_BURN",
]
