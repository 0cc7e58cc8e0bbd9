"""The limiter-algorithm table: name -> model factory + metadata.

Port of ratelimit_tpu/models/registry.py.  The table keeps every
algorithm's name, id and key/state layout, so configs that name an
algorithm load and resolve exactly as in the reference, and builds
each model on the device it is given (the GPU unless the caller asks
for the CPU).  Rules carrying ``algorithm: <name>`` route to a
dedicated engine bank whose model this table builds -- as the
enforcing bank, or with ``shadow: true`` as a candidate evaluated
beside fixed-window enforcement (``ratelimit.tpu.shadow.<algo>
.{agree,diverge}``).

This module stays importable without torch: the config loader
validates algorithm names through it.  Model classes are imported
lazily inside the factory functions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Tuple

ALGO_FIXED_WINDOW = "fixed_window"
ALGO_SLIDING_WINDOW = "sliding_window"
ALGO_GCRA = "gcra"

DEFAULT_ALGORITHM = ALGO_FIXED_WINDOW


@dataclass(frozen=True)
class AlgorithmSpec:
    """One pluggable limiter algorithm.

    ``algo_id`` is the small stable integer stamped into flight-
    recorder records (observability/flight.py) — append-only, never
    renumber.  ``windowed_keys`` says whether the cache key embeds the
    window start (fixed windows expire by re-keying every window) or
    is the stable stem (stateful kernels carry their own window/TAT
    per slot and need the slot to SURVIVE rollovers — their engine
    banks run the Python slot table with refresh-on-touch expiry).
    ``state_rows`` documents the per-slot device state layout (the
    checkpoint payload shape).
    """

    name: str
    algo_id: int
    windowed_keys: bool
    state_rows: Tuple[str, ...]
    make_model: Callable  # (num_slots, near_ratio, device) -> model


def _make_fixed_window(num_slots: int, near_ratio: float, device="cuda"):
    from .fixed_window import FixedWindowModel

    return FixedWindowModel(num_slots, near_ratio, device=device)


def _make_sliding_window(num_slots: int, near_ratio: float, device="cuda"):
    from .sliding_window import SlidingWindowModel

    return SlidingWindowModel(num_slots, near_ratio, device=device)


def _make_gcra(num_slots: int, near_ratio: float, device="cuda"):
    from .gcra import GcraModel

    return GcraModel(num_slots, near_ratio, device=device)


ALGORITHMS = {
    ALGO_FIXED_WINDOW: AlgorithmSpec(
        name=ALGO_FIXED_WINDOW,
        algo_id=0,
        windowed_keys=True,
        state_rows=("counts",),
        make_model=_make_fixed_window,
    ),
    ALGO_SLIDING_WINDOW: AlgorithmSpec(
        name=ALGO_SLIDING_WINDOW,
        algo_id=1,
        windowed_keys=False,
        state_rows=("window_start", "curr", "prev"),
        make_model=_make_sliding_window,
    ),
    ALGO_GCRA: AlgorithmSpec(
        name=ALGO_GCRA,
        algo_id=2,
        windowed_keys=False,
        state_rows=("tat_sec", "tat_frac"),
        make_model=_make_gcra,
    ),
}

#: Loader-facing view: the set of valid ``algorithm:`` values.
ALGORITHM_NAMES = frozenset(ALGORITHMS)

#: flight-recorder id -> name (records carry the id; /debug surfaces
#: resolve it back).
ALGO_ID_TO_NAME = {spec.algo_id: spec.name for spec in ALGORITHMS.values()}


def get_algorithm(name: str) -> AlgorithmSpec:
    spec = ALGORITHMS.get(name)
    if spec is None:
        raise KeyError(
            f"unknown limiter algorithm {name!r} "
            f"(known: {', '.join(sorted(ALGORITHMS))})"
        )
    return spec
