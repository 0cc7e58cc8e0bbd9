"""Prometheus text exposition (format 0.0.4) from a StatsStore.

A copy of ratelimit_tpu/observability/prometheus.py (standard library only).

The reference exports via statsd + the prom-statsd-exporter sidecar
mapping (examples/prom-statsd-exporter/conf.yaml); this serves the
same data first-party on ``GET /metrics`` so a scrape needs no
sidecar.  Output is deterministic: families sorted by name, histogram
buckets in ascending ``le`` order with CUMULATIVE counts, ``_sum`` and
``_count`` closing each histogram — golden-tested in
tests/test_torch_observability.py.
"""

from __future__ import annotations

import re
from typing import List

_NAME_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def metric_name(name: str) -> str:
    """Stat-tree name -> Prometheus metric name: dots (and anything
    else illegal) become underscores; a leading digit gets a prefix."""
    out = _NAME_BAD.sub("_", name)
    if out and out[0].isdigit():
        out = "_" + out
    return out


def _fmt(value: float) -> str:
    """Float formatting with no trailing noise: 1.0 -> "1",
    0.25 -> "0.25" (le labels and sums must be stable text)."""
    if value == int(value):
        return str(int(value))
    return repr(value)


def render(store) -> str:
    """The full exposition: counters, gauges (registered + gauge_fns),
    histograms.  Timers are deliberately absent — their histogram
    successors carry the same data with quantiles (stats/manager.py)."""
    lines: List[str] = []

    for name, value in sorted(store.counters().items()):
        n = metric_name(name)
        lines.append(f"# TYPE {n} counter")
        lines.append(f"{n} {value}")

    for name, value in sorted(store.gauges().items()):
        n = metric_name(name)
        lines.append(f"# TYPE {n} gauge")
        lines.append(f"{n} {value}")

    # Float gauges (SLO burn rates / SLI ratios): fractional values the
    # integer gauge registry would truncate (stats/manager.py).
    for name, value in sorted(store.float_gauges().items()):
        n = metric_name(name)
        lines.append(f"# TYPE {n} gauge")
        lines.append(f"{n} {_fmt(round(value, 6))}")

    for name in sorted(store.histogram_names()):
        h = store.histogram(name)
        bounds, counts, total_sum, total_count = h.snapshot()
        n = metric_name(name)
        lines.append(f"# TYPE {n} histogram")
        cumulative = 0
        for bound, c in zip(bounds, counts):
            cumulative += c
            lines.append(f'{n}_bucket{{le="{_fmt(bound)}"}} {cumulative}')
        # counts has one overflow cell past the last bound; +Inf is by
        # definition the total observation count.
        lines.append(f'{n}_bucket{{le="+Inf"}} {total_count}')
        lines.append(f"{n}_sum {_fmt(round(total_sum, 6))}")
        lines.append(f"{n}_count {total_count}")

    return "\n".join(lines) + "\n"


CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
