"""``GET /debug/tracez``: human-readable dump of the trace ring.

A copy of ratelimit_tpu/observability/tracez.py (standard library only).

Modeled on the OpenCensus/zPages tracez surface the Go ecosystem ships
next to pprof: two sections — the SLOWEST committed traces and the
MOST RECENT ones — each rendered as an indented span tree with
per-span offset/duration, so tail-latency attribution ("which phase
ate the p99") is one curl away from the live process.
"""

from __future__ import annotations

import time
from typing import List

from .trace import FinishedTrace, Tracer


def _span_tree(trace: FinishedTrace) -> List[str]:
    """Indented span lines, children under parents (insertion order
    preserved within a level; orphans — e.g. spans whose parent is the
    upstream caller — render at the top level)."""
    by_parent: dict = {}
    ids = {s["span_id"] for s in trace.spans}
    for s in trace.spans:
        parent = s["parent_id"] if s["parent_id"] in ids else ""
        by_parent.setdefault(parent, []).append(s)

    lines: List[str] = []

    def walk(parent_id: str, depth: int) -> None:
        for s in by_parent.get(parent_id, ()):
            attrs = "".join(
                f" {k}={v}" for k, v in sorted(s["attrs"].items())
            )
            status = "" if s["status"] == "ok" else f" [{s['status']}]"
            lines.append(
                f"{'  ' * depth}{s['name']:<24} "
                f"+{s['start_ms']:8.3f}ms {s['duration_ms']:9.3f}ms"
                f"{status}{attrs}"
            )
            walk(s["span_id"], depth + 1)

    walk("", 1)
    return lines


def _render_trace(trace: FinishedTrace) -> List[str]:
    when = time.strftime(
        "%Y-%m-%dT%H:%M:%SZ", time.gmtime(trace.start_unix)
    )
    head = (
        f"trace={trace.trace_id} root={trace.root_name} "
        f"duration={trace.duration_ms:.3f}ms status={trace.status} "
        f"start={when}"
    )
    if trace.parent_id:
        head += f" parent={trace.parent_id}"
    if trace.detail:
        head += f" detail={trace.detail!r}"
    return [head] + _span_tree(trace)


def render(tracer: Tracer, max_each: int = 10) -> str:
    slow = tracer.slowest()[:max_each]
    recent = tracer.recent()[-max_each:]
    lines: List[str] = [
        "tracez: committed traces "
        f"(sample_rate={tracer.sample_rate}, "
        f"sample_errors={tracer.sample_errors})",
        "",
        f"--- slowest ({len(slow)}) ---",
    ]
    for t in slow:
        lines.extend(_render_trace(t))
        lines.append("")
    lines.append(f"--- most recent ({len(recent)}) ---")
    for t in reversed(recent):
        lines.extend(_render_trace(t))
        lines.append("")
    return "\n".join(lines) + "\n"
