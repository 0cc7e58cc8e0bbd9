"""Fleet aggregation: the proxy's one-stop view over every replica.

Port of ratelimit_tpu/cluster/fleet.py, unchanged: the same scraped
endpoints and merges, over the debug listener that a replica of either
package serves.  Standard library only.

An incident in a multi-replica deployment starts with N browser tabs —
one per replica debug port — and a human doing the merge by eye.
``GET /fleet.json`` on the proxy's debug listener does that merge
server-side: it scrapes each replica's debug surfaces over the SAME
admin URL map the counter handoff uses (--replica-admin), with bounded
deadlines and circuit awareness (a replica whose routing circuit is
open is skipped, not waited on — the fleet view must never hang on the
exact replica that is down), and returns:

- ``slo``: per-domain fleet SLIs — summed window counts and a
  requests-weighted availability/burn aggregate, plus the max burn and
  which replica reported it (the page a burn alert should open);
- ``hotkeys``: the union top-K of every replica's Space-Saving sketch,
  summed by key — a key hot on two replicas ranks above a key hot on
  one;
- ``faults``: every non-closed bank across the fleet, tagged with its
  replica (the "is ANY device degraded" answer);
- ``cluster``: per-replica handoff bookkeeping (/debug/cluster) next
  to the proxy's own routing stats;
- ``events``: the merged lifecycle timeline — each replica's journal
  window tagged with its replica id, ordered by wall clock (monotonic
  stamps do not compare across processes), interleaved with the
  proxy's own journal under the id ``_proxy``;
- ``timeseries``: per-replica sparkline digests (last/avg/max per
  series) from each replica's in-process time-series store — the
  "is RSS climbing anywhere" answer without shipping ring history.

Scrapes are best-effort per endpoint: one replica's 404 (feature off)
or timeout degrades THAT section for THAT replica and the rest of the
view still renders — the fleet page exists for exactly the moments
when some replica is unwell.
"""

from __future__ import annotations

import json
import logging
import urllib.request
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger("ratelimit.cluster.fleet")

__all__ = ["FleetAggregator"]

#: (section, path) pairs scraped from each replica's debug listener.
#: /metrics is probed for liveness+size only (Prometheus text belongs
#: to Prometheus); the JSON surfaces feed the merges.
REPLICA_ENDPOINTS: Tuple[Tuple[str, str], ...] = (
    ("metrics", "/metrics"),
    ("slo", "/debug/slo"),
    ("hotkeys", "/debug/hotkeys"),
    ("faults", "/debug/faults"),
    ("cluster", "/debug/cluster"),
    ("events", "/debug/events"),
    # The bounded per-series {last,avg,max} digest, NOT the full ring:
    # the fleet page shows sparkline summaries (is RSS climbing on
    # replica B), the history itself stays on the replica.
    ("timeseries", "/debug/timeseries?summary=1"),
)

#: Union-top-K width of the merged hotkeys table.
FLEET_TOP_K = 20


class FleetAggregator:
    """Scrape + merge.  Construct once on the proxy debug listener;
    ``fleet(holder)`` renders one /fleet.json body.

    ``admin_urls`` maps replica gRPC identity -> debug base URL (the
    --replica-admin map).  ``timeout_s`` bounds EVERY endpoint fetch
    individually, so one blackholed replica costs at most
    len(REPLICA_ENDPOINTS) * timeout_s, not a hang.  ``fetch`` is the
    test seam (url -> bytes, raising on failure).
    """

    def __init__(
        self,
        admin_urls: Dict[str, str],
        timeout_s: float = 2.0,
        events=None,
        fetch=None,
    ):
        self.admin_urls = dict(admin_urls)
        self.timeout_s = float(timeout_s)
        self.events = events
        self._fetch = fetch or self._http_fetch

    def _http_fetch(self, url: str) -> bytes:
        with urllib.request.urlopen(url, timeout=self.timeout_s) as r:
            return r.read()

    # -- per-replica scrape ----------------------------------------------

    def scrape_replica(self, base_url: str) -> dict:
        """Best-effort fetch of every endpoint; per-endpoint errors
        degrade that section to an ``{"error": ...}`` marker."""
        out: dict = {}
        for section, path in REPLICA_ENDPOINTS:
            try:
                body = self._fetch(base_url.rstrip("/") + path)
            except Exception as e:
                out[section] = {"error": repr(e)}
                continue
            if section == "metrics":
                # Liveness + scrape size only; the text payload is for
                # a Prometheus server, not a JSON merge.
                out[section] = {"up": True, "bytes": len(body)}
                continue
            try:
                out[section] = json.loads(body)
            except ValueError as e:
                out[section] = {"error": f"bad json: {e}"}
        return out

    # -- merges ------------------------------------------------------------

    @staticmethod
    def _merge_slo(per_replica: Dict[str, dict]) -> dict:
        domains: Dict[str, dict] = {}
        max_burn = 0.0
        max_burn_at: Optional[Tuple[str, str]] = None  # (replica, domain)
        for rid, body in per_replica.items():
            if not isinstance(body, dict) or "domains" not in body:
                continue
            for name, d in body["domains"].items():
                w = d.get("window", {})
                agg = domains.setdefault(
                    name,
                    {
                        "requests": 0,
                        "over_limit": 0,
                        "errors": 0,
                        "slow": 0,
                        "_burn_weighted": 0.0,
                        "max_burn_rate": 0.0,
                        "replicas": 0,
                    },
                )
                reqs = int(w.get("requests", 0))
                agg["requests"] += reqs
                agg["over_limit"] += int(w.get("over_limit", 0))
                agg["errors"] += int(w.get("errors", 0))
                agg["slow"] += int(w.get("slow", 0))
                agg["replicas"] += 1
                burn = float(w.get("burn_rate", 0.0))
                agg["_burn_weighted"] += burn * reqs
                if burn > agg["max_burn_rate"]:
                    agg["max_burn_rate"] = burn
                if burn > max_burn:
                    max_burn = burn
                    max_burn_at = (rid, name)
        for agg in domains.values():
            reqs = agg["requests"]
            agg["burn_rate"] = (
                round(agg.pop("_burn_weighted") / reqs, 6) if reqs else 0.0
            )
        out: dict = {"domains": domains}
        if max_burn_at is not None:
            out["max_burn"] = {
                "replica": max_burn_at[0],
                "domain": max_burn_at[1],
                "burn_rate": max_burn,
            }
        return out

    @staticmethod
    def _merge_hotkeys(per_replica: Dict[str, dict]) -> dict:
        union: Dict[str, dict] = {}
        for rid, body in per_replica.items():
            if not isinstance(body, dict) or "keys" not in body:
                continue
            for e in body["keys"]:
                key = e.get("key")
                if key is None:
                    continue
                agg = union.setdefault(
                    key,
                    {
                        "key": key,
                        "hits": 0,
                        "over_limit": 0,
                        "near_limit": 0,
                        "replicas": [],
                    },
                )
                agg["hits"] += int(e.get("hits", 0))
                agg["over_limit"] += int(e.get("over_limit", 0))
                agg["near_limit"] += int(e.get("near_limit", 0))
                agg["replicas"].append(rid)
        top = sorted(union.values(), key=lambda e: e["hits"], reverse=True)
        return {"tracked": len(union), "keys": top[:FLEET_TOP_K]}

    @staticmethod
    def _merge_faults(per_replica: Dict[str, dict]) -> dict:
        quarantined: List[dict] = []
        totals = {"restarts": 0, "fallback_decisions": 0}
        for rid, body in per_replica.items():
            if not isinstance(body, dict) or "banks" not in body:
                continue
            totals["restarts"] += int(body.get("restarts", 0))
            totals["fallback_decisions"] += int(
                body.get("fallback_decisions", 0)
            )
            for b in body["banks"]:
                if b.get("state") != "closed":
                    quarantined.append({"replica": rid, **b})
        return {"quarantined_banks": quarantined, **totals}

    @staticmethod
    def _merge_events(
        per_replica: Dict[str, dict], proxy_events: List[dict]
    ) -> List[dict]:
        merged: List[dict] = [
            {"replica": "_proxy", **e} for e in proxy_events
        ]
        for rid, body in per_replica.items():
            if not isinstance(body, dict):
                continue
            for e in body.get("events", []):
                merged.append({"replica": rid, **e})
        # Wall clock is the only stamp that compares across processes;
        # seq breaks ties within one source.
        merged.sort(key=lambda e: (e.get("ts_unix", 0.0), e.get("seq", 0)))
        return merged

    # -- entry point -------------------------------------------------------

    def fleet(self, holder) -> dict:
        """One /fleet.json body: scrape every configured replica
        (skipping open circuits), merge, and attach the proxy's own
        routing stats + journal window."""
        stats = holder.stats()
        circuit_open = {
            s["id"]
            for s in stats.get("replica_states", ())
            if s.get("state") == "open"
        }
        replicas: Dict[str, dict] = {}
        sections: Dict[str, Dict[str, dict]] = {
            s: {} for s, _ in REPLICA_ENDPOINTS
        }
        for rid, base_url in sorted(self.admin_urls.items()):
            if rid in circuit_open:
                # The routing tier already knows this replica is not
                # answering; don't spend the fleet deadline re-learning
                # it endpoint by endpoint.
                replicas[rid] = {"skipped": "circuit open"}
                continue
            scraped = self.scrape_replica(base_url)
            replicas[rid] = scraped
            for section in sections:
                if section in scraped:
                    sections[section][rid] = scraped[section]
        proxy_events = (
            self.events.snapshot() if self.events is not None else []
        )
        return {
            "replicas": replicas,
            "proxy": stats,
            "slo": self._merge_slo(sections["slo"]),
            "hotkeys": self._merge_hotkeys(sections["hotkeys"]),
            "faults": self._merge_faults(sections["faults"]),
            "cluster": {
                rid: body for rid, body in sections["cluster"].items()
            },
            "events": self._merge_events(sections["events"], proxy_events),
            "timeseries": {
                rid: body for rid, body in sections["timeseries"].items()
            },
        }
