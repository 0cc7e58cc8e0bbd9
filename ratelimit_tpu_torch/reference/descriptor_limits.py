"""Plain reference of envoyproxy/ratelimit's fixed-window decisions for a
YAML rule set.

Written from the upstream README ("Configuration", "Rate limit
configuration" and its examples) and its src/config/config_impl.go
(GetLimit) and src/limiter/base_limiter.go, with nothing of the port and
nothing of JAX imported:

- a rule set is a domain and a tree of descriptors; a request
  descriptor's entries walk the tree level by level, each entry matching
  the node ``key_value`` first and the wildcard node ``key`` after it;
  the limit is the one on the node its LAST entry reaches (a limit on an
  inner node binds only a descriptor that ends there), and a walk that
  leaves the tree matches no limit;
- every matched descriptor has its own counter per (domain, descriptor
  entries, window): the key ``<domain>_<k1>_<v1>_..._<kn>_<vn>_<window
  start>``, the window start being the unix second less that second
  modulo the unit;
- every matched descriptor is incremented by ``hits_addend`` (0 counts
  as 1), whatever the others answer; the hit that takes a count past
  ``requests_per_unit`` is OVER_LIMIT with 0 remaining, an OK answer
  carries the limit less the count, and both the seconds to the window's
  end;
- the overall code is OVER_LIMIT when any descriptor is, else OK.

Departures, none of which a rule set here uses: no shadow mode, no
``unlimited`` rules, no wildcard values (``value: prefix*``), no
``replaces``, no request-supplied limit override, no local over-limit
cache, no near-limit statistics.

    ref = DescriptorLimits(yaml_text)
    overall, statuses = ref.decide("messaging", [[("to_number", "+1...")]], now=...)
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import yaml

OK = 1
OVER_LIMIT = 2

#: Seconds a unit (rls.proto's RateLimit.Unit names).
UNIT_SECONDS = {"SECOND": 1, "MINUTE": 60, "HOUR": 3600, "DAY": 86400}


class Rule:
    """One node of the descriptor tree."""

    def __init__(self, node: dict):
        limit = node.get("rate_limit")
        self.limit: Optional[Tuple[int, int]] = None  # (requests_per_unit, unit seconds)
        self.unit_name: Optional[str] = None
        if limit is not None:
            self.unit_name = str(limit["unit"]).upper()
            self.limit = (int(limit["requests_per_unit"]), UNIT_SECONDS[self.unit_name])
        self.children = tree(node.get("descriptors") or [])


def tree(nodes: Sequence[dict]) -> Dict[str, Rule]:
    """{``key_value`` or ``key``: Rule} of one level."""
    out = {}
    for node in nodes:
        name = node["key"] if node.get("value") in (None, "") else f"{node['key']}_{node['value']}"
        out[name] = Rule(node)
    return out


class DescriptorLimits:
    """The rules of one YAML file and the counters they keep."""

    def __init__(self, yaml_text: str):
        doc = yaml.safe_load(yaml_text)
        self.domain = doc["domain"]
        self.rules = tree(doc.get("descriptors") or [])
        #: count of every (descriptor, window) key sent so far
        self.counts: Dict[str, int] = {}

    def rule_of(self, entries: Sequence[Tuple[str, str]]) -> Optional[Rule]:
        """The rule whose limit binds `entries`, or None."""
        level, found = self.rules, None
        for i, (key, value) in enumerate(entries):
            node = level.get(f"{key}_{value}") or level.get(key)
            if node is None:
                return None
            if i == len(entries) - 1:
                found = node if node.limit is not None else None
            level = node.children
        return found

    def key_of(self, entries: Sequence[Tuple[str, str]], window: int) -> str:
        stem = "".join(f"{k}_{v}_" for k, v in entries)
        return f"{self.domain}_{stem}{window}"

    def decide(
        self, domain: str, descriptors: Sequence[Sequence[Tuple[str, str]]],
        now: int, hits_addend: int = 0,
    ) -> Tuple[int, List[tuple]]:
        """(overall code, statuses) of one request; a status is (code,
        requests_per_unit or None, unit name or None, remaining, seconds
        to the window's end or None)."""
        hits = max(int(hits_addend), 1)
        statuses, overall = [], OK
        for entries in descriptors:
            rule = self.rule_of(entries) if domain == self.domain else None
            if rule is None:
                statuses.append((OK, None, None, 0, None))
                continue
            limit, unit = rule.limit
            window = now - now % unit
            key = self.key_of(entries, window)
            after = self.counts.get(key, 0) + hits
            self.counts[key] = after
            reset = unit - now % unit
            if after > limit:
                statuses.append((OVER_LIMIT, limit, rule.unit_name, 0, reset))
                overall = OVER_LIMIT
            else:
                statuses.append((OK, limit, rule.unit_name, limit - after, reset))
        return overall, statuses
