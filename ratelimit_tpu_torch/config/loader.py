"""YAML limit-config loader: files -> per-domain descriptor tries.

Behavioral contract from reference src/config/config_impl.go:

- strict key whitelist with typo detection at every nesting level
  (config_impl.go:49-59, 156-196);
- duplicate domain / duplicate composite-key detection
  (config_impl.go:112-115, 223-226);
- ``unlimited`` is mutually exclusive with a (valid) unit
  (config_impl.go:119-136);
- ``GetLimit`` walks one trie level per descriptor entry, preferring the
  exact ``key_value`` child and falling back to the wildcard ``key``
  child; a rule only applies when found at the *last* entry
  (depth-must-match); request-supplied overrides bypass the trie
  (config_impl.go:243-298);
- rule stat names: ``domain.key_value.subkey_subvalue...``
  (loadDescriptors' ``newParentKey``), override stat names use dotted
  ``descriptorKey`` form (config_impl.go:300-312).

Error strings keep the reference's ``<file name>: <message>`` shape so
operators migrating from the reference see familiar diagnostics.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import yaml

from ..api import Descriptor, RateLimit, Unit, UNIT_VALUES
from ..models.registry import ALGORITHM_NAMES, DEFAULT_ALGORITHM
from ..stats.manager import Manager, RateLimitStats

# Whitelisted YAML keys (reference config_impl.go:49-59; `algorithm`
# and `shadow` are the pluggable-limiter extension — see
# docs/ALGORITHMS.md; `priority` is the domain-level shed-ordering
# key the overload controller consumes — see docs/OBSERVABILITY.md
# "Overload control").
VALID_KEYS = frozenset(
    {
        "domain",
        "key",
        "value",
        "descriptors",
        "rate_limit",
        "unit",
        "requests_per_unit",
        "unlimited",
        "shadow_mode",
        "algorithm",
        "shadow",
        "priority",
    }
)

#: Priority assumed for configured domains that carry no ``priority:``
#: key — above the ``_other`` class (0 — unconfigured traffic and
#: explicit ``priority: 0`` domains), so plain configs shed stranger
#: traffic before their own (overload/controller.py).
DEFAULT_DOMAIN_PRIORITY = 1


class ConfigError(Exception):
    """Raised on any malformed limit config (reference RateLimitConfigError).

    The service-layer reload path catches exactly this type and keeps
    the previous config (reference service/ratelimit.go:50-60)."""


@dataclass
class ConfigFile:
    """One YAML file to load (reference RateLimitConfigToLoad)."""

    name: str
    content: str


@dataclass
class RateLimitRule:
    """A configured (or request-supplied) rate limit.

    Equivalent of reference config.RateLimit (config.go:19-25): the
    applied limit plus per-rule stats and unlimited/shadow flags.

    ``algorithm`` selects the limiter kernel from the algorithm table
    (models/registry.py); ``algo_shadow`` (YAML ``shadow: true``) runs
    that kernel as a non-enforcing CANDIDATE — the rule keeps
    enforcing fixed-window while decision divergence is counted on
    /metrics and stamped into flight records (docs/ALGORITHMS.md).
    Distinct from ``shadow_mode``, which suppresses OVER_LIMIT
    responses of whatever algorithm enforces.
    """

    full_key: str
    limit: RateLimit
    stats: RateLimitStats
    unlimited: bool = False
    shadow_mode: bool = False
    algorithm: str = DEFAULT_ALGORITHM
    algo_shadow: bool = False


class _Node:
    """One trie level: children keyed by ``key`` or ``key_value``."""

    __slots__ = ("children", "rule")

    def __init__(self):
        self.children: Dict[str, _Node] = {}
        self.rule: Optional[RateLimitRule] = None


def _error(file: ConfigFile, message: str) -> ConfigError:
    return ConfigError(f"{file.name}: {message}")


def _validate_keys(file: ConfigFile, mapping: dict) -> None:
    """Strict whitelist walk (reference validateYamlKeys,
    config_impl.go:156-196)."""
    for k, v in mapping.items():
        if not isinstance(k, str):
            raise _error(file, f"config error, key is not of type string: {k}")
        if k not in VALID_KEYS:
            raise _error(file, f"config error, unknown key '{k}'")
        if isinstance(v, list):
            for element in v:
                if not isinstance(element, dict):
                    raise _error(
                        file,
                        f"config error, yaml file contains list of type other than map: {element}",
                    )
                _validate_keys(file, element)
        elif isinstance(v, dict):
            _validate_keys(file, v)
        elif isinstance(v, (str, bool, int)) or v is None:
            # Leaf scalars; bool must precede int checks elsewhere since
            # bool is an int subclass in Python.
            continue
        else:
            raise _error(file, "error checking config")


def _as_str(file: ConfigFile, value, what: str) -> str:
    if value is None:
        return ""
    if not isinstance(value, str):
        # The reference's typed unmarshal into a Go string field rejects
        # non-string scalars (e.g. `value: 404`); match that strictness.
        raise _error(file, f"error loading config file: {what} must be a string")
    return value


def _as_bool(file: ConfigFile, value, what: str) -> bool:
    if value is None:
        return False
    if not isinstance(value, bool):
        raise _error(file, f"error loading config file: {what} must be a boolean")
    return value


def _as_uint32(file: ConfigFile, value, what: str) -> int:
    if value is None:
        return 0
    if isinstance(value, bool) or not isinstance(value, int) or value < 0 or value > 0xFFFFFFFF:
        raise _error(file, f"error loading config file: {what} must be a uint32")
    return value


# Monotonically increasing config generation (process-wide).  Every
# RateLimitConfig instance gets a unique generation at construction, so
# load_config stamps each successfully loaded config with a fresh one.
# The descriptor-resolution cache (limiter/resolution.py) keys its
# validity on this: entries resolved under an older generation miss and
# re-resolve.  A FAILED reload never replaces the service's config
# object, so the old generation — and the warm cache — survive it.
_GENERATION = itertools.count(1)


class RateLimitConfig:
    """A loaded, immutable limit configuration (reference RateLimitConfig)."""

    def __init__(self, stats_manager: Manager):
        self._domains: Dict[str, _Node] = {}
        self._stats_manager = stats_manager
        self.generation = next(_GENERATION)
        # Domain -> shed priority (the overload controller's level
        # ladder; overload/controller.py).  Every loaded domain has an
        # entry — explicit ``priority:`` or DEFAULT_DOMAIN_PRIORITY.
        self.priorities: Dict[str, int] = {}

    # -- loading ---------------------------------------------------------

    def load_file(self, file: ConfigFile) -> None:
        """Parse + validate one YAML file into the trie
        (reference loadConfig, config_impl.go:200-232)."""
        try:
            raw = yaml.safe_load(file.content)
        except yaml.YAMLError as e:
            raise _error(file, f"error loading config file: {e}") from None

        if raw is None:
            raw = {}
        if not isinstance(raw, dict):
            raise _error(file, "error loading config file: root must be a map")
        _validate_keys(file, raw)

        domain = _as_str(file, raw.get("domain"), "domain")
        if domain == "":
            raise _error(file, "config file cannot have empty domain")
        if domain in self._domains:
            raise _error(file, f"duplicate domain '{domain}' in config file")

        priority = raw.get("priority")
        if priority is None:
            priority = DEFAULT_DOMAIN_PRIORITY
        elif (
            isinstance(priority, bool)
            or not isinstance(priority, int)
            or priority < 0
        ):
            # bool is an int subclass — `priority: true` must not
            # silently become priority 1.
            raise _error(
                file,
                "error loading config file: priority must be a "
                f"non-negative integer, got {priority!r}",
            )

        root = _Node()
        self._load_descriptors(file, root, domain + ".", raw.get("descriptors") or [])
        self._domains[domain] = root
        self.priorities[domain] = priority

    def _load_descriptors(
        self, file: ConfigFile, node: _Node, parent_key: str, descriptors: Sequence[dict]
    ) -> None:
        """Recursive trie build (reference loadDescriptors,
        config_impl.go:99-151)."""
        if not isinstance(descriptors, list):
            raise _error(file, "error loading config file: descriptors must be a list")
        for desc in descriptors:
            if "priority" in desc:
                # Shed ordering is a DOMAIN property (the controller
                # sheds whole domains, lowest level first); a
                # per-descriptor priority would silently do nothing.
                raise _error(
                    file,
                    "priority is a domain-level key (shed ordering); "
                    "it cannot appear on a descriptor",
                )
            key = _as_str(file, desc.get("key"), "key")
            if key == "":
                raise _error(file, "descriptor has empty key")
            value = _as_str(file, desc.get("value"), "value")

            final_key = key if value == "" else f"{key}_{value}"
            new_parent_key = parent_key + final_key
            if final_key in node.children:
                raise _error(
                    file, f"duplicate descriptor composite key '{new_parent_key}'"
                )

            rule: Optional[RateLimitRule] = None
            rl = desc.get("rate_limit")
            if rl is not None:
                if not isinstance(rl, dict):
                    raise _error(file, "error loading config file: rate_limit must be a map")
                unlimited = _as_bool(file, rl.get("unlimited"), "unlimited")
                unit_name = _as_str(file, rl.get("unit"), "unit").upper()
                unit_value = UNIT_VALUES.get(unit_name)
                valid_unit = unit_value is not None and unit_value != int(Unit.UNKNOWN)
                if unlimited:
                    if valid_unit:
                        raise _error(
                            file, "should not specify rate limit unit when unlimited"
                        )
                    unit_value = int(Unit.UNKNOWN)
                elif not valid_unit:
                    raise _error(
                        file, f"invalid rate limit unit '{rl.get('unit', '')}'"
                    )
                requests_per_unit = _as_uint32(
                    file, rl.get("requests_per_unit"), "requests_per_unit"
                )
                shadow_mode = _as_bool(file, desc.get("shadow_mode"), "shadow_mode")
                # Pluggable limiter algorithm + shadow rollout flag
                # (models/registry.py; docs/ALGORITHMS.md).
                algorithm = _as_str(file, rl.get("algorithm"), "algorithm")
                if algorithm == "":
                    algorithm = DEFAULT_ALGORITHM
                elif algorithm not in ALGORITHM_NAMES:
                    raise _error(
                        file,
                        f"invalid rate limit algorithm '{algorithm}' "
                        f"(known: {', '.join(sorted(ALGORITHM_NAMES))})",
                    )
                if unlimited and rl.get("algorithm") is not None:
                    raise _error(
                        file,
                        "should not specify rate limit algorithm when unlimited",
                    )
                algo_shadow = _as_bool(file, rl.get("shadow"), "shadow")
                if algo_shadow and algorithm == DEFAULT_ALGORITHM:
                    raise _error(
                        file,
                        "shadow: true requires a non-default algorithm "
                        "(shadow evaluates the candidate kernel while "
                        f"'{DEFAULT_ALGORITHM}' keeps enforcing)",
                    )
                rule = RateLimitRule(
                    full_key=new_parent_key,
                    limit=RateLimit(requests_per_unit, Unit(unit_value)),
                    stats=self._stats_manager.rate_limit_stats(new_parent_key),
                    unlimited=unlimited,
                    shadow_mode=shadow_mode,
                    algorithm=algorithm,
                    algo_shadow=algo_shadow,
                )

            child = _Node()
            child.rule = rule
            self._load_descriptors(
                file, child, new_parent_key + ".", desc.get("descriptors") or []
            )
            node.children[final_key] = child

    # -- lookup ----------------------------------------------------------

    def get_limit(self, domain: str, descriptor: Descriptor) -> Optional[RateLimitRule]:
        """Most-specific-match walk (reference GetLimit,
        config_impl.go:243-298)."""
        domain_node = self._domains.get(domain)
        if domain_node is None:
            return None

        if descriptor.limit is not None:
            # Request-supplied override bypasses the trie; overrides never
            # run in shadow mode (config_impl.go:254-265).
            key = _descriptor_key(domain, descriptor)
            return RateLimitRule(
                full_key=key,
                limit=RateLimit(
                    descriptor.limit.requests_per_unit, Unit(descriptor.limit.unit)
                ),
                stats=self._stats_manager.rate_limit_stats(key),
                unlimited=False,
                shadow_mode=False,
            )

        rule: Optional[RateLimitRule] = None
        children = domain_node.children
        last = len(descriptor.entries) - 1
        for i, entry in enumerate(descriptor.entries):
            # Exact key_value child first, wildcard key child second
            # (config_impl.go:268-278).
            # Plain concat, not an f-string: this runs per entry on
            # the config-tree walk of every unresolved descriptor.
            node = children.get(entry.key + "_" + entry.value)
            if node is None:
                node = children.get(entry.key)
            if node is not None and node.rule is not None and i == last:
                # Depth must match: a rule at a non-final level is
                # ignored (config_impl.go:280-287).
                rule = node.rule
            if node is not None and node.children:
                children = node.children
            else:
                break
        return rule

    # -- debugging -------------------------------------------------------

    def dump(self) -> str:
        """Human-readable rule dump (reference Dump/dump,
        config_impl.go:74-85, 234-241)."""
        lines: List[str] = []

        def walk(node: _Node) -> None:
            if node.rule is not None:
                r = node.rule
                algo = ""
                if r.algorithm != DEFAULT_ALGORITHM:
                    algo = f", algorithm: {r.algorithm}" + (
                        " (shadow)" if r.algo_shadow else ""
                    )
                lines.append(
                    f"{r.full_key}: unit={r.limit.unit.name} "
                    f"requests_per_unit={r.limit.requests_per_unit}, "
                    f"shadow_mode: {str(r.shadow_mode).lower()}{algo}\n"
                )
            for child in node.children.values():
                walk(child)

        for domain_node in self._domains.values():
            walk(domain_node)
        return "".join(lines)

    @property
    def domains(self) -> Dict[str, _Node]:
        return self._domains


def _descriptor_key(domain: str, descriptor: Descriptor) -> str:
    """Stat key for override limits (reference descriptorKey,
    config_impl.go:300-312)."""
    parts = []
    for entry in descriptor.entries:
        piece = entry.key
        if entry.value != "":
            piece += "_" + entry.value
        parts.append(piece)
    return domain + "." + ".".join(parts)


def load_config(files: Sequence[ConfigFile], stats_manager: Manager) -> RateLimitConfig:
    """Load an aggregate config from YAML files
    (reference NewRateLimitConfigImpl, config_impl.go:318-327)."""
    config = RateLimitConfig(stats_manager)
    for f in files:
        config.load_file(f)
    return config
