"""Interprocedural concurrency rules over the ProjectIndex.

Three whole-program checks — the static half of what ``go test -race``
and lockdep give the reference repo:

- ``lock-order-cycle``: the union of every lock-acquisition ORDER the
  program can exhibit (lexical ``with`` nesting plus acquisitions
  reached through calls made under a lock) forms a directed graph over
  lock IDENTITIES (class-scoped attribute sites, lockdep-style); any
  cycle is a static deadlock candidate — two threads walking the cycle
  from different entry points can block each other forever.
- ``blocking-under-lock``: the per-file lock-discipline check extended
  through the call graph — a ``time.sleep`` / socket op / untimed
  ``get``/``wait``/``join`` REACHED through any chain of calls made
  while a lock is held stalls every thread contending on that lock.
- ``shared-state``: a ``self.X`` attribute written from two or more
  distinct thread entry points (Thread/Timer targets, plus the RPC/
  main context approximated by no-caller entry functions) with no
  write under any lock.  Deliberately-unlocked designs (GIL-atomic
  single-writer counters, swap-on-write views) carry a justified
  ``# tpu-lint: disable=shared-state -- why`` at the write site.

Findings anchor at real source lines so the engine's line-suppression
machinery applies unchanged; a cycle finding anchors at its lexically
smallest edge site and names every edge so the cycle stays legible in
one message.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .engine import Finding
from .project import (
    BlockingSite,
    FunctionInfo,
    ProjectIndex,
    ProjectRule,
)


def _site(fn: FunctionInfo, node: ast.AST) -> Tuple[str, int]:
    return (fn.module.path, getattr(node, "lineno", 1))


class LockOrderCycleRule(ProjectRule):
    """Static deadlock candidates: cycles in the lock-order graph."""

    id = "lock-order-cycle"
    description = "cyclic lock-acquisition order across the call graph"

    #: Bounded interprocedural depth is unnecessary (closures are
    #: memoized) but recursion through unresolved edges is: the
    #: acquires-closure walks resolved edges only.

    def check_project(self, index: ProjectIndex) -> List[Finding]:
        # lock-id -> lock-id -> (path, line, how)
        edges: Dict[str, Dict[str, Tuple[str, int, str]]] = {}
        acquires = _AcquiresClosure(index)

        def add_edge(a: str, b: str, path: str, line: int, how: str):
            if a == b:
                return  # reentrant same-identity: RLock territory
            edges.setdefault(a, {}).setdefault(b, (path, line, how))

        for fn in index.functions.values():
            for ls in fn.lock_sites:
                path, line = _site(fn, ls.node)
                for outer in ls.held:
                    add_edge(
                        outer,
                        ls.lock_id,
                        path,
                        line,
                        f"`with {ls.lock_id}` nested under {outer} in "
                        f"{fn.qualname}",
                    )
            for cs in fn.call_sites:
                if not cs.held or cs.callee is None:
                    continue
                path, line = _site(fn, cs.node)
                for inner, via in acquires.closure(cs.callee).items():
                    for outer in cs.held:
                        add_edge(
                            outer,
                            inner,
                            path,
                            line,
                            f"{fn.qualname} calls {cs.callee.qualname} "
                            f"under {outer}; {via} acquires {inner}",
                        )

        findings: List[Finding] = []
        for cycle in _find_cycles(edges):
            # anchor at the lexically smallest edge site in the cycle
            sites = []
            legs = []
            for i, a in enumerate(cycle):
                b = cycle[(i + 1) % len(cycle)]
                path, line, how = edges[a][b]
                sites.append((path, line))
                legs.append(f"{a} -> {b} ({path}:{line}: {how})")
            path, line = min(sites)
            findings.append(
                Finding(
                    rule_id=self.id,
                    path=path,
                    line=line,
                    col=0,
                    message=(
                        "lock-order cycle (static deadlock candidate): "
                        + "; ".join(legs)
                    ),
                )
            )
        return findings


class _AcquiresClosure:
    """lock-id -> 'where' map of every lock acquired by a function or
    anything it (transitively) calls; memoized per function."""

    def __init__(self, index: ProjectIndex):
        self.index = index
        self._memo: Dict[FunctionInfo, Dict[str, str]] = {}

    def closure(self, fn: FunctionInfo) -> Dict[str, str]:
        memo = self._memo.get(fn)
        if memo is not None:
            return memo
        out: Dict[str, str] = {}
        self._memo[fn] = out  # pre-seed: recursion terminates
        for f in self.index.reachable(fn):
            for ls in f.lock_sites:
                out.setdefault(
                    ls.lock_id,
                    f"{f.qualname} ({f.module.path}:{ls.node.lineno})",
                )
        return out


def _find_cycles(
    edges: Dict[str, Dict[str, tuple]]
) -> List[List[str]]:
    """Minimal cycle list: one representative cycle per strongly
    connected component with >1 node (iterative Tarjan, then a BFS
    inside the component for a concrete cycle path)."""
    index_of: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    sccs: List[List[str]] = []
    counter = [0]

    def strongconnect(root: str) -> None:
        work = [(root, iter(edges.get(root, ())))]
        index_of[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            v, it = work[-1]
            advanced = False
            for w in it:
                if w not in index_of:
                    index_of[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(edges.get(w, ()))))
                    advanced = True
                    break
                elif w in on_stack:
                    low[v] = min(low[v], index_of[w])
            if advanced:
                continue
            work.pop()
            if low[v] == index_of[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == v:
                        break
                if len(comp) > 1:
                    sccs.append(comp)
            if work:
                pv = work[-1][0]
                low[pv] = min(low[pv], low[v])

    all_nodes = set(edges)
    for tos in edges.values():
        all_nodes.update(tos)
    for n in sorted(all_nodes):
        if n not in index_of:
            strongconnect(n)

    cycles: List[List[str]] = []
    for comp in sccs:
        comp_set = set(comp)
        start = min(comp)
        # BFS within the component from `start` back to itself
        parent: Dict[str, Optional[str]] = {start: None}
        queue = [start]
        found = None
        while queue and found is None:
            v = queue.pop(0)
            for w in edges.get(v, ()):
                if w == start:
                    found = v
                    break
                if w in comp_set and w not in parent:
                    parent[w] = v
                    queue.append(w)
        if found is None:
            continue  # pragma: no cover - SCC guarantees a cycle
        path = [found]
        while parent[path[-1]] is not None:
            path.append(parent[path[-1]])
        cycles.append(list(reversed(path)))
    return cycles


class BlockingUnderLockRule(ProjectRule):
    """Blocking call REACHED through calls made under a held lock."""

    id = "blocking-under-lock"
    description = "blocking call reachable through calls under a lock"

    def check_project(self, index: ProjectIndex) -> List[Finding]:
        blocking = _BlockingClosure(index)
        findings: List[Finding] = []
        seen: Set[Tuple[str, int, str]] = set()
        for fn in index.functions.values():
            for cs in fn.call_sites:
                if not cs.held or cs.callee is None:
                    continue
                hit = blocking.closure(cs.callee)
                if hit is None:
                    continue
                bsite, chain = hit
                # A cv.wait() on the lock we hold is the condition-
                # variable idiom, not a bug (the wait releases it).
                if bsite.waits_on is not None and any(
                    h.endswith(bsite.waits_on.split(".")[-1])
                    for h in cs.held
                ):
                    continue
                path, line = _site(fn, cs.node)
                key = (path, line, cs.held[-1])
                if key in seen:
                    continue
                seen.add(key)
                chain_s = " -> ".join(f.qualname for f in chain)
                findings.append(
                    Finding(
                        rule_id=self.id,
                        path=path,
                        line=line,
                        col=cs.node.col_offset,
                        message=(
                            f"call under {cs.held[-1]} reaches "
                            f"{bsite.desc} via {chain_s} "
                            f"({chain[-1].module.path}:"
                            f"{bsite.node.lineno}); every thread "
                            "contending on the lock stalls behind it"
                        ),
                    )
                )
        return findings


class _BlockingClosure:
    """First blocking site reachable from a function (itself included),
    with the call chain that reaches it; memoized.  Blocking sites that
    are themselves under a lexical lock in their OWN function are still
    reported — holding caller's lock + callee's lock while blocking is
    worse, not better."""

    def __init__(self, index: ProjectIndex):
        self.index = index
        self._memo: Dict[
            FunctionInfo,
            Optional[Tuple[BlockingSite, Tuple[FunctionInfo, ...]]],
        ] = {}

    def closure(self, fn, _visiting=None):
        if fn in self._memo:
            return self._memo[fn]
        _visiting = _visiting or set()
        if fn in _visiting:
            return None  # recursion: no blocking found on this path
        _visiting.add(fn)
        result = None
        if fn.blocking_sites:
            result = (fn.blocking_sites[0], (fn,))
        else:
            for cs in fn.call_sites:
                if cs.callee is None:
                    continue
                sub = self.closure(cs.callee, _visiting)
                if sub is not None:
                    result = (sub[0], (fn,) + sub[1])
                    break
        _visiting.discard(fn)
        self._memo[fn] = result
        return result


class SharedStateRule(ProjectRule):
    """Attributes written from >=2 thread contexts with no lock."""

    id = "shared-state"
    description = "attribute written from multiple threads with no lock"

    def check_project(self, index: ProjectIndex) -> List[Finding]:
        # Context labels per function: thread roots reaching it; "main"
        # when a no-caller entry function reaches it; and "pool:<mod>"
        # when the entry lives in a module hosting a thread pool or
        # threaded server — a POOL context is concurrent with ITSELF
        # (two RPC handler threads run the same code), so it alone
        # satisfies the >=2-contexts bar.
        root_reach: List[Tuple[str, Set[FunctionInfo]]] = []
        for root in index.thread_roots:
            root_reach.append(
                (
                    f"thread:{root.fn.qualname}",
                    index.reachable(root.fn, escapes=True),
                )
            )
        main_reach: Set[FunctionInfo] = set()
        pool_reach: Dict[str, Set[FunctionInfo]] = {}
        for entry in index.entry_functions():
            reach = index.reachable(entry, escapes=True)
            main_reach |= reach
            if entry.module.has_pool:
                pool_reach.setdefault(
                    f"pool:{entry.module.name}", set()
                ).update(reach)

        def contexts(fn: FunctionInfo) -> Tuple[Set[str], bool]:
            out = {label for label, reach in root_reach if fn in reach}
            pooled = False
            for label, reach in pool_reach.items():
                if fn in reach:
                    out.add(label)
                    pooled = True
            if fn in main_reach:
                out.add("main")
            return out, pooled

        dominated = _lock_dominated(index)

        # (module, class, attr) -> write facts
        slots: Dict[Tuple[str, str, str], dict] = {}
        for fn in index.functions.values():
            for w in fn.attr_writes:
                key = (fn.module.name, w.cls, w.attr)
                slot = slots.setdefault(
                    key,
                    {
                        "contexts": set(),
                        "pooled": False,
                        "locked": False,
                        "sites": [],
                    },
                )
                ctx, pooled = contexts(fn)
                slot["contexts"] |= ctx
                slot["pooled"] = slot["pooled"] or pooled
                slot["locked"] = (
                    slot["locked"] or w.locked or fn in dominated
                )
                slot["sites"].append((fn.module.path, w.node.lineno, fn))

        findings: List[Finding] = []
        for (mod, cls, attr), slot in sorted(slots.items()):
            if slot["locked"]:
                continue
            if len(slot["contexts"]) < 2 and not slot["pooled"]:
                continue
            path, line, _fn = min(slot["sites"])
            ctx_names = sorted(
                c.split("@")[0].strip() for c in slot["contexts"]
            )
            findings.append(
                Finding(
                    rule_id=self.id,
                    path=path,
                    line=line,
                    col=0,
                    message=(
                        f"{cls}.{attr} is written from concurrent "
                        f"contexts ({', '.join(ctx_names)}) and never "
                        "under a lock — racy unless GIL-atomic by "
                        "design (suppress with a justification if so)"
                    ),
                )
            )
        return findings


def _lock_dominated(index: ProjectIndex) -> Set[FunctionInfo]:
    """Functions ONLY ever called with a lock held: every resolved
    call site either holds a lock lexically or sits in a function that
    is itself lock-dominated.  Greatest fixpoint (optimistic start,
    demote until stable), so helper cycles settle correctly.  Writes
    inside these functions count as locked — ``_push`` called only
    from inside ``with self._lock:`` bodies is not a race."""
    callers: Dict[FunctionInfo, List[Tuple[FunctionInfo, bool]]] = {}
    for fn in index.functions.values():
        for cs in fn.call_sites:
            if cs.callee is not None:
                callers.setdefault(cs.callee, []).append(
                    (fn, bool(cs.held))
                )
    dominated = {fn for fn in callers}  # optimistic: all candidates
    changed = True
    while changed:
        changed = False
        for fn in list(dominated):
            ok = all(
                held or caller in dominated
                for caller, held in callers[fn]
            )
            if not ok:
                dominated.discard(fn)
                changed = True
    return dominated


#: Function names that ARE the request path: the service entry points
#: and the backend decision seams every transport funnels through.
#: Anything reachable from one of these (under-approximate call graph,
#: no escape edges) runs with an RPC waiting on it.
REQUEST_PATH_ROOTS = frozenset(
    {
        "should_rate_limit",
        "_should_rate_limit_worker",
        "do_limit",
        "do_limit_resolved",
    }
)


class BoundedWaitRule(ProjectRule):
    """Untimed waits on the request path: every ``Event.wait()`` /
    ``Condition.wait()`` / ``Thread.join()`` reachable from a request-
    path root must carry a timeout.

    The static twin of the runtime sanitizer's held-across-blocking
    check, motivated by the device-path fault domain
    (docs/RESILIENCE.md): the whole point of KERNEL_DEADLINE_S is that
    no RPC ever blocks unboundedly on the device — an untimed wait
    anywhere on the path re-opens that hole.  Background threads
    (dispatcher collector, samplers) may block at their idle points;
    only request-path reachability is a finding.  Intentional untimed
    waits off the serving path carry a justified
    ``# tpu-lint: disable=bounded-wait -- why``.
    """

    id = "bounded-wait"
    description = (
        "untimed Event.wait()/Condition.wait()/Thread.join() reachable "
        "from the request path"
    )

    def check_project(self, index: ProjectIndex) -> List[Finding]:
        roots = [
            fn
            for fn in index.functions.values()
            if fn.name in REQUEST_PATH_ROOTS
        ]
        reach: dict = {}  # FunctionInfo -> one root qualname (evidence)
        for root in roots:
            for fn in index.reachable(root, escapes=False):
                reach.setdefault(fn, root.qualname)
        findings: List[Finding] = []
        seen = set()
        for fn, via in reach.items():
            for bs in fn.blocking_sites:
                desc = bs.desc
                if not desc.startswith("untimed"):
                    continue
                if not (desc.endswith(".wait()") or desc.endswith(".join()")):
                    continue
                path, line = _site(fn, bs.node)
                key = (path, line)
                if key in seen:
                    continue
                seen.add(key)
                findings.append(
                    Finding(
                        rule_id=self.id,
                        path=path,
                        line=line,
                        col=getattr(bs.node, "col_offset", 0),
                        message=(
                            f"{desc} in {fn.qualname} is reachable from "
                            f"the request path (via {via}): an RPC can "
                            "block on it forever — pass a timeout "
                            "(KERNEL_DEADLINE_S-bounded) or move the "
                            "wait off the serving path"
                        ),
                    )
                )
        return findings


def make_concurrency_rules() -> List[ProjectRule]:
    return [
        LockOrderCycleRule(),
        BlockingUnderLockRule(),
        SharedStateRule(),
        BoundedWaitRule(),
    ]
