"""Whole-program index: symbol table, call graph, thread roots, locks.

The per-file engine analyzes one file at a time, which is blind to exactly
the bugs a concurrent service grows: a blocking call reached *through*
a helper invoked under a lock, lock acquisition orders that only
conflict across modules, and state shared between thread entry points
that live in different files.  This module parses every file ONCE and
builds the shared substrate the interprocedural rules
(analysis/concurrency.py, analysis/contracts.py) plug into:

- :class:`ModuleInfo` — per-module import map (absolute and relative,
  aliased), top-level functions, classes with methods and
  attribute-type facts (``self.x = ClassName(...)`` and annotated
  parameters bound to attributes).
- :class:`ProjectIndex` — module-qualified function/method resolution
  for call sites (module functions, ``self.m()`` with base-class
  walks, imported symbols, typed-attribute receivers like
  ``self._dispatcher.submit()``, and a stoplisted unique-method-name
  fallback), thread entry-point discovery
  (``threading.Thread(target=...)`` / ``threading.Timer``), per-
  function lock-acquisition and blocking-call sites, and memoized
  transitive closures over the call graph.

Resolution is deliberately best-effort and UNDER-approximate: an edge
is only added when the target is credibly identified, because the
rules built on top report findings (a missed edge costs recall; a
fabricated edge costs a false positive the whole tree then has to
suppress).  Everything is stdlib ``ast`` — no imports of the analyzed
code, so the analyzer keeps working on machines without torch/grpc.

Port of ratelimit_tpu/analysis/project.py: module names follow the
package layout, so the port's modules index as ``ratelimit_tpu_torch.*``.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .engine import FileContext

# ---------------------------------------------------------------------------
# small AST helpers (shared with rules.py without importing it: rules.py
# imports us for the project pass, keep the dependency one-way)
# ---------------------------------------------------------------------------


def dotted(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


def terminal(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


#: Terminal-name fragments identifying a synchronization primitive
#: (same heuristic as the lock-discipline rule).
LOCKISH_FRAGMENTS = ("lock", "mutex", "_cv", "cond")

#: Factory callees that mint a lock object (used for attr-type facts:
#: ``self._x = threading.Lock()`` marks ``_x`` lock-typed even when the
#: attribute name itself carries no lock fragment).
LOCK_FACTORIES = {
    "threading.Lock",
    "threading.RLock",
    "threading.Condition",
    "Lock",
    "RLock",
    "Condition",
}

#: Method names too generic for the unique-name fallback: resolving
#: ``q.get()`` to the one project class that happens to define get()
#: would fabricate edges all over the tree.
UBIQUITOUS_METHODS = frozenset(
    {
        "get", "put", "set", "add", "append", "pop", "items", "keys",
        "values", "join", "start", "stop", "wait", "close", "run",
        "send", "recv", "write", "read", "copy", "update", "clear",
        "acquire", "release", "flush", "observe", "value", "snapshot",
        "next", "name", "encode", "decode", "register", "main", "step",
        "reset", "result", "summary", "apply", "fail",
    }
)


# ---------------------------------------------------------------------------
# per-function facts
# ---------------------------------------------------------------------------


@dataclass
class LockSite:
    """One ``with <lock>:`` acquisition."""

    lock_id: str  # normalized identity (see ProjectIndex._lock_identity)
    node: ast.AST  # the With node (finding anchor)
    held: Tuple[str, ...]  # locks already held LEXICALLY at this site


@dataclass
class CallSite:
    node: ast.Call
    held: Tuple[str, ...]  # locks held lexically at the call
    callee: Optional["FunctionInfo"] = None  # filled by the link pass
    # When the callee is ambiguous (a few same-named methods), the
    # candidate set feeds the ESCAPE graph only: thread-context
    # labeling wants "may call" (over-approximate), the lock/blocking
    # rules want "does call" (under-approximate, `callee` only).
    candidates: Tuple["FunctionInfo", ...] = ()


@dataclass
class BlockingSite:
    node: ast.AST
    desc: str  # human description ("time.sleep()", "untimed q.get()")
    waits_on: Optional[str] = None  # lock id for .wait() sites, if any


@dataclass
class AttrWrite:
    cls: str  # enclosing class name
    attr: str
    node: ast.AST
    locked: bool  # lexically under any lock at the write
    fn: "FunctionInfo" = None  # type: ignore[assignment]
    # "assign" (self.x = / augassign), "subscript" (self.x[k] = v),
    # "mutate" (self.x.append(...) and friends) — container mutations
    # are writes too: the flight-recorder domain-intern race hid in an
    # append + len() pair no plain-assign tracker could see.
    kind: str = "assign"


#: Container-mutating method names tracked as attribute writes when
#: invoked on a direct ``self.X`` receiver.
MUTATING_METHODS = frozenset(
    {
        "append", "appendleft", "pop", "popleft", "popitem", "insert",
        "extend", "remove", "clear", "add", "discard", "setdefault",
        "update",
    }
)

#: Callees / base classes marking a module as hosting a THREAD POOL:
#: everything reachable from such a module's entry functions runs
#: concurrently WITH ITSELF (gRPC handler pool, threaded HTTP server,
#: executor fan-out), so one "context" there already means two.
POOL_MARKERS = {
    "ThreadPoolExecutor",
    "futures.ThreadPoolExecutor",
    "concurrent.futures.ThreadPoolExecutor",
    "grpc.server",
}
POOL_BASE_FRAGMENTS = ("ThreadingMixIn", "ThreadingHTTPServer")


class FunctionInfo:
    """One function or method (module-level, class-level, or nested)."""

    __slots__ = (
        "qualname",
        "module",
        "cls",
        "name",
        "node",
        "parent",
        "local_fns",
        "lock_sites",
        "call_sites",
        "blocking_sites",
        "attr_writes",
        "value_refs",
        "extra_callees",
        "aliases",
        "thread_target_refs",
    )

    def __init__(self, qualname, module, cls, name, node, parent=None):
        self.qualname: str = qualname
        self.module: "ModuleInfo" = module
        self.cls: Optional[str] = cls
        self.name: str = name
        self.node = node
        self.parent: Optional[FunctionInfo] = parent  # enclosing fn
        self.local_fns: Dict[str, FunctionInfo] = {}
        self.lock_sites: List[LockSite] = []
        self.call_sites: List[CallSite] = []
        self.blocking_sites: List[BlockingSite] = []
        self.attr_writes: List[AttrWrite] = []
        # self._m referenced as a VALUE (escapes into closures,
        # callbacks, Thread targets); resolved to escape edges later.
        self.value_refs: List[str] = []
        # escape-only call edges (closure environments, nested defs);
        # used by the ESCAPE reachability graph (shared-state), never
        # by the lock/blocking closures — a reference is not a call
        # under the referencing scope's locks.
        self.extra_callees: List["FunctionInfo"] = []
        # local name -> self attr it aliases (pool = self._event_pool)
        self.aliases: Dict[str, str] = {}
        # self._m refs that are Thread/Timer TARGETS here: excluded
        # from escape edges (the ref registers a thread root, it is
        # not a call on the referencing thread).
        self.thread_target_refs: Set[str] = set()

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"<fn {self.qualname}>"


@dataclass
class ClassInfo:
    name: str
    module: "ModuleInfo"
    node: ast.ClassDef
    bases: List[str] = field(default_factory=list)  # raw base exprs
    methods: Dict[str, FunctionInfo] = field(default_factory=dict)
    # attr -> ClassInfo qualname ("mod:Class") for self.x = Class(...)
    # or an annotated parameter assigned to self.x.
    attr_types: Dict[str, str] = field(default_factory=dict)
    # attrs assigned a lock factory in any method (incl. __init__)
    lock_attrs: Set[str] = field(default_factory=set)

    @property
    def qualname(self) -> str:
        return f"{self.module.name}:{self.name}"


@dataclass
class ThreadRoot:
    """One discovered thread entry point (Thread/Timer target)."""

    label: str  # "<target qualname> @ <path>:<line>"
    fn: FunctionInfo
    path: str
    line: int


class ModuleInfo:
    __slots__ = (
        "name",
        "path",
        "tree",
        "ctx",
        "imports",
        "functions",
        "classes",
        "global_locks",
        "has_pool",
    )

    def __init__(self, name: str, ctx: FileContext):
        self.name = name
        self.path = ctx.path
        self.tree = ctx.tree
        self.ctx = ctx
        # alias -> ("module", dotted) | ("symbol", dotted_module, orig)
        self.imports: Dict[str, tuple] = {}
        self.functions: Dict[str, FunctionInfo] = {}
        self.classes: Dict[str, ClassInfo] = {}
        # module-level names bound to a lock factory (trace._rand_lock)
        self.global_locks: Set[str] = set()
        # hosts a thread pool / threaded server (see POOL_MARKERS)
        self.has_pool: bool = False


# ---------------------------------------------------------------------------
# blocking-call classification (shared with the runtime sanitizer's
# docs; the static set mirrors rules.LockDisciplineRule)
# ---------------------------------------------------------------------------

_BLOCKING_IO_METHODS = {"recv", "recvfrom", "sendall", "connect", "accept"}
_QUEUEISH = ("queue", "_q", "_buf")


def _has_timeout(call: ast.Call) -> bool:
    if any(kw.arg in ("timeout", "timeout_s") for kw in call.keywords):
        return True
    return len(call.args) >= 2


def classify_blocking(call: ast.Call) -> Optional[BlockingSite]:
    """A :class:`BlockingSite` when `call` can block indefinitely
    (sleep, socket I/O, untimed queue get / wait / join), else None."""
    callee = dotted(call.func)
    if callee == "time.sleep":
        return BlockingSite(call, "time.sleep()")
    if not isinstance(call.func, ast.Attribute):
        return None
    meth = call.func.attr
    recv = call.func.value
    recv_name = (terminal(recv) or "").lower()
    if meth in _BLOCKING_IO_METHODS:
        return BlockingSite(call, f"blocking I/O .{meth}()")
    if meth == "get" and not _has_timeout(call):
        if any(recv_name == q or recv_name.endswith(q) for q in _QUEUEISH):
            return BlockingSite(call, f"untimed {recv_name}.get()")
    elif meth == "wait" and not call.args and not call.keywords:
        return BlockingSite(
            call,
            f"untimed {dotted(recv) or recv_name}.wait()",
            waits_on=dotted(recv) or recv_name,
        )
    elif meth == "join" and not call.args and not call.keywords:
        # str.join always takes an argument; a zero-arg join is a
        # thread/process join with no timeout.
        return BlockingSite(call, f"untimed {recv_name}.join()")
    return None


# ---------------------------------------------------------------------------
# the index
# ---------------------------------------------------------------------------


class ProjectIndex:
    """Parse-once, whole-program view over a set of FileContexts."""

    def __init__(self, ctxs: Sequence[FileContext]):
        self.modules: Dict[str, ModuleInfo] = {}
        self.ctx_by_path: Dict[str, FileContext] = {}
        self.functions: Dict[str, FunctionInfo] = {}
        self.classes_by_name: Dict[str, List[ClassInfo]] = {}
        self.methods_by_name: Dict[str, List[FunctionInfo]] = {}
        self.thread_roots: List[ThreadRoot] = []
        self._reach_memo: Dict[FunctionInfo, Set[FunctionInfo]] = {}
        self._build(ctxs)

    # -- construction ----------------------------------------------------

    def _build(self, ctxs: Sequence[FileContext]) -> None:
        for ctx in ctxs:
            name = module_name_for(ctx.path)
            mod = ModuleInfo(name, ctx)
            self.modules[name] = mod
            self.ctx_by_path[ctx.path] = ctx
        # pass 1: declarations (functions/classes/imports/attr types)
        for mod in self.modules.values():
            self._index_module(mod)
        # pass 2: per-function facts + call-site resolution + roots
        for mod in self.modules.values():
            for fn in _iter_functions(mod):
                self._index_function_body(fn)
        for mod in self.modules.values():
            self._register_closure_attrs(mod)
        for mod in self.modules.values():
            for fn in _iter_functions(mod):
                self._link_calls(fn)
                self._link_escapes(fn)
            self._discover_thread_roots(mod)

    def _index_module(self, mod: ModuleInfo) -> None:
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call) and (
                dotted(node.func) in POOL_MARKERS
            ):
                mod.has_pool = True
            elif isinstance(node, ast.ClassDef) and any(
                frag in (dotted(b) or "")
                for b in node.bases
                for frag in POOL_BASE_FRAGMENTS
            ):
                mod.has_pool = True
        for node in mod.tree.body:
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                self._index_import(mod, node)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._add_function(mod, node, cls=None, parent=None)
            elif isinstance(node, ast.ClassDef):
                self._index_class(mod, node)
            elif isinstance(node, ast.Assign):
                if isinstance(node.value, ast.Call) and (
                    dotted(node.value.func) in LOCK_FACTORIES
                ):
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            mod.global_locks.add(t.id)

    def _index_import(self, mod: ModuleInfo, node) -> None:
        if isinstance(node, ast.Import):
            for a in node.names:
                alias = a.asname or a.name.split(".")[0]
                target = a.name if a.asname else a.name.split(".")[0]
                mod.imports[alias] = ("module", target)
        else:  # ImportFrom
            base = node.module or ""
            if node.level:
                # relative: resolve against this module's package
                parts = mod.name.split(".")
                parts = parts[: len(parts) - node.level]
                base = ".".join(parts + ([node.module] if node.module else []))
            for a in node.names:
                alias = a.asname or a.name
                mod.imports[alias] = ("symbol", base, a.name)

    def _index_class(self, mod: ModuleInfo, node: ast.ClassDef) -> None:
        ci = ClassInfo(name=node.name, module=mod, node=node)
        ci.bases = [dotted(b) or "" for b in node.bases]
        mod.classes[node.name] = ci
        self.classes_by_name.setdefault(node.name, []).append(ci)
        for item in node.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fn = self._add_function(mod, item, cls=node.name, parent=None)
                ci.methods[item.name] = fn
                self.methods_by_name.setdefault(item.name, []).append(fn)
        # attribute-type facts from every method body
        for fn in ci.methods.values():
            self._collect_attr_types(ci, fn)

    def _add_function(
        self, mod: ModuleInfo, node, cls: Optional[str], parent
    ) -> FunctionInfo:
        if parent is not None:
            qual = f"{parent.qualname}.<locals>.{node.name}"
        elif cls:
            qual = f"{mod.name}:{cls}.{node.name}"
        else:
            qual = f"{mod.name}:{node.name}"
        fn = FunctionInfo(qual, mod, cls, node.name, node, parent)
        self.functions[qual] = fn
        if parent is not None:
            parent.local_fns[node.name] = fn
        elif not cls:
            mod.functions[node.name] = fn
        return fn

    def _collect_attr_types(self, ci: ClassInfo, fn: FunctionInfo) -> None:
        # annotated params: def __init__(self, dispatcher: BatchDispatcher)
        ann_types: Dict[str, str] = {}
        args = fn.node.args
        for a in list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs):
            t = _annotation_class(a.annotation)
            if t:
                ann_types[a.arg] = t
        for node in ast.walk(fn.node):
            if isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = (
                    node.targets
                    if isinstance(node, ast.Assign)
                    else [node.target]
                )
                value = node.value
                for t in targets:
                    if not (
                        isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"
                    ):
                        continue
                    if isinstance(value, ast.Call):
                        callee = dotted(value.func)
                        if callee in LOCK_FACTORIES:
                            ci.lock_attrs.add(t.attr)
                            continue
                        target_ci = self._resolve_class_ref(
                            fn.module, value.func
                        )
                        if target_ci is not None:
                            ci.attr_types[t.attr] = target_ci.qualname
                    elif isinstance(value, ast.Name) and value.id in ann_types:
                        cls_name = ann_types[value.id]
                        target_ci = self._resolve_class_name(
                            fn.module, cls_name
                        )
                        if target_ci is not None:
                            ci.attr_types[t.attr] = target_ci.qualname
                    if (
                        isinstance(node, ast.AnnAssign)
                        and node.annotation is not None
                    ):
                        cls_name = _annotation_class(node.annotation)
                        if cls_name:
                            target_ci = self._resolve_class_name(
                                fn.module, cls_name
                            )
                            if target_ci is not None:
                                ci.attr_types[t.attr] = target_ci.qualname

    # -- per-function fact extraction ------------------------------------

    def _index_function_body(self, fn: FunctionInfo) -> None:
        held: List[str] = []

        def walk(node: ast.AST) -> None:
            if isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef)
            ) and node is not fn.node:
                # nested def: its body belongs to its own FunctionInfo
                if node.name not in fn.local_fns:
                    self._add_function(
                        fn.module, node, cls=fn.cls, parent=fn
                    )
                return
            if isinstance(node, ast.Lambda):
                return  # lambdas analyzed where invoked; skip bodies
            if isinstance(node, ast.With):
                acquired: List[str] = []
                for item in node.items:
                    lock_id = self._lock_identity(fn, item.context_expr)
                    if lock_id is not None:
                        fn.lock_sites.append(
                            LockSite(lock_id, node, tuple(held))
                        )
                        held.append(lock_id)
                        acquired.append(lock_id)
                for child in ast.iter_child_nodes(node):
                    walk(child)
                for _ in acquired:
                    held.pop()
                return
            if isinstance(node, ast.Call):
                fn.call_sites.append(CallSite(node, tuple(held)))
                b = classify_blocking(node)
                if b is not None:
                    fn.blocking_sites.append(b)
                self._track_mutation(fn, node, bool(held))
                self._note_thread_target_refs(fn, node)
            elif isinstance(node, (ast.Assign, ast.AugAssign)):
                self._track_alias(fn, node)
                self._track_attr_write(fn, node, bool(held))
            elif (
                isinstance(node, ast.Attribute)
                and isinstance(node.ctx, ast.Load)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"
            ):
                # self._m as a value: may escape into a closure or
                # callback (resolved to an escape edge in the link
                # pass iff it names a method of this class).
                fn.value_refs.append(node.attr)
            for child in ast.iter_child_nodes(node):
                walk(child)

        for stmt in fn.node.body:
            walk(stmt)

    def _track_attr_write(self, fn: FunctionInfo, node, locked: bool) -> None:
        if fn.cls is None or fn.name in (
            "__init__",
            "__post_init__",
            "__del__",
        ):
            return
        targets = (
            node.targets if isinstance(node, ast.Assign) else [node.target]
        )
        for t in targets:
            if (
                isinstance(t, ast.Attribute)
                and isinstance(t.value, ast.Name)
                and t.value.id == "self"
            ):
                fn.attr_writes.append(
                    AttrWrite(fn.cls, t.attr, node, locked, fn)
                )
            elif isinstance(t, ast.Subscript):
                # self.X[k] = v (directly or via a local alias): a
                # store through a shared container.
                attr = None
                if (
                    isinstance(t.value, ast.Attribute)
                    and isinstance(t.value.value, ast.Name)
                    and t.value.value.id == "self"
                ):
                    attr = t.value.attr
                elif (
                    isinstance(t.value, ast.Name)
                    and t.value.id in fn.aliases
                ):
                    attr = fn.aliases[t.value.id]
                if attr is not None:
                    fn.attr_writes.append(
                        AttrWrite(
                            fn.cls, attr, node, locked, fn,
                            kind="subscript",
                        )
                    )

    def _note_thread_target_refs(self, fn: FunctionInfo, call: ast.Call):
        callee = dotted(call.func)
        exprs = []
        if callee in self._THREAD_CTORS:
            exprs = [kw.value for kw in call.keywords if kw.arg == "target"]
        elif callee in self._TIMER_CTORS and len(call.args) >= 2:
            exprs = [call.args[1]]
        for e in exprs:
            if (
                isinstance(e, ast.Attribute)
                and isinstance(e.value, ast.Name)
                and e.value.id == "self"
            ):
                fn.thread_target_refs.add(e.attr)

    def _track_alias(self, fn: FunctionInfo, node) -> None:
        """pool = self._event_pool: later mutations through `pool`
        are writes to the attribute."""
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            return
        t, v = node.targets[0], node.value
        if (
            isinstance(t, ast.Name)
            and isinstance(v, ast.Attribute)
            and isinstance(v.value, ast.Name)
            and v.value.id == "self"
        ):
            fn.aliases[t.id] = v.attr

    def _track_mutation(self, fn: FunctionInfo, call: ast.Call, locked: bool):
        """self.X.append(...) and friends — directly or through a
        local alias — count as writes to X."""
        if fn.cls is None or fn.name in (
            "__init__",
            "__post_init__",
            "__del__",
        ):
            return
        f = call.func
        if not (isinstance(f, ast.Attribute) and f.attr in MUTATING_METHODS):
            return
        attr = None
        if (
            isinstance(f.value, ast.Attribute)
            and isinstance(f.value.value, ast.Name)
            and f.value.value.id == "self"
        ):
            attr = f.value.attr
        elif isinstance(f.value, ast.Name) and f.value.id in fn.aliases:
            attr = fn.aliases[f.value.id]
        if attr is not None:
            fn.attr_writes.append(
                AttrWrite(fn.cls, attr, call, locked, fn, kind="mutate")
            )

    # -- lock identity ----------------------------------------------------

    def _lock_identity(self, fn: FunctionInfo, expr: ast.AST) -> Optional[str]:
        """Normalized lock identity for a with-context expression, or
        None when it does not look like a lock.

        Identity is CLASS-scoped for attributes (``Dispatcher._state_
        lock``) — the lockdep convention: every instance created at one
        attribute site shares ordering constraints — and module-scoped
        for globals."""
        name = terminal(expr)
        if name is None:
            return None
        mod = fn.module
        lockish = (
            any(f in name.lower() for f in LOCKISH_FRAGMENTS)
            or name.lower() == "cv"
        )
        # self._x: class-scoped identity; lock_attrs covers factory-
        # assigned attrs whose names carry no lock fragment.
        if (
            isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"
            and fn.cls is not None
        ):
            ci = mod.classes.get(fn.cls)
            if lockish or (ci is not None and name in ci.lock_attrs):
                return f"{fn.cls}.{name}"
            return None
        if isinstance(expr, ast.Name):
            if name in mod.global_locks:
                return f"{mod.name}:{name}"
            if lockish:
                # local variable lock: function-scoped identity
                return f"{mod.name}:{fn.name}.{name}"
            return None
        if lockish:
            # obj.attr chains: last two segments as identity
            d = dotted(expr)
            if d:
                parts = d.split(".")
                return ".".join(parts[-2:])
            return name
        return None

    # -- call resolution --------------------------------------------------

    def find_module(self, name: str) -> Optional[ModuleInfo]:
        """Exact dotted match, else unique suffix match ('dispatcher'
        finds ratelimit_tpu_torch.backends.dispatcher)."""
        m = self.modules.get(name)
        if m is not None:
            return m
        tail = "." + name
        hits = [m for n, m in self.modules.items() if n.endswith(tail)]
        return hits[0] if len(hits) == 1 else None

    def _resolve_class_name(
        self, mod: ModuleInfo, name: str
    ) -> Optional[ClassInfo]:
        if name in mod.classes:
            return mod.classes[name]
        imp = mod.imports.get(name)
        if imp is not None and imp[0] == "symbol":
            target = self.find_module(imp[1])
            if target is not None and imp[2] in target.classes:
                return target.classes[imp[2]]
        hits = self.classes_by_name.get(name, ())
        return hits[0] if len(hits) == 1 else None

    def _resolve_class_ref(
        self, mod: ModuleInfo, func: ast.AST
    ) -> Optional[ClassInfo]:
        """ClassInfo for a constructor-call callee expression."""
        if isinstance(func, ast.Name):
            return self._resolve_class_name(mod, func.id)
        if isinstance(func, ast.Attribute) and isinstance(
            func.value, ast.Name
        ):
            imp = mod.imports.get(func.value.id)
            if imp is not None and imp[0] == "module":
                target = self.find_module(imp[1])
                if target is not None:
                    return target.classes.get(func.attr)
        return None

    def class_of(self, qualname: str) -> Optional[ClassInfo]:
        mod_name, _, cls = qualname.partition(":")
        mod = self.modules.get(mod_name)
        return mod.classes.get(cls) if mod else None

    def _method_with_bases(
        self, ci: ClassInfo, name: str, _seen=None
    ) -> Optional[FunctionInfo]:
        if name in ci.methods:
            return ci.methods[name]
        _seen = _seen or set()
        if ci.qualname in _seen:
            return None
        _seen.add(ci.qualname)
        for base in ci.bases:
            base_ci = self._resolve_class_name(ci.module, base.split(".")[-1])
            if base_ci is not None:
                hit = self._method_with_bases(base_ci, name, _seen)
                if hit is not None:
                    return hit
        return None

    def resolve_callable(
        self, fn: FunctionInfo, expr: ast.AST
    ) -> Optional[FunctionInfo]:
        """Resolve a callable REFERENCE (call target or Thread target)
        to a project FunctionInfo; None when not credibly known."""
        mod = fn.module
        if isinstance(expr, ast.Name):
            n = expr.id
            # enclosing-function local defs, innermost first
            scope = fn
            while scope is not None:
                if n in scope.local_fns:
                    return scope.local_fns[n]
                scope = scope.parent
            if n in mod.functions:
                return mod.functions[n]
            imp = mod.imports.get(n)
            if imp is not None and imp[0] == "symbol":
                target = self.find_module(imp[1])
                if target is not None:
                    if imp[2] in target.functions:
                        return target.functions[imp[2]]
                    if imp[2] in target.classes:
                        return target.classes[imp[2]].methods.get("__init__")
            ci = self._resolve_class_name(mod, n)
            if ci is not None and n in mod.classes or (
                ci is not None and mod.imports.get(n)
            ):
                return ci.methods.get("__init__") if ci else None
            return None
        if not isinstance(expr, ast.Attribute):
            return None
        base, meth = expr.value, expr.attr
        # self.m()
        if isinstance(base, ast.Name) and base.id == "self" and fn.cls:
            ci = mod.classes.get(fn.cls)
            if ci is not None:
                hit = self._method_with_bases(ci, meth)
                if hit is not None:
                    return hit
            return None
        # imported_module.f()
        if isinstance(base, ast.Name):
            imp = mod.imports.get(base.id)
            if imp is not None and imp[0] == "module":
                target = self.find_module(imp[1])
                if target is not None:
                    if meth in target.functions:
                        return target.functions[meth]
                    if meth in target.classes:
                        return target.classes[meth].methods.get("__init__")
                return None
        # self._attr.m() with a typed attribute
        if (
            isinstance(base, ast.Attribute)
            and isinstance(base.value, ast.Name)
            and base.value.id == "self"
            and fn.cls
        ):
            ci = mod.classes.get(fn.cls)
            if ci is not None:
                tq = ci.attr_types.get(base.attr)
                if tq is not None:
                    target_ci = self.class_of(tq)
                    if target_ci is not None:
                        return self._method_with_bases(target_ci, meth)
        # unique-method-name fallback (stoplisted)
        if meth not in UBIQUITOUS_METHODS:
            hits = self.methods_by_name.get(meth, ())
            if len(hits) == 1:
                return hits[0]
        return None

    #: Ambiguity cap for escape-graph candidates: beyond this many
    #: same-named methods the name carries no signal.
    MAX_CANDIDATES = 4

    def _link_calls(self, fn: FunctionInfo) -> None:
        for cs in fn.call_sites:
            cs.callee = self.resolve_callable(fn, cs.node.func)
            if cs.callee is None and isinstance(
                cs.node.func, ast.Attribute
            ):
                meth = cs.node.func.attr
                if meth not in UBIQUITOUS_METHODS:
                    hits = self.methods_by_name.get(meth, ())
                    if 2 <= len(hits) <= self.MAX_CANDIDATES:
                        cs.candidates = tuple(hits)

    def _register_closure_attrs(self, mod: ModuleInfo) -> None:
        """``self.record = self._make_record()`` in __init__, where
        the factory method RETURNS one of its local defs, publishes
        that closure as a callable attribute: register it as a method
        so ``obj.record(...)`` resolves (the flight recorder's hot-
        path pattern)."""
        for ci in mod.classes.values():
            init = ci.methods.get("__init__")
            if init is None:
                continue
            for node in ast.walk(init.node):
                if not (
                    isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Attribute)
                    and isinstance(node.targets[0].value, ast.Name)
                    and node.targets[0].value.id == "self"
                    and isinstance(node.value, ast.Call)
                    and isinstance(node.value.func, ast.Attribute)
                    and isinstance(node.value.func.value, ast.Name)
                    and node.value.func.value.id == "self"
                ):
                    continue
                attr = node.targets[0].attr
                factory = ci.methods.get(node.value.func.attr)
                if factory is None or attr in ci.methods:
                    continue
                closure = _returned_local_closure(factory)
                if closure is not None:
                    ci.methods[attr] = closure
                    self.methods_by_name.setdefault(attr, []).append(
                        closure
                    )

    def _link_escapes(self, fn: FunctionInfo) -> None:
        """Escape-only edges: value-referenced self-methods (captured
        into closures/callbacks) and nested defs (which escape by
        construction unless they are only ever called in place).
        These feed the ESCAPE reachability graph used for thread-
        context labeling; the lock/blocking closures ignore them."""
        if fn.cls is not None:
            ci = fn.module.classes.get(fn.cls)
            if ci is not None:
                for name in fn.value_refs:
                    if name in fn.thread_target_refs:
                        continue
                    m = ci.methods.get(name)
                    if m is not None and m is not fn:
                        fn.extra_callees.append(m)
        for nested in fn.local_fns.values():
            fn.extra_callees.append(nested)
        # a closure inherits its factory's captured self-method refs
        # (its body calls them through bare captured names)
        parent = fn.parent
        if parent is not None and parent.cls is not None:
            ci = parent.module.classes.get(parent.cls)
            if ci is not None:
                for name in parent.value_refs:
                    if name in parent.thread_target_refs:
                        continue
                    m = ci.methods.get(name)
                    if m is not None and m is not fn:
                        fn.extra_callees.append(m)

    # -- thread roots -----------------------------------------------------

    _THREAD_CTORS = {"threading.Thread", "Thread"}
    _TIMER_CTORS = {"threading.Timer", "Timer"}

    def _discover_thread_roots(self, mod: ModuleInfo) -> None:
        # Walk every call in the module (inside or outside functions);
        # attribute the site to the enclosing function for resolution
        # scope (nested `loop` functions resolve via local_fns).
        for fn in list(_iter_functions(mod)):
            for cs in fn.call_sites:
                self._maybe_thread_root(mod, fn, cs.node)

    def _maybe_thread_root(
        self, mod: ModuleInfo, fn: FunctionInfo, call: ast.Call
    ) -> None:
        callee = dotted(call.func)
        target_expr = None
        if callee in self._THREAD_CTORS:
            for kw in call.keywords:
                if kw.arg == "target":
                    target_expr = kw.value
        elif callee in self._TIMER_CTORS and len(call.args) >= 2:
            target_expr = call.args[1]
        if target_expr is None:
            return
        target = self.resolve_callable(fn, target_expr)
        if target is None:
            return
        self.thread_roots.append(
            ThreadRoot(
                label=f"{target.qualname} @ {mod.path}:{call.lineno}",
                fn=target,
                path=mod.path,
                line=call.lineno,
            )
        )

    # -- graph queries -----------------------------------------------------

    def callees(
        self, fn: FunctionInfo, escapes: bool = False
    ) -> List[FunctionInfo]:
        out = [cs.callee for cs in fn.call_sites if cs.callee is not None]
        if escapes:
            out.extend(fn.extra_callees)
            for cs in fn.call_sites:
                out.extend(cs.candidates)
        return out

    def reachable(
        self, fn: FunctionInfo, escapes: bool = False
    ) -> Set[FunctionInfo]:
        """Functions reachable from `fn` (inclusive), memoized.  With
        ``escapes`` the walk also follows value-escape edges (captured
        methods, nested defs) — the right graph for thread-context
        labeling, but NOT for lock/blocking analysis (a reference is
        not a call under the referencing scope's locks)."""
        memo = self._reach_memo.get((fn, escapes))
        if memo is not None:
            return memo
        seen: Set[FunctionInfo] = set()
        stack = [fn]
        while stack:
            f = stack.pop()
            if f in seen:
                continue
            seen.add(f)
            stack.extend(
                c for c in self.callees(f, escapes) if c not in seen
            )
        self._reach_memo[(fn, escapes)] = seen
        return seen

    def entry_functions(self) -> List[FunctionInfo]:
        """Functions with no resolved in-project callers and not
        discovered as thread targets: the approximation of 'called
        from outside' (RPC handlers, public API, CLI mains)."""
        called: Set[FunctionInfo] = set()
        for fn in self.functions.values():
            for c in self.callees(fn, escapes=True):
                called.add(c)
        rooted = {r.fn for r in self.thread_roots}
        return [
            fn
            for fn in self.functions.values()
            if fn not in called and fn not in rooted
        ]


def _iter_functions(mod: ModuleInfo):
    """All FunctionInfos of a module: top-level, methods, nested.
    Nested functions are registered lazily during body indexing, so
    iterate a snapshot-then-extend worklist."""
    seen: List[FunctionInfo] = list(mod.functions.values())
    for ci in mod.classes.values():
        seen.extend(ci.methods.values())
    i = 0
    emitted = set()
    while i < len(seen):
        fn = seen[i]
        i += 1
        if fn.qualname in emitted:
            continue
        emitted.add(fn.qualname)
        yield fn
        seen.extend(fn.local_fns.values())


def _returned_local_closure(factory: FunctionInfo) -> Optional[FunctionInfo]:
    """The local def a factory method returns, if any (``def _make_x:
    def x(...): ...; return x``)."""
    for node in ast.walk(factory.node):
        if (
            isinstance(node, ast.Return)
            and isinstance(node.value, ast.Name)
            and node.value.id in factory.local_fns
        ):
            return factory.local_fns[node.value.id]
    return None


def _annotation_class(ann: Optional[ast.AST]) -> Optional[str]:
    """Class name from a simple annotation: X, "X", Optional[X]."""
    if ann is None:
        return None
    if isinstance(ann, ast.Name):
        return ann.id
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        return ann.value.split(".")[-1] or None
    if isinstance(ann, ast.Subscript):
        # Optional[X] / Union[X, None] — take the first Name inside
        for node in ast.walk(ann.slice):
            if isinstance(node, ast.Name) and node.id not in (
                "Optional",
                "Union",
                "None",
            ):
                return node.id
    return None


# ---------------------------------------------------------------------------
# module naming
# ---------------------------------------------------------------------------


def module_name_for(path: str) -> str:
    """Dotted module name: walk up while __init__.py exists, so
    'ratelimit_tpu_torch/backends/dispatcher.py' names
    'ratelimit_tpu_torch.backends.dispatcher'.  Files outside a package
    (fixtures) use their stem, qualified by their directory to keep
    sibling fixture dirs distinct."""
    from pathlib import Path

    p = Path(path)
    parts = [p.stem] if p.stem != "__init__" else []
    parent = p.parent
    while (parent / "__init__.py").exists():
        parts.insert(0, parent.name)
        parent = parent.parent
    if not parts:
        parts = [p.stem]
    return ".".join(parts)


class ProjectRule:
    """Base class for whole-program rules (analysis/concurrency.py,
    analysis/contracts.py).  Unlike file :class:`~.engine.Rule`,
    a project rule sees the finished :class:`ProjectIndex` once."""

    id: str = ""
    description: str = ""

    def check_project(self, index: ProjectIndex) -> List["Finding"]:
        raise NotImplementedError  # pragma: no cover


from .engine import Finding  # noqa: E402  (cycle-free: engine has no project imports)
