"""The tpu-lint rule pack of the PyTorch/CUDA port.

Each rule targets a bug class that has no runtime guard in this repo.
Per-file rules (DEFAULT_RULES):

- lock-discipline:    blocking calls under a held lock; attributes
                      mutated both inside and outside lock scopes.
- env-discipline:     os.environ reads outside settings.py / config/.
- torch-dtype-discipline: tensor factories without dtype= and bare
                      literals in scatters, in kernel code.
- timing-discipline:  wall clock (time.time / datetime.now/utcnow)
                      in duration arithmetic.
- metrics-discipline: interpolated (unbounded-cardinality) metric
                      names in stats registrations.

Whole-program rules (DEFAULT_PROJECT_RULES): the concurrency rules
(concurrency.py), dtype-pack-contract (contracts.py),
native-abi-contract (native_abi.py), hot-path-cost (hotpath.py) and
torch-host-sync (below: it needs the call graph's reachability from
the request path).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .engine import FileContext, Finding, Rule
from .project import FunctionInfo, ProjectIndex, ProjectRule

# ---------------------------------------------------------------------------
# shared AST helpers
# ---------------------------------------------------------------------------


def dotted_name(node: ast.AST) -> Optional[str]:
    """'torch.cuda.synchronize' for Attribute/Name chains, else None."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted_name(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


def terminal_name(node: ast.AST) -> Optional[str]:
    """The last identifier of a Name/Attribute chain ('_completion_q'
    for `self._completion_q`)."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


# ---------------------------------------------------------------------------
# torch-host-sync
# ---------------------------------------------------------------------------

#: Callees that wait for the card from the host.
_SYNC_CALLEES = {
    "torch.cuda.synchronize": "torch.cuda.synchronize() waits for every "
    "stream on the card",
}

#: Constructors of objects whose `.synchronize()` blocks the host.
_WAITABLE_CTORS = {
    "torch.cuda.current_stream",
    "torch.cuda.default_stream",
    "torch.cuda.Stream",
    "torch.cuda.Event",
}

#: Terminal-name fragments of a receiver that is a CUDA event or stream.
_WAITABLE_FRAGMENTS = ("event", "stream")


def _torch_call(node: ast.AST) -> bool:
    """A call of a ``torch.*`` function (``torch.zeros(...)``) that may
    make a device tensor: one asked for pinned memory
    (``pin_memory=...``) or for ``device="cpu"`` lives on the host."""
    if not (
        isinstance(node, ast.Call)
        and (dotted_name(node.func) or "").startswith("torch.")
    ):
        return False
    for kw in node.keywords:
        if kw.arg == "pin_memory":
            return False
        if (
            kw.arg == "device"
            and isinstance(kw.value, ast.Constant)
            and kw.value.value == "cpu"
        ):
            return False
    return True


class _TensorTies:
    """Which expressions the AST can tie to a torch tensor: a
    ``torch.*`` call, a method call / subscript / arithmetic on a tied
    expression, a local name bound from one, or a ``self.X`` attribute
    some method of the class binds from one.  Under-approximate on
    purpose: numpy's ``.tolist()`` is everywhere in the host code, and
    a false positive there costs more than a missed sync."""

    def __init__(self, locals_: Set[str], attrs: Set[str]):
        self.locals = locals_
        self.attrs = attrs

    def tied(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Call):
            if _torch_call(node):
                return True
            f = node.func
            return isinstance(f, ast.Attribute) and self.tied(f.value)
        if isinstance(node, ast.Subscript):
            return self.tied(node.value)
        if isinstance(node, ast.BinOp):
            return self.tied(node.left) or self.tied(node.right)
        if isinstance(node, ast.Name):
            return node.id in self.locals
        if isinstance(node, ast.Attribute):
            if isinstance(node.value, ast.Name) and node.value.id == "self":
                return node.attr in self.attrs
            return self.tied(node.value)
        return False


def _own_nodes(fn_node: ast.AST):
    """Every node of a function's own body (nested defs excluded: they
    are functions of their own in the call graph)."""
    stack = list(fn_node.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _tied_locals(fn_node: ast.AST, attrs: Set[str]) -> Set[str]:
    """Local names bound (anywhere in the body) from a tied expression;
    two passes let a name bound from another tied name settle."""
    names: Set[str] = set()
    assigns = [n for n in _own_nodes(fn_node) if isinstance(n, ast.Assign)]
    for _ in range(2):
        ties = _TensorTies(names, attrs)
        for node in assigns:
            if ties.tied(node.value):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        names.add(t.id)
    return names


def _waitable_locals(fn_node: ast.AST) -> Set[str]:
    """Local names bound from a CUDA event or stream constructor."""
    names: Set[str] = set()
    for node in _own_nodes(fn_node):
        if (
            isinstance(node, ast.Assign)
            and isinstance(node.value, ast.Call)
            and dotted_name(node.value.func) in _WAITABLE_CTORS
        ):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
    return names


def _tensor_attrs(ci) -> Set[str]:
    """``self.X`` attributes some method of the class binds from a
    tensor-tied expression (``self._counts = torch.zeros(...)``)."""
    out: Set[str] = set()
    if ci is None:
        return out
    for _ in range(2):
        for m in ci.methods.values():
            ties = _TensorTies(_tied_locals(m.node, out), out)
            for node in _own_nodes(m.node):
                if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                    continue
                if node.value is None or not ties.tied(node.value):
                    continue
                targets = (
                    node.targets
                    if isinstance(node, ast.Assign)
                    else [node.target]
                )
                for t in targets:
                    if (
                        isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"
                    ):
                        out.add(t.attr)
    return out


class TorchHostSyncRule(ProjectRule):
    """Host synchronization with the card on the request path.

    Every RPC of the port waits on one device batch; a ``.item()``,
    ``.cpu()``, ``torch.cuda.synchronize()``, or a stream's or event's
    ``.synchronize()`` reached from a request-path root turns the
    pipelined submit/complete split into a full device round trip per
    call and stalls everything queued behind it (the reason the served
    chunk reads back into pinned memory and only the completer waits on
    the launch's event).  The twin of the JAX package's
    ``jax-host-sync``, with reachability from the hot-path roots
    (hotpath.HOT_PATH_ROOTS) in place of jit scopes, since torch has no
    trace boundary to find.

    ``.tolist()`` / ``.numpy()`` are flagged only on a receiver the AST
    can tie to a torch tensor (see :class:`_TensorTies`).  A deliberate
    wait (the completer's event wait) carries a justified
    ``# tpu-lint: disable=torch-host-sync -- why``.
    """

    id = "torch-host-sync"
    description = "host synchronization with the card on the request path"

    _ALWAYS_METHODS = {
        "item": ".item() copies one element to the host and waits for "
        "the card",
        "cpu": ".cpu() copies device->host and waits for the card",
    }
    _TIED_METHODS = {
        "tolist": ".tolist() on a tensor copies device->host and waits",
        "numpy": ".numpy() on a tensor needs a host tensor (an implied "
        "device->host copy)",
    }

    def check_project(self, index: ProjectIndex) -> List[Finding]:
        from .hotpath import HOT_PATH_ROOTS

        roots = [
            fn
            for fn in index.functions.values()
            if fn.name in HOT_PATH_ROOTS
        ]
        # The may-call graph (escape and candidate edges included): the
        # dispatcher reaches its engine through an untyped parameter
        # (`engine.step_complete(token)`), which only the candidate
        # edges of a few same-named methods resolve.
        reach: Dict[FunctionInfo, str] = {}
        for root in sorted(roots, key=lambda f: f.qualname):
            for fn in index.reachable(root, escapes=True):
                reach.setdefault(fn, root.qualname)
        attrs_by_class: Dict[Tuple[str, str], Set[str]] = {}
        findings: List[Finding] = []
        for fn in sorted(reach, key=lambda f: (f.module.path, f.qualname)):
            attrs: Set[str] = set()
            if fn.cls is not None:
                key = (fn.module.name, fn.cls)
                if key not in attrs_by_class:
                    attrs_by_class[key] = _tensor_attrs(
                        fn.module.classes.get(fn.cls)
                    )
                attrs = attrs_by_class[key]
            for node, what in self._scan(fn, attrs):
                findings.append(
                    Finding(
                        rule_id=self.id,
                        path=fn.module.path,
                        line=node.lineno,
                        col=node.col_offset,
                        message=(
                            f"{what} [in {fn.qualname}, reachable from "
                            f"{reach[fn]}]"
                        ),
                    )
                )
        return findings

    def _scan(self, fn: FunctionInfo, attrs: Set[str]):
        ties = _TensorTies(_tied_locals(fn.node, attrs), attrs)
        waitables = _waitable_locals(fn.node)
        for node in _own_nodes(fn.node):
            if not isinstance(node, ast.Call):
                continue
            callee = dotted_name(node.func)
            if callee in _SYNC_CALLEES:
                yield node, _SYNC_CALLEES[callee]
                continue
            if not isinstance(node.func, ast.Attribute):
                continue
            meth, recv = node.func.attr, node.func.value
            if meth in self._ALWAYS_METHODS and not node.args:
                yield node, self._ALWAYS_METHODS[meth]
            elif meth in self._TIED_METHODS and ties.tied(recv):
                yield node, self._TIED_METHODS[meth]
            elif (
                meth == "synchronize"
                and not node.args
                and self._waitable(recv, waitables)
            ):
                name = (
                    f"{dotted_name(recv.func)}()"
                    if isinstance(recv, ast.Call)
                    else dotted_name(recv)
                )
                yield node, (
                    f"{name or 'a stream'}.synchronize() blocks the host "
                    "until the card catches up"
                )

    @staticmethod
    def _waitable(recv: ast.AST, waitables: Set[str]) -> bool:
        if isinstance(recv, ast.Call):
            return dotted_name(recv.func) in _WAITABLE_CTORS
        if isinstance(recv, ast.Name) and recv.id in waitables:
            return True
        name = (terminal_name(recv) or "").lower()
        return any(f in name for f in _WAITABLE_FRAGMENTS)

# ---------------------------------------------------------------------------
# lock-discipline
# ---------------------------------------------------------------------------

# Terminal-name fragments that identify a synchronization primitive in
# a `with X:` context expression.
_LOCKISH_FRAGMENTS = ("lock", "mutex", "_cv", "cond")


def _lockish(node: ast.AST) -> Optional[str]:
    """Lock identity string if `node` looks like a lock object."""
    name = terminal_name(node)
    if name is None:
        return None
    low = name.lower()
    if any(f in low for f in _LOCKISH_FRAGMENTS) or low == "cv":
        return dotted_name(node) or name
    return None


class LockDisciplineRule(Rule):
    """Race/deadlock discipline in the threaded backends.

    Two checks (the poor man's `go vet` + race detector for
    write_behind/dispatcher/cluster code):

    1. BLOCKING CALLS UNDER A LOCK: `time.sleep`, socket/grpc I/O,
       `queue.get()` with no timeout, and untimed `.wait()` on a
       DIFFERENT object than the held lock, inside a `with <lock>:`
       block.  Every RPC thread contending on that lock stalls behind
       the sleeper (the whole reason the dispatcher's intake is a
       one-swap list, dispatcher.py).

    2. SPLIT-LOCK ATTRIBUTE MUTATION: a `self.X` assigned both inside
       and outside `with <lock>:` scopes in the same class (outside
       ``__init__``, whose writes happen-before thread start) is a
       data-race smell: either the lock is unnecessary or the unlocked
       write races it.

    Lock scopes are recognized by terminal name: `with self._view_lock:`,
    `with cv:`, names containing lock/mutex/cond/_cv.
    """

    id = "lock-discipline"
    description = "blocking call or unlocked mutation under lock discipline"
    interests = ()

    _BLOCKING_METHODS = {
        "recv",
        "recvfrom",
        "sendall",
        "connect",
        "accept",
    }
    _QUEUEISH = ("queue", "_q")

    def begin_file(self, ctx: FileContext) -> None:
        # (class name, attr) -> {"locked": node|None, "unlocked": node|None}
        self._attr_writes: Dict[Tuple[str, str], Dict[str, ast.AST]] = {}

    # -- helpers ---------------------------------------------------------

    def _held_locks(self, parents: Sequence[ast.AST]) -> List[str]:
        held: List[str] = []
        for p in parents:
            if isinstance(p, ast.With):
                for item in p.items:
                    lock = _lockish(item.context_expr)
                    if lock is not None:
                        held.append(lock)
        return held

    @staticmethod
    def _has_timeout(node: ast.Call) -> bool:
        if any(kw.arg in ("timeout", "timeout_s") for kw in node.keywords):
            return True
        # queue.get(block, timeout) / lock.acquire(blocking, timeout):
        # a second positional arg is the timeout.
        return len(node.args) >= 2

    def _enclosing(
        self, parents: Sequence[ast.AST]
    ) -> Tuple[Optional[str], Optional[str]]:
        """(enclosing class name, enclosing function name)."""
        cls = fn = None
        for p in parents:
            if isinstance(p, ast.ClassDef):
                cls, fn = p.name, None
            elif isinstance(p, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fn = p.name
        return cls, fn

    # -- dispatch --------------------------------------------------------

    def visit(self, node, parents, ctx: FileContext) -> None:
        if isinstance(node, ast.Call):
            self._check_blocking(node, parents, ctx)
        elif isinstance(node, (ast.Assign, ast.AugAssign)):
            self._track_attr_write(node, parents)

    def _check_blocking(
        self, node: ast.Call, parents: Sequence[ast.AST], ctx: FileContext
    ) -> None:
        held = self._held_locks(parents)
        if not held:
            return
        callee = dotted_name(node.func)
        if callee == "time.sleep":
            self.report(
                ctx,
                node,
                f"time.sleep() while holding {held[-1]} stalls every "
                "thread contending on the lock",
            )
            return
        if not isinstance(node.func, ast.Attribute):
            return
        meth = node.func.attr
        recv = node.func.value
        recv_name = (terminal_name(recv) or "").lower()
        if meth in self._BLOCKING_METHODS:
            self.report(
                ctx,
                node,
                f"blocking I/O .{meth}() while holding {held[-1]}",
            )
        elif meth == "get" and not self._has_timeout(node):
            if any(
                recv_name == q or recv_name.endswith(q)
                for q in self._QUEUEISH
            ):
                self.report(
                    ctx,
                    node,
                    f"untimed {recv_name}.get() while holding "
                    f"{held[-1]} can block the lock forever",
                )
        elif meth == "wait" and not node.args and not node.keywords:
            # cv.wait() releases the cv's OWN lock — only waiting on a
            # different object while holding the lock is a deadlock.
            waited = dotted_name(recv) or recv_name
            if waited not in held:
                self.report(
                    ctx,
                    node,
                    f"untimed {waited}.wait() while holding {held[-1]} "
                    "(not the waited object) risks deadlock",
                )

    def _track_attr_write(
        self, node, parents: Sequence[ast.AST]
    ) -> None:
        cls, fn = self._enclosing(parents)
        if cls is None or fn is None or fn in ("__init__", "__post_init__"):
            return  # module-level or constructor writes happen-before
        targets = (
            node.targets if isinstance(node, ast.Assign) else [node.target]
        )
        in_lock = bool(self._held_locks(parents))
        for t in targets:
            if (
                isinstance(t, ast.Attribute)
                and isinstance(t.value, ast.Name)
                and t.value.id == "self"
            ):
                slot = self._attr_writes.setdefault(
                    (cls, t.attr), {"locked": None, "unlocked": None}
                )
                key = "locked" if in_lock else "unlocked"
                if slot[key] is None:
                    slot[key] = node

    def end_file(self, ctx: FileContext) -> None:
        for (cls, attr), slot in self._attr_writes.items():
            if slot["locked"] is not None and slot["unlocked"] is not None:
                self.report(
                    ctx,
                    slot["unlocked"],
                    f"{cls}.{attr} is written under a lock elsewhere "
                    f"(line {slot['locked'].lineno}) but without one "
                    "here — racy unless single-threaded by design",
                )


# ---------------------------------------------------------------------------
# env-discipline
# ---------------------------------------------------------------------------


class EnvDisciplineRule(Rule):
    """All environment reads belong in settings.py / config/.

    The reference's settings.go is the single place env vars become
    config (envconfig tags); scattering `os.environ` reads breaks the
    settings_reloader seam (runner.py re-reads settings on config
    reload — an env read elsewhere silently ignores reloads) and hides
    knobs from docs/SETTINGS parity audits.
    """

    id = "env-discipline"
    description = "os.environ read outside settings.py / config/"
    interests = (ast.Attribute, ast.Call)

    _ALLOWED_FRAGMENTS = ("settings.py", "/config/")

    def begin_file(self, ctx: FileContext) -> None:
        path = ctx.path.replace("\\", "/")
        self._exempt = any(f in path for f in self._ALLOWED_FRAGMENTS)
        self._reported_lines: Set[int] = set()

    def visit(self, node, parents, ctx: FileContext) -> None:
        if self._exempt:
            return
        hit = None
        if isinstance(node, ast.Attribute):
            if dotted_name(node) == "os.environ":
                hit = "os.environ"
        elif isinstance(node, ast.Call):
            if dotted_name(node.func) == "os.getenv":
                hit = "os.getenv"
        if hit and node.lineno not in self._reported_lines:
            self._reported_lines.add(node.lineno)
            self.report(
                ctx,
                node,
                f"{hit} outside settings.py/config/ bypasses the "
                "settings_reloader seam; add a Settings field instead",
            )


# ---------------------------------------------------------------------------
# torch-dtype-discipline
# ---------------------------------------------------------------------------


class TorchDtypeDisciplineRule(Rule):
    """Implicit dtypes in kernel code: tensor factories without an
    explicit ``dtype=`` and scatters of a bare Python number.

    Torch's defaults are int64 for integer data and float32 for the
    rest.  The port keeps counters as u32 bit patterns in int32 tensors
    (ops/u32.py narrows every value explicitly); a ``torch.tensor(...)``
    or ``torch.arange(...)`` without a dtype silently widens one side of
    a mixed expression to int64, doubles its transfer width and moves
    wraparound from mod 2^32 to mod 2^64 -- and only where that path
    runs.  A scatter (``index_put_`` / ``index_add_`` / ``scatter_`` /
    ``scatter_add_``) whose value is a bare literal leaves the value's
    dtype to torch's promotion rules instead of the table's.  The twin
    of the JAX package's ``dtype-discipline``.

    Scoped to the kernel packages (ops/, models/, parallel/) where
    tables have non-default dtypes; host code is not scanned.
    """

    id = "torch-dtype-discipline"
    description = (
        "tensor factory without dtype= or bare literal in a scatter "
        "in kernel code"
    )
    interests = (ast.Call,)

    _FACTORIES = {
        "torch.tensor",
        "torch.arange",
        "torch.zeros",
        "torch.full",
        "torch.empty",
    }
    #: scatter method -> (positional index of its value, value keywords)
    _SCATTERS = {
        "index_put_": (1, ("values",)),
        "index_add_": (2, ("source",)),
        "scatter_": (2, ("src", "value")),
        "scatter_add_": (2, ("src",)),
    }
    _SCOPE_FRAGMENTS = ("/ops/", "/models/", "/parallel/")

    def begin_file(self, ctx: FileContext) -> None:
        path = ctx.path.replace("\\", "/")
        self._in_scope = any(f in path for f in self._SCOPE_FRAGMENTS)

    @staticmethod
    def _is_bare_number(node: ast.AST) -> bool:
        if isinstance(node, ast.Constant):
            return isinstance(node.value, (int, float)) and not isinstance(
                node.value, bool
            )
        if isinstance(node, ast.UnaryOp) and isinstance(
            node.op, (ast.USub, ast.UAdd)
        ):
            return TorchDtypeDisciplineRule._is_bare_number(node.operand)
        return False

    def visit(self, node, parents, ctx: FileContext) -> None:
        if not self._in_scope:
            return
        callee = dotted_name(node.func)
        if callee in self._FACTORIES:
            # `**kw` may carry the dtype: the AST cannot tell.
            if not any(kw.arg in ("dtype", None) for kw in node.keywords):
                self.report(
                    ctx,
                    node,
                    f"{callee}() without dtype= takes torch's default "
                    "(int64 / float32) and widens the u32-as-int32 "
                    "state implicitly; pass dtype= explicitly",
                )
            return
        f = node.func
        if not (isinstance(f, ast.Attribute) and f.attr in self._SCATTERS):
            return
        pos, kws = self._SCATTERS[f.attr]
        value = node.args[pos] if len(node.args) > pos else None
        for kw in node.keywords:
            if kw.arg in kws:
                value = kw.value
        if value is not None and self._is_bare_number(value):
            self.report(
                ctx,
                node,
                f".{f.attr}() with a bare numeric literal leaves the "
                "value's dtype to torch's promotion rules; pass a "
                "tensor of the table's dtype",
            )

# ---------------------------------------------------------------------------
# metrics-discipline
# ---------------------------------------------------------------------------


class MetricsDisciplineRule(Rule):
    """F-string-interpolated metric names: the unbounded-cardinality
    guard.

    A ``store.counter(f"...{key}...")`` mints one Counter object and
    one /metrics family PER DISTINCT VALUE of the interpolated
    expression — a per-user or per-descriptor value there grows the
    registry (and every scrape, and every statsd flush) without
    bound.  Metric names must come from a bounded set: string
    literals, ``base + ".suffix"`` over a bounded base, or the
    sanctioned interning seams (stats/manager.py's per-rule scope
    classes, which the config loader bounds), which are exempted by
    path.  Traffic-shape questions ("which key is hot?") belong to
    the hot-key sketch (observability/hotkeys.py), whose memory is
    bounded by construction.

    Flags direct f-string (and ``str.format``/percent-format)
    arguments to the StatsStore registration methods on a
    store-looking receiver.  Bounded interpolations (e.g. a lane
    index) should bind the scope to a name first — that keeps the
    bounded part visibly separate from the registration call — or
    carry a justified suppression.
    """

    id = "metrics-discipline"
    description = "interpolated metric name in a stats registration"
    interests = (ast.Call,)

    _REG_METHODS = {
        "counter",
        "gauge",
        "timer",
        "histogram",
        "counter_fn",
        "gauge_fn",
    }
    _ALLOWED_FRAGMENTS = ("stats/manager.py",)

    def begin_file(self, ctx: FileContext) -> None:
        path = ctx.path.replace("\\", "/")
        self._exempt = any(f in path for f in self._ALLOWED_FRAGMENTS)

    @staticmethod
    def _is_storeish(node: ast.AST) -> bool:
        name = terminal_name(node)
        return name is not None and name.lower().endswith("store")

    @staticmethod
    def _interpolation_kind(node: ast.AST) -> Optional[str]:
        """'f-string' / '.format()' / '%-format' when `node` builds a
        string by interpolation, else None."""
        if isinstance(node, ast.JoinedStr) and any(
            isinstance(v, ast.FormattedValue) for v in node.values
        ):
            return "f-string"
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "format"
            and isinstance(node.func.value, (ast.Constant, ast.JoinedStr))
        ):
            return ".format()"
        if (
            isinstance(node, ast.BinOp)
            and isinstance(node.op, ast.Mod)
            and isinstance(node.left, ast.Constant)
            and isinstance(node.left.value, str)
        ):
            return "%-format"
        return None

    def visit(self, node, parents, ctx: FileContext) -> None:
        if self._exempt:
            return
        f = node.func
        if not (
            isinstance(f, ast.Attribute)
            and f.attr in self._REG_METHODS
            and self._is_storeish(f.value)
        ):
            return
        if not node.args:
            return
        kind = self._interpolation_kind(node.args[0])
        if kind is not None:
            self.report(
                ctx,
                node,
                f"{kind} metric name in store.{f.attr}() mints one "
                "metric per interpolated value (unbounded "
                "cardinality); use a literal/bounded name, or the "
                "hot-key sketch for per-key questions",
            )


# ---------------------------------------------------------------------------
# timing-discipline
# ---------------------------------------------------------------------------


class TimingDisciplineRule(Rule):
    """Wall-clock reads in duration arithmetic.

    The wall clock is not monotonic: NTP slews/steps and manual sets
    make ``time.time() - t0`` go negative or jump hours — precisely
    the failure class the per-phase latency histograms, trace spans
    and anomaly detectors exist to measure honestly (observability/).
    Durations belong to ``time.perf_counter()`` / ``time.monotonic()``
    (or the injectable MonotonicClock seam, utils/time.py); wall clock
    is for TIMESTAMPS (logging, persistence, cross-process stamps).

    Flags a subtraction where either operand is a direct wall-clock
    call — ``time.time()``, ``datetime.now()``, ``datetime.utcnow()``
    (either import style) — or a name bound from one in the same
    function (or module) scope.  Additions and comparisons are
    untouched — storing or displaying wall stamps is fine.
    """

    id = "timing-discipline"
    description = "wall clock (time.time/datetime.now) in duration arithmetic"
    interests = (ast.BinOp,)

    def begin_file(self, ctx: FileContext) -> None:
        self._wall_callees = {
            "time.time",
            # `import datetime` style; datetime.now(tz) with an aware
            # tz still steps under NTP — the tz argument changes the
            # epoch, not the clock.
            "datetime.datetime.now",
            "datetime.datetime.utcnow",
        }
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ImportFrom):
                continue
            # `from time import time` makes the bare call wall-clock.
            if node.module == "time":
                if any(a.name == "time" for a in node.names):
                    self._wall_callees.add("time")
            # `from datetime import datetime [as dt]` makes
            # `datetime.now()` / `dt.utcnow()` wall-clock too.
            elif node.module == "datetime":
                for a in node.names:
                    if a.name == "datetime":
                        bound = a.asname or a.name
                        self._wall_callees.add(bound + ".now")
                        self._wall_callees.add(bound + ".utcnow")
        # scope node (FunctionDef or the Module) -> names bound from a
        # wall-clock call within it.
        self._wall_names: Dict[Optional[ast.AST], Set[str]] = {}
        self._collect_wall_names(ctx.tree)

    def _is_wall_call(self, node: ast.AST) -> bool:
        return (
            isinstance(node, ast.Call)
            and dotted_name(node.func) in self._wall_callees
        )

    def _collect_wall_names(self, tree: ast.Module) -> None:
        def scan(scope: ast.AST, body) -> None:
            # Walk WITHOUT descending into nested function defs: their
            # assignments belong to their own scope entry.
            names: Set[str] = set()
            stack = list(body)
            while stack:
                node = stack.pop()
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                if isinstance(node, ast.Assign) and self._is_wall_call(
                    node.value
                ):
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            names.add(t.id)
                stack.extend(ast.iter_child_nodes(node))
            self._wall_names[scope] = names

        scan(tree, tree.body)
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scan(node, node.body)

    def _is_wall(
        self, node: ast.AST, parents: Sequence[ast.AST], ctx: FileContext
    ) -> bool:
        if self._is_wall_call(node):
            return True
        if isinstance(node, ast.Name):
            fn = None
            for p in reversed(parents):
                if isinstance(p, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    fn = p
                    break
            if node.id in self._wall_names.get(fn, ()):
                return True
            if node.id in self._wall_names.get(ctx.tree, ()):
                return True
        return False

    def visit(self, node, parents, ctx: FileContext) -> None:
        if not isinstance(node.op, ast.Sub):
            return
        if self._is_wall(node.left, parents, ctx) or self._is_wall(
            node.right, parents, ctx
        ):
            self.report(
                ctx,
                node,
                "wall clock in duration arithmetic: time.time()/"
                "datetime.now() step under NTP; use time.perf_counter()"
                "/monotonic() for durations (wall clock is for "
                "timestamps)",
            )


def _make_default_rules() -> List[Rule]:
    """Fresh rule instances (rules hold per-file state; concurrent
    engines must not share them — tests construct their own packs)."""
    return [
        LockDisciplineRule(),
        EnvDisciplineRule(),
        TorchDtypeDisciplineRule(),
        TimingDisciplineRule(),
        MetricsDisciplineRule(),
    ]


# The CLI's (serial) rule pack; begin_file() resets per-file state.
DEFAULT_RULES: Sequence[Rule] = _make_default_rules()


def _make_default_project_rules():
    """The whole-program rule pack (fresh instances, same contract)."""
    from .concurrency import make_concurrency_rules
    from .contracts import make_contract_rules
    from .hotpath import make_hotpath_rules
    from .native_abi import make_native_abi_rules

    return (
        make_concurrency_rules()
        + make_contract_rules()
        + make_native_abi_rules()
        + make_hotpath_rules()
        + [TorchHostSyncRule()]
    )


DEFAULT_PROJECT_RULES = _make_default_project_rules()
