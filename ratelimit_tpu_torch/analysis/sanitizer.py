"""Runtime lock/atomicity sanitizer of the PyTorch/CUDA port
(``TPU_SANITIZE=1``).

The static lock-order rule (analysis/concurrency.py) sees the orders
the AST can prove; this module records the orders the program REALLY
exhibits while the test suite runs — the lockdep idea, sized for
Python:

- ``install()`` patches the ``threading.Lock`` / ``threading.RLock``
  factories to return tracking wrappers.  Each lock's IDENTITY is its
  creation site (``file:line``), so every instance allocated at one
  site shares ordering constraints — two Counter instances prove an
  ordering fact about Counter._lock, exactly like lockdep classes.
- every acquisition while other locks are held adds edges to a global
  lock-order graph; an edge that closes a cycle is a REAL AB/BA
  inversion two threads could deadlock on, reported with both edges'
  acquisition sites.
- blocking while holding a lock — ``time.sleep``, an untimed
  ``threading.Event.wait``, or a wait for the card
  (``torch.cuda.synchronize``, ``torch.cuda.Stream.synchronize``,
  ``torch.cuda.Event.synchronize``) with any sanitized lock held — is
  reported as a held-across-blocking-call violation (every thread
  contending on that lock stalls behind the sleeper).  The card's
  waits are patched only when ``torch`` is already imported at
  install time, so this module stays stdlib and never imports torch.

Scope: only locks CREATED from files matching ``TPU_SANITIZE_SCOPE``
(default: this package and the port's tests, ``tests/test_torch_``)
are wrapped; library-internal locks (grpc, torch) and the JAX
package's locks pass through untouched, so overhead and noise stay
bounded.  Violations are collected (deduplicated, bounded);
``TPU_SANITIZE_RAISE=1`` raises at the violation point instead.

Port of ratelimit_tpu/analysis/sanitizer.py.  Install it before any
``ratelimit_tpu_torch`` import allocates a module-level lock (a lock
made before install is a raw lock and is never tracked).
"""

from __future__ import annotations

import os
import sys
import threading
import time
import traceback
from typing import Dict, List, Optional, Set, Tuple

_MAX_VIOLATIONS = 100

#: Filename fragments whose frames are "plumbing" when attributing a
#: lock's creation site.
_SKIP_FRAGMENTS = ("/threading.py", "/analysis/sanitizer.py")


def _default_scope() -> Tuple[str, ...]:
    raw = os.environ.get("TPU_SANITIZE_SCOPE", "")  # tpu-lint: disable=env-discipline -- the sanitizer is installed before any Settings exists (before the package is first imported)
    if raw:
        return tuple(s for s in raw.split(",") if s)
    return ("ratelimit_tpu_torch", "tests/test_torch_")


def _creation_site() -> Optional[str]:
    """file:line of the first frame outside threading/sanitizer
    plumbing, or None when the allocation is out of scope."""
    f = sys._getframe(2)
    while f is not None:
        fname = f.f_code.co_filename.replace("\\", "/")
        if not any(s in fname for s in _SKIP_FRAGMENTS):
            break
        f = f.f_back
    if f is None:
        return None
    fname = f.f_code.co_filename.replace("\\", "/")
    if not any(s in fname for s in _SANITIZER.scope):
        return None
    return f"{fname}:{f.f_lineno}"


class Violation:
    __slots__ = ("kind", "detail", "thread", "stack")

    def __init__(self, kind: str, detail: str, stack: str):
        self.kind = kind
        self.detail = detail
        self.thread = threading.current_thread().name
        self.stack = stack

    def as_dict(self) -> dict:
        return {
            "kind": self.kind,
            "detail": self.detail,
            "thread": self.thread,
            "stack": self.stack,
        }

    def text(self) -> str:
        return (
            f"[{self.kind}] {self.detail} (thread {self.thread})\n"
            f"{self.stack}"
        )


class _ThreadState(threading.local):
    def __init__(self):
        self.held: List[str] = []  # lock keys, acquisition order
        self.depths: Dict[int, int] = {}  # id(wrapper) -> reentry depth
        self.allow_blocking = 0  # allow_blocking() nesting depth


class LockSanitizer:
    """Global state: the runtime lock-order graph + violations."""

    def __init__(self):
        self.scope = _default_scope()
        self.raise_on_violation = False
        # raw lock (never a wrapper): guards graph/violations
        self._glock = threading.RLock()
        self._graph: Dict[str, Set[str]] = {}
        # (a, b) -> human description of where the edge was observed
        self._edge_sites: Dict[Tuple[str, str], str] = {}
        self._violations: List[Violation] = []
        self._seen_sigs: Set[tuple] = set()
        # sanitized lock instances made, and their distinct sites
        self.locks_made = 0
        self._sites: Set[str] = set()
        self.installed = False
        self._orig: dict = {}

    # -- violation sink ---------------------------------------------------

    def _report(self, kind: str, detail: str, sig: tuple) -> None:
        stack = "".join(
            traceback.format_list(traceback.extract_stack(limit=8)[:-3])
        )
        with self._glock:
            if sig in self._seen_sigs:
                return
            self._seen_sigs.add(sig)
            if len(self._violations) < _MAX_VIOLATIONS:
                self._violations.append(Violation(kind, detail, stack))
        if self.raise_on_violation:
            raise RuntimeError(f"TPU_SANITIZE: [{kind}] {detail}")

    def violations(self) -> List[Violation]:
        with self._glock:
            return list(self._violations)

    def clear(self) -> None:
        with self._glock:
            self._violations.clear()
            self._seen_sigs.clear()
            self._graph.clear()
            self._edge_sites.clear()

    def _note_lock(self, key: str) -> None:
        with self._glock:
            self.locks_made += 1
            self._sites.add(key)

    def summary(self) -> dict:
        """Counts for a report: sanitized locks made, their distinct
        creation sites, lock-order edges seen, violations by kind."""
        with self._glock:
            kinds: Dict[str, int] = {}
            for v in self._violations:
                kinds[v.kind] = kinds.get(v.kind, 0) + 1
            return {
                "locks": self.locks_made,
                "lock_sites": len(self._sites),
                "order_edges": sum(len(e) for e in self._graph.values()),
                "violations": len(self._violations),
                "by_kind": kinds,
            }

    def format_report(self) -> str:
        v = self.violations()
        if not v:
            return "tpu-sanitize: no violations"
        out = [f"tpu-sanitize: {len(v)} violation(s)"]
        out.extend(x.text() for x in v)
        return "\n".join(out)

    # -- graph ------------------------------------------------------------

    def _note_acquire(self, key: str, held: List[str]) -> None:
        """Called AFTER a top-level acquire succeeds, with the held
        list as it was before this acquisition."""
        if not held:
            return
        site = _acquire_site()
        with self._glock:
            for outer in held:
                if outer == key:
                    continue  # same lock class: reentrancy, not order
                edges = self._graph.setdefault(outer, set())
                if key in edges:
                    continue
                edges.add(key)
                self._edge_sites[(outer, key)] = site
                cycle = self._find_path(key, outer)
                if cycle is not None:
                    legs = " -> ".join(cycle + [key])
                    where = "; ".join(
                        f"{a}->{b} at {self._edge_sites.get((a, b), '?')}"
                        for a, b in zip(
                            [key] + cycle, cycle + [key]
                        )
                        if (a, b) in self._edge_sites
                    )
                    self._report(
                        "lock-order-cycle",
                        f"acquiring {key} while holding {outer} closes "
                        f"the cycle {legs} ({where or site})",
                        ("cycle", tuple(sorted((outer, key)))),
                    )

    def _find_path(self, src: str, dst: str) -> Optional[List[str]]:
        """Nodes on a path src ->* dst (exclusive of dst), or None."""
        stack = [(src, [src])]
        seen = {src}
        while stack:
            node, path = stack.pop()
            for nxt in self._graph.get(node, ()):
                if nxt == dst:
                    return path
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    def _note_blocking(self, what: str) -> None:
        if _TLS.allow_blocking:
            return  # inside a justified allow_blocking() scope
        held = _TLS.held
        if held:
            self._report(
                "held-across-blocking-call",
                f"{what} while holding {held[-1]} "
                f"(all held: {', '.join(held)}) at {_acquire_site()}",
                ("blocking", what, held[-1]),
            )

    # -- install / uninstall ----------------------------------------------

    def install(self, raise_on_violation: bool = False) -> None:
        if self.installed:
            self.raise_on_violation = raise_on_violation
            return
        self.raise_on_violation = raise_on_violation
        self._orig = {
            "Lock": threading.Lock,
            "RLock": threading.RLock,
            "sleep": time.sleep,
            "event_wait": threading.Event.wait,
        }
        threading.Lock = _make_lock_factory(self._orig["Lock"], False)
        threading.RLock = _make_lock_factory(self._orig["RLock"], True)
        time.sleep = _make_sleep(self._orig["sleep"])
        threading.Event.wait = _make_event_wait(self._orig["event_wait"])
        self._patch_card_waits()
        self.installed = True

    def _patch_card_waits(self) -> None:
        """Wrap the card's host waits, when torch is already loaded."""
        torch = sys.modules.get("torch")
        cuda = getattr(torch, "cuda", None) if torch is not None else None
        if cuda is None:
            return
        self._orig["cuda_synchronize"] = cuda.synchronize
        cuda.synchronize = _make_card_wait(
            cuda.synchronize, "torch.cuda.synchronize()"
        )
        for cls_name in ("Stream", "Event"):
            cls = getattr(cuda, cls_name, None)
            if cls is None:
                continue
            self._orig[f"{cls_name}.synchronize"] = cls.synchronize
            cls.synchronize = _make_card_wait(
                cls.synchronize, f"torch.cuda.{cls_name}.synchronize()"
            )

    def uninstall(self) -> None:
        if not self.installed:
            return
        threading.Lock = self._orig["Lock"]
        threading.RLock = self._orig["RLock"]
        time.sleep = self._orig["sleep"]
        threading.Event.wait = self._orig["event_wait"]
        cuda = getattr(sys.modules.get("torch"), "cuda", None)
        if "cuda_synchronize" in self._orig and cuda is not None:
            cuda.synchronize = self._orig["cuda_synchronize"]
            for cls_name in ("Stream", "Event"):
                orig = self._orig.get(f"{cls_name}.synchronize")
                if orig is not None:
                    setattr(getattr(cuda, cls_name), "synchronize", orig)
        self.installed = False


_SANITIZER = LockSanitizer()
_TLS = _ThreadState()


def _acquire_site() -> str:
    f = sys._getframe(2)
    while f is not None:
        fname = f.f_code.co_filename.replace("\\", "/")
        if not any(s in fname for s in _SKIP_FRAGMENTS):
            return f"{fname}:{f.f_lineno}"
        f = f.f_back
    return "?"


class _SanitizedLockBase:
    """Tracking wrapper around a real lock.  Reentrancy-aware: only
    the OUTERMOST acquire/release push/pop the held stack, so RLock
    recursion never double-counts."""

    __slots__ = ("_inner", "_key")

    def __init__(self, inner, key: str):
        self._inner = inner
        self._key = key

    # -- tracking helpers -------------------------------------------------

    def _on_acquired(self) -> None:
        me = id(self)
        depth = _TLS.depths.get(me, 0) + 1
        _TLS.depths[me] = depth
        if depth == 1:
            _SANITIZER._note_acquire(self._key, list(_TLS.held))
            _TLS.held.append(self._key)

    def _on_release(self) -> None:
        me = id(self)
        depth = _TLS.depths.get(me, 0) - 1
        if depth <= 0:
            _TLS.depths.pop(me, None)
            # remove by identity from wherever it sits (not always top:
            # code may release out of order)
            for i in range(len(_TLS.held) - 1, -1, -1):
                if _TLS.held[i] == self._key:
                    del _TLS.held[i]
                    break
        else:
            _TLS.depths[me] = depth

    # -- lock protocol -----------------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1):
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._on_acquired()
        return ok

    def release(self) -> None:
        self._on_release()
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<sanitized {self._key} of {self._inner!r}>"


class _SanitizedLock(_SanitizedLockBase):
    __slots__ = ()


class _SanitizedRLock(_SanitizedLockBase):
    """RLock wrapper: also speaks Condition's private protocol so
    ``threading.Condition()`` (whose default lock is ``RLock()`` and
    therefore sanitized) keeps the held stack honest across wait()."""

    __slots__ = ()

    def _is_owned(self):
        return self._inner._is_owned()

    def _release_save(self):
        # cv.wait(): the lock is FULLY released regardless of depth.
        me = id(self)
        depth = _TLS.depths.pop(me, 0)
        if depth > 0:
            for i in range(len(_TLS.held) - 1, -1, -1):
                if _TLS.held[i] == self._key:
                    del _TLS.held[i]
                    break
        return (self._inner._release_save(), depth)

    def _acquire_restore(self, state):
        inner_state, depth = state
        self._inner._acquire_restore(inner_state)
        if depth > 0:
            _TLS.depths[id(self)] = depth
            _TLS.held.append(self._key)


def _make_lock_factory(orig_factory, is_rlock: bool):
    cls = _SanitizedRLock if is_rlock else _SanitizedLock

    def factory():
        inner = orig_factory()
        if not _SANITIZER.installed:
            return inner
        key = _creation_site()
        if key is None:
            return inner  # out of scope: raw lock, zero overhead
        _SANITIZER._note_lock(key)
        return cls(inner, key)

    factory.__name__ = "RLock" if is_rlock else "Lock"
    return factory


def _make_sleep(orig_sleep):
    def sleep(seconds):
        if _SANITIZER.installed:
            _SANITIZER._note_blocking(f"time.sleep({seconds!r})")
        return orig_sleep(seconds)

    return sleep


def _make_event_wait(orig_wait):
    def wait(self, timeout=None):
        if _SANITIZER.installed and timeout is None:
            _SANITIZER._note_blocking("untimed Event.wait()")
        return orig_wait(self, timeout)

    return wait


def _make_card_wait(orig, what: str):
    """A wait for the card: it has no timeout, so any sanitized lock
    held across it is a violation (unless allow_blocking says why)."""

    def wait(*args, **kwargs):
        if _SANITIZER.installed:
            _SANITIZER._note_blocking(what)
        return orig(*args, **kwargs)

    wait.__name__ = getattr(orig, "__name__", "synchronize")
    wait.__doc__ = getattr(orig, "__doc__", None)
    return wait


# ---------------------------------------------------------------------------
# module-level API (what the smoke, scripts and tests import)
# ---------------------------------------------------------------------------


def install(raise_on_violation: bool = False) -> LockSanitizer:
    """Activate the sanitizer (idempotent); returns the global
    instance for violations()/format_report()."""
    _SANITIZER.install(raise_on_violation=raise_on_violation)
    return _SANITIZER


def uninstall() -> None:
    _SANITIZER.uninstall()


def get() -> LockSanitizer:
    return _SANITIZER


class _AllowBlocking:
    """Context manager marking the CURRENT THREAD's blocking calls as
    sanctioned — the runtime analog of a ``# tpu-lint: disable=...
    -- why`` suppression, and like it the justification is part of
    the call site.  Use it ONLY where holding the lock across the
    block is the design and nothing ever blocks on that lock (e.g.
    the debug profiler's one-capture-at-a-time gate, whose contenders
    take ``acquire(blocking=False)`` and answer 409 instead of
    waiting)."""

    __slots__ = ("why",)

    def __init__(self, why: str):
        if not why:
            raise ValueError("allow_blocking requires a justification")
        self.why = why

    def __enter__(self):
        _TLS.allow_blocking += 1
        return self

    def __exit__(self, *exc) -> None:
        _TLS.allow_blocking -= 1


def allow_blocking(why: str) -> _AllowBlocking:
    return _AllowBlocking(why)


def enabled_by_env() -> bool:
    return os.environ.get("TPU_SANITIZE", "") not in ("", "0", "false")  # tpu-lint: disable=env-discipline -- the sanitizer is installed before any Settings exists (before the package is first imported)
