"""Background-thread crash visibility.

Port of ratelimit_tpu/utils/threads.py.  A daemon thread that dies from
an uncaught exception (a dispatcher, the write-behind completer, the
SRV watcher) prints a traceback to stderr and vanishes: the service
limps on degraded and nothing fails.  ``threading.excepthook`` (3.8+)
is the seam: the runner installs a hook that LOGS the crash loudly, and
a test bootstrap can stack a recording hook on it so that a test whose
background thread dies FAILS instead of passing silently.

The hook CHAINS: the previous hook still runs, so stacking the recorder
on top of the logger (or pytest's own machinery) loses nothing.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, List, Optional


class ThreadExceptionRecorder:
    """Collects (thread name, exception) pairs from crashed threads.

    ``drain()`` returns and clears the record: tests that DELIBERATELY
    crash a background thread drain it to acknowledge; anything left at
    check time is a failure.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._records: List[tuple] = []

    def record(self, thread_name: str, exc: BaseException) -> None:
        with self._lock:
            self._records.append((thread_name, exc))

    def drain(self) -> List[tuple]:
        with self._lock:
            out, self._records = self._records, []
            return out

    def pending(self) -> List[tuple]:
        with self._lock:
            return list(self._records)


def install_thread_excepthook(
    on_exception: Optional[Callable[[str, BaseException], None]] = None,
    logger_name: str = "ratelimit.threads",
) -> Callable:
    """Install a chaining ``threading.excepthook``: log the crash at
    ERROR (daemon-thread tracebacks otherwise go to bare stderr and get
    lost in service logs), invoke ``on_exception(thread_name, exc)`` if
    given, then run the PREVIOUS hook.  Returns the installed hook
    (tests compare identity)."""
    previous = threading.excepthook
    log = logging.getLogger(logger_name)

    def hook(args: "threading.ExceptHookArgs") -> None:
        if args.exc_type is SystemExit:
            return  # mirrors the default hook: SystemExit is silent
        name = args.thread.name if args.thread is not None else "?"
        log.error(
            "background thread %r died: %r",
            name,
            args.exc_value,
            exc_info=(args.exc_type, args.exc_value, args.exc_traceback),
        )
        if on_exception is not None:
            try:
                on_exception(name, args.exc_value)
            except Exception:  # the hook must never raise
                log.exception("thread excepthook callback failed")
        # Chain CUSTOM hooks only: re-running the default hook would
        # print the same traceback to stderr a second time.
        if previous is not None and previous not in (
            hook,
            threading.__excepthook__,
        ):
            previous(args)

    threading.excepthook = hook
    return hook
