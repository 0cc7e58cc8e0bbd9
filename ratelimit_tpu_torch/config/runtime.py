"""Runtime config loader: directory snapshots + change watching.

The reference uses lyft/goruntime with an fsnotify watcher over
RUNTIME_ROOT (symlink-swap mode) or the config directory directly
(reference src/server/server_impl.go:203-225); each file under the
watched tree becomes a dotted key in a snapshot, and the service
reloads on the update channel (src/service/ratelimit.go:295-306).

This implementation snapshots ``<runtime_path>/<runtime_subdirectory>``
and watches by polling mtimes/sizes with a daemon thread (stdlib-only;
inotify is an optimization, polling is the portable contract — the
symlink-swap deploy pattern works with either since the root's resolved
target changes).
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Dict, List, Optional


class RuntimeSnapshot:
    """Immutable key -> file-contents view (goruntime Snapshot)."""

    def __init__(self, data: Dict[str, str]):
        self._data = dict(data)

    def keys(self) -> List[str]:
        return sorted(self._data)

    def get(self, key: str) -> str:
        return self._data.get(key, "")


def _scan(
    root: str,
    ignore_dot_files: bool,
    prev_stats: Optional[Dict[str, tuple]] = None,
    prev_data: Optional[Dict[str, str]] = None,
) -> tuple:
    """Walk `root`; each file becomes key = relpath, '/'->'.', minus a
    .yaml/.yml extension (goruntime's dotted-key convention).

    Returns ``(data, stats)`` where stats maps key ->
    (path, mtime_ns, size).  File contents are re-read only when the
    stat changed since `prev_stats` — the poll loop stays stat-only in
    steady state.
    """
    data: Dict[str, str] = {}
    stats: Dict[str, tuple] = {}
    if not os.path.isdir(root):
        return data, stats
    prev_stats = prev_stats or {}
    prev_data = prev_data or {}
    for dirpath, dirnames, filenames in os.walk(root, followlinks=True):
        if ignore_dot_files:
            dirnames[:] = [d for d in dirnames if not d.startswith(".")]
        for fn in filenames:
            if ignore_dot_files and fn.startswith("."):
                continue
            path = os.path.join(dirpath, fn)
            rel = os.path.relpath(path, root)
            key = rel.replace(os.sep, ".")
            for ext in (".yaml", ".yml"):
                if key.endswith(ext):
                    key = key[: -len(ext)]
                    break
            try:
                st = os.stat(path)
                stat = (path, st.st_mtime_ns, st.st_size)
                if prev_stats.get(key) == stat and key in prev_data:
                    data[key] = prev_data[key]
                else:
                    with open(path, "r", encoding="utf-8") as f:
                        data[key] = f.read()
                stats[key] = stat
            except OSError:
                continue  # raced with a writer; next poll catches it
    return data, stats


class RuntimeLoader:
    """Snapshot provider + update callbacks over the runtime directory.

    `add_update_callback(fn)` mirrors goruntime's update channel: `fn`
    fires (from the watcher thread) whenever any watched file changes.
    `force_update()` rescans synchronously — the deterministic hook for
    tests (the reference polls config_load_success in its reload
    integration test, test/integration/integration_test.go:622-711).
    """

    def __init__(
        self,
        runtime_path: str,
        runtime_subdirectory: str = "",
        ignore_dot_files: bool = False,
        poll_interval: float = 0.5,
    ):
        self.root = (
            os.path.join(runtime_path, runtime_subdirectory)
            if runtime_subdirectory
            else runtime_path
        )
        self.ignore_dot_files = ignore_dot_files
        self.poll_interval = poll_interval
        self._callbacks: List[Callable[[], None]] = []
        self._lock = threading.Lock()
        self._data, self._stats = _scan(self.root, ignore_dot_files)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def snapshot(self) -> RuntimeSnapshot:
        with self._lock:
            return RuntimeSnapshot(self._data)

    def add_update_callback(self, fn: Callable[[], None]) -> None:
        self._callbacks.append(fn)

    def force_update(self) -> bool:
        """Rescan now; fire callbacks and return True if changed.
        Steady-state cost is one stat() per file (contents re-read only
        on stat change — mtime/size)."""
        with self._lock:
            prev_stats, prev_data = self._stats, self._data
        new_data, new_stats = _scan(
            self.root, self.ignore_dot_files, prev_stats, prev_data
        )
        with self._lock:
            changed = new_data != self._data
            self._data, self._stats = new_data, new_stats
        if changed:
            for fn in list(self._callbacks):
                fn()
        return changed

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._watch, name="runtime-watcher", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _watch(self) -> None:
        while not self._stop.wait(self.poll_interval):
            try:
                self.force_update()
            except Exception:  # never kill the watcher thread
                continue
