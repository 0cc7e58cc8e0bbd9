"""Seconds of the set-up's checkpoint restore of the morning, from the
program's span (``checkpoint.restore_engine`` stamps the engine's
``stat_restore_ns``: the file's read, ``import_state`` and the slot
table).  A program without the span reads nothing."""


def read(run):
    ns = run.get("restore_ns")
    return ns / 1e9 if ns else None
