"""Megabytes (10^6 bytes) of the native slot table's host index after the
window: the engine's ``stat_index_bytes`` (the key map's arrays, the key
arena, the per-slot homes and the expiry records).  A program without
the counter reads nothing."""


def read(run):
    got = run.get("index_bytes")
    return got / 1e6 if got else None
