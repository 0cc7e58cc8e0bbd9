"""Median queue_wait_ns of the program's launch recorder over the window:
the oldest item's submit to the collector's launch start."""

import numpy as np


def read(run):
    rec = run.get("launch_records")
    return float(np.median(rec["queue_wait_ns"])) / 1e3 if rec is not None and len(rec) else None
