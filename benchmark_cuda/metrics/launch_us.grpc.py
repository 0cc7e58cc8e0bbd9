"""Median launch_ns of the program's launch recorder over the window:
submit_items entry to the device step in flight."""

import numpy as np


def read(run):
    rec = run.get("launch_records")
    return float(np.median(rec["launch_ns"])) / 1e3 if rec is not None and len(rec) else None
