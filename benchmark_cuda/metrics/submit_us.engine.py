"""Median host microseconds of one submit_packed call (the benchmark's own
timer), over the window's chunks."""

import numpy as np


def read(run):
    xs = run.get("submit_us")
    return float(np.median(xs)) if xs else None
