"""Median host microseconds of one step_complete call (the benchmark's own
timer), over the window's chunks."""

import numpy as np


def read(run):
    xs = run.get("complete_us")
    return float(np.median(xs)) if xs else None
