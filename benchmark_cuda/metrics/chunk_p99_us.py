"""The 99th percentile of every chunk of the window, from the call of
submit_packed to the return of its step_complete (host clock)."""

import numpy as np


def read(run):
    lat = run.get("chunk_latency_us")
    return float(np.percentile(lat, 99)) if lat else None
