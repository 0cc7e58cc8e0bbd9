"""The 99th percentile of every RPC sent in the window, timed at the client
from send to reply (host clock)."""

import numpy as np


def read(run):
    lat = run.get("rpc_latency_us")
    return float(np.percentile(lat, 99)) if lat else None
