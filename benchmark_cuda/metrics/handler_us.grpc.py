"""Median duration of the gRPC handler's root span (the program's tracer,
sample rate 1 in the traced run), over the window."""

import numpy as np


def read(run):
    spans = run.get("handler_us")
    return float(np.median(spans)) if spans else None
