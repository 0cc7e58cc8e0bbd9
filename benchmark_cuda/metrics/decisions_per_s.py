"""Descriptors decided in the window over the window's seconds (host clock)."""


def read(run):
    return run["decisions"] / run["window_s"]
