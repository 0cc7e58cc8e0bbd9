"""Pieces both drivers share: the program's settings from a
configuration, the warm-up of the shapes a cell uses, and the device a
run used."""

from __future__ import annotations

import contextlib
import os


@contextlib.contextmanager
def settings_env(env: dict):
    """The process environment with `env` set (the program reads its
    settings from there), put back on exit."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update({k: str(v) for k, v in env.items()})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def program_settings(cell, extra: dict = None):
    """The program's Settings for the cell's configuration (its
    ``settings``), with `extra` on top."""
    from ratelimit_tpu_torch.settings import new_settings

    with settings_env(dict(cell.config["settings"], **(extra or {}))):
        return new_settings()


def device_info(torch, device: str) -> dict:
    """The result's device object (the peak read now)."""
    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": 1,
        "memory_peak_bytes": int(torch.cuda.max_memory_allocated()),
    }


def limits_of(cell, space) -> "object":
    """int64 limit of every address id of `space` under the
    configuration's rules (the default rule, and the deny-listed
    address's)."""
    import numpy as np

    rules = cell.config["limits"]
    out = np.full(space.ids, int(rules["default"]), dtype=np.int64)
    for value, limit in rules.get("by_value", {}).items():
        if value in space.addresses:
            out[space.addresses.index(value)] = int(limit)
    return out


def warm_buckets(engine, sizes) -> None:
    """The program's own warm-up (``cuda_cache.warmup_engine``: inert
    probes at every readback width it serves) over only the buckets that
    batches of `sizes` distinct keys pad to, as the engine picks them."""
    from ratelimit_tpu_torch.backends.cuda_cache import warmup_engine

    class Only:
        buckets = sorted({engine._bucket(int(n)) for n in sizes})

        def __getattr__(self, name):
            return getattr(engine, name)

    warmup_engine(Only())
