"""Bank snapshots for the device fault domain.

Port of the two helpers of ratelimit_tpu/backends/checkpoint.py that
the fault domain calls: ``bank_roles`` names each bank of a cache, and
``snapshot_engine`` copies one bank's state and live keys, the seed of a
quarantined bank's host mirror.  Checkpoint files (CheckpointManager,
save_engine / restore_engine, the npz format, TPU_CHECKPOINT_DIR) are
not ported yet; the runner refuses TPU_CHECKPOINT_DIR.
"""

from __future__ import annotations


def bank_roles(cache) -> list:
    """Topology names for each cache.engines() position, the
    reference's names for the same banks: the fixed-window lane
    ``lane0of1`` (the port serves one lane), then ``algo_<name>`` for
    each algorithm bank."""
    return ["lane0of1"] + ["algo_" + name for name in cache._algo_order]


def snapshot_engine(engine) -> tuple:
    """Copy one bank's state: (state dict, entries).  The state dict is
    ``{"counts": ...}`` for fixed-window banks and one named row per
    state array for algorithm banks (models/registry.py state_rows).
    Needs exclusive access to the engine: run it on the bank's
    dispatcher thread."""
    return engine.export_state(), engine.slot_table.entries()
