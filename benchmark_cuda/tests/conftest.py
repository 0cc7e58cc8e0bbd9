"""Shared pieces of the benchmark's own tests (CPU, tiny sizes).

    python -m pytest benchmark_cuda/tests -q

A test that needs the card takes the ``card`` fixture, which skips it
where torch sees no CUDA device; the decision is made inside the fixture,
never at import.
"""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, ROOT]

#: Each cell shrunk to run in seconds on the CPU's plain path.
TINY = {
    "fw_grpc_32c": {
        "config.keys.count": 2048, "config.settings.TPU_NUM_SLOTS": "16384",
        "traffic.threads": 4, "traffic.draws_per_thread": 2000, "traffic.trace_s": 1.0,
    },
    "fw_engine_4096": {
        "config.keys.count": 2048, "config.settings.TPU_NUM_SLOTS": "16384",
        "traffic.lanes": 256, "traffic.pool_chunks": 4, "traffic.sample_share": 0.1,
    },
    "gcra_engine_4096": {
        "config.keys.count": 2048, "config.settings.TPU_NUM_SLOTS": "16384",
        "config.settings.TPU_ALGORITHM_NUM_SLOTS": "8192",
        "traffic.lanes": 256, "traffic.pool_chunks": 4, "traffic.sample_share": 0.1,
    },
}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def run_tiny(cell, seed=2**33 + 7, seconds=2.0, trace=False, control=False):
    import harness

    return harness.run_cell(cell, seed, seconds, trace, device="cpu",
                            overrides=TINY[cell], control=control)
