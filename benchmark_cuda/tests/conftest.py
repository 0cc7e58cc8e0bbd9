"""Shared pieces of the benchmark's own tests (CPU, tiny sizes).

    python -m pytest benchmark_cuda/tests -q

A test that needs the card takes the ``card`` fixture, which skips it
where torch sees no CUDA device; the decision is made inside the fixture,
never at import.

**Adding a cell** is new files and new entries only, these tests
included.  A cell brings its entry under ``workloads`` (in BENCHMARK.json,
or in ``held.json`` while it is held) and whichever of these it does not
share with a cell already here: its configuration (``configs/``, the
``file`` its entry names), its traffic mix (``traffic/<traffic>.json``),
the mix's driver and judge (``drivers/<driver>.py``, ``judge/<driver>.py``),
the reference of the configuration's algorithm
(``reference/<algorithm>.py``), a reader a metric (``metrics/<name>.py``),
and always its tiny twin ``tests/tiny/<cell>.json``.  What the tests
expect of a cell comes from those entries, never from its name.

**A tiny twin** is one JSON object of overrides that shrinks the cell to
run in seconds on the CPU's plain path: each key a dotted path into the
cell's configuration or traffic mix (``"config.keys.count"`` sets
``config["keys"]["count"]``), each value the one put there.  The file's
stem is the cell's name.

**What a driver observes.**  ``run`` returns, under ``observed``, what its
judge compares with the plain reference, in NumPy arrays:

- every driver: ``algorithm``, the name of ``reference/<algorithm>.py``;
  ``unit``, the window in seconds; ``limits``, each address's limit;
  ``state``, int64[n, 3], the program's state of the judged addresses
  after the window, one row an (address id, window, count) of a fixed
  window or an (address id, TAT seconds, TAT fraction) of GCRA;
- an engine driver (``drivers/engine_chunks.py``) also: ``codes`` and
  ``remaining``, 1-D and of one length, the program's answer to every
  sampled lane in the order sent; and the inputs the reference decides
  those lanes from again: ``pool``, ``chunk_pool``, ``sample_idx``,
  ``now``, ``sampled``, ``lease``;
- a served driver (``drivers/grpc_closed_loop.py``) also: ``rpcs``, a
  dict of 1-D columns of one length, one row an RPC: ``id``,
  ``t_send``, ``t_recv``, ``lat_us``, ``overall``, ``code``,
  ``remaining``, ``err``.

``test_bench_new_cell.py`` holds every cell's run to this.
"""

import json
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, ROOT]

TINY_DIR = os.path.join(HERE, "tiny")


def read_tiny(folder: str = TINY_DIR) -> dict:
    """{cell: overrides} of every tiny twin in `folder`.  Every file there
    has to be a cell's ``<cell>.json`` holding one object of
    ``config.``/``traffic.`` keys; anything else raises ValueError."""
    tiny = {}
    for entry in sorted(os.listdir(folder)):
        path = os.path.join(folder, entry)
        cell, ext = os.path.splitext(entry)
        if ext != ".json" or not os.path.isfile(path):
            raise ValueError(f"{path}: not a tiny twin (<cell>.json)")
        with open(path) as f:
            try:
                overrides = json.load(f)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}: {e}") from e
        if not isinstance(overrides, dict) or not overrides:
            raise ValueError(f"{path}: not a JSON object of overrides")
        for key in overrides:
            where, _, rest = key.partition(".")
            if where not in ("config", "traffic") or not rest:
                raise ValueError(f"{path}: {key!r} is not config.<path> or traffic.<path>")
        tiny[cell] = overrides
    return tiny


#: Each cell shrunk to run in seconds on the CPU's plain path.
TINY = read_tiny()


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
