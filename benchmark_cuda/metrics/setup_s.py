"""Process start to the first timed call (host clock): imports, the card, the
engine or runner, the traffic, the first launch of every shape the cell uses
and, in a fresh checkout, the kernels' nvcc build."""


def read(run):
    return run["setup_s"]
