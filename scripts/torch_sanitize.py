"""Run port tests under the port's runtime lock sanitizer.

    python3 scripts/torch_sanitize.py [pytest args]   # default: tests/test_torch_*.py

Installs ratelimit_tpu_torch.analysis.sanitizer before pytest imports
anything (so every lock the port allocates, module-level ones included,
is tracked), runs pytest in this process -- so no ``-n``: xdist workers
would run unsanitized -- and exits non-zero when the tests fail or the
sanitizer saw a lock-order cycle or a blocking call under a held lock,
printing each violation with its stack.  Torch is imported first, so
its waits for the card are tracked too where a test reaches them.

The JAX package's own sanitizer (``TPU_SANITIZE=1``, installed by
tests/conftest.py) is a different tool with a scope that also matches
the port's paths; leave TPU_SANITIZE unset here.
"""

import glob
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv) -> int:
    if os.environ.get("TPU_SANITIZE", "") not in ("", "0", "false"):
        print("unset TPU_SANITIZE: it installs the JAX package's sanitizer", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import torch  # noqa: F401  (before install: torch.cuda waits get wrapped)

    from ratelimit_tpu_torch.analysis import sanitizer

    san = sanitizer.install()
    import pytest

    args = argv or sorted(glob.glob(os.path.join(REPO, "tests", "test_torch_*.py")))
    rc = pytest.main(["-q", "-p", "no:cacheprovider", *args])
    print(san.format_report())
    print(f"tpu-sanitize summary: {san.summary()}")
    if san.violations():
        return 1
    return int(rc)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
