"""Offline config validator (reference src/config_check_cmd/main.go:
load every YAML under --config_dir through the real loader; exit 1 and
print the error on failure).

Port of ratelimit_tpu/cli/config_check.py, unchanged: the configs go
through this package's loader and stats manager.

    python -m ratelimit_tpu_torch.cli.config_check --config_dir <dir>
"""

from __future__ import annotations

import argparse
import os
import sys

from ..config.loader import ConfigError, ConfigFile, load_config
from ..stats.manager import Manager


def load_dir(config_dir: str):
    files = []
    for name in sorted(os.listdir(config_dir)):
        if not name.endswith((".yaml", ".yml")):
            continue
        path = os.path.join(config_dir, name)
        with open(path, "r", encoding="utf-8") as f:
            files.append(ConfigFile(name, f.read()))
    return load_config(files, Manager())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="validate ratelimit configs")
    p.add_argument("--config_dir", required=True)
    args = p.parse_args(argv)

    try:
        config = load_dir(args.config_dir)
    except ConfigError as e:
        print(f"error loading config: {e}", file=sys.stderr)
        return 1
    except OSError as e:
        print(f"error reading config dir: {e}", file=sys.stderr)
        return 1
    print(config.dump(), end="")
    return 0


if __name__ == "__main__":
    sys.exit(main())
