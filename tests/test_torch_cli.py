"""The port's command-line tools (ratelimit_tpu_torch/cli/) against the
JAX package's, on the CPU.

config_check loads the repo's example configs (examples/) and broken
ones through both packages' loaders and stats managers: the same exit
code and the same output, in-process and as ``python -m``.  The gRPC
client dials a port runner (device="cpu") and a JAX runner booted on
the same settings: the same exit codes and the same printed replies and
errors, in-process and as ``python -m ratelimit_tpu_torch.cli.client``.
"""

import os
import subprocess
import sys

import pytest

from ratelimit_tpu.cli import client as jax_client
from ratelimit_tpu.cli import config_check as jax_check
from ratelimit_tpu.runner import Runner as JaxRunner
from ratelimit_tpu.settings import Settings as JaxSettings
from ratelimit_tpu.utils.time import PinnedTimeSource as JaxPinned
from ratelimit_tpu_torch.cli import client as port_client
from ratelimit_tpu_torch.cli import config_check as port_check
from ratelimit_tpu_torch.runner import Runner
from ratelimit_tpu_torch.settings import Settings
from ratelimit_tpu_torch.utils.time import PinnedTimeSource

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples", "ratelimit", "config")

YAML = """
domain: cli
descriptors:
  - key: key1
    rate_limit:
      unit: minute
      requests_per_unit: 2
  - key: key1
    value: banned
    rate_limit:
      unit: minute
      requests_per_unit: 0
"""

BROKEN = {
    "bad_yaml.yaml": "domain: [unclosed\n",
    "no_domain.yaml": "descriptors:\n  - key: k\n",
    "bad_unit.yaml": "domain: d\ndescriptors:\n  - key: k\n    rate_limit:\n      unit: fortnight\n"
                     "      requests_per_unit: 1\n",
    "dup.yaml": "domain: d\ndescriptors:\n  - key: k\n  - key: k\n",
}


def _run_main(main, argv, capsys):
    try:
        rc = main(argv)
    except SystemExit as e:
        rc = e.code
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


def _module(name, *argv):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, "-m", name, *argv], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    return proc.returncode, proc.stdout, proc.stderr


def test_config_check_on_the_example_configs(capsys):
    got = _run_main(port_check.main, ["--config_dir", EXAMPLES], capsys)
    assert got[0] == 0 and "rl.foo: unit=MINUTE requests_per_unit=2" in got[1]
    assert got == _run_main(jax_check.main, ["--config_dir", EXAMPLES], capsys)


def test_config_check_as_a_module():
    got = _module("ratelimit_tpu_torch.cli.config_check", "--config_dir", EXAMPLES)
    assert got[0] == 0 and got[1]
    assert got[:2] == _module("ratelimit_tpu.cli.config_check", "--config_dir", EXAMPLES)[:2]


@pytest.mark.parametrize("name", sorted(BROKEN) + ["missing-dir"])
def test_config_check_refuses_what_the_jax_checker_refuses(tmp_path, capsys, name):
    d = tmp_path / "cfg"
    if name != "missing-dir":
        d.mkdir()
        (d / name).write_text(BROKEN[name])
    argv = ["--config_dir", str(d)]
    got = _run_main(port_check.main, argv, capsys)
    assert got[0] == 1 and got[2].startswith("error "), got
    assert got == _run_main(jax_check.main, argv, capsys)


def test_parse_descriptors_builds_the_same_request():
    for spec in ("database=users", "a=1,b=2,,c=", "k"):
        assert (
            port_client.parse_descriptors(spec).SerializeToString()
            == jax_client.parse_descriptors(spec).SerializeToString()
        )


@pytest.fixture(scope="module")
def runners(tmp_path_factory):
    """A JAX runner and a port runner serving YAML on one pinned clock."""
    made = {}
    for pkg, (Rn, St, backend, extra) in {
        "jax": (JaxRunner, JaxSettings, "tpu", dict(time_source=JaxPinned(1_000_000))),
        "port": (Runner, Settings, "cuda", dict(time_source=PinnedTimeSource(1_000_000), device="cpu")),
    }.items():
        root = tmp_path_factory.mktemp(pkg)
        (root / "ratelimit" / "config").mkdir(parents=True)
        (root / "ratelimit" / "config" / "cli.yaml").write_text(YAML)
        r = Rn(
            St(
                host="127.0.0.1", port=0, grpc_host="127.0.0.1", grpc_port=0,
                debug_host="127.0.0.1", debug_port=0, use_statsd=False,
                backend_type=backend, tpu_num_slots=1 << 10, tpu_batch_window_us=0,
                tpu_batch_buckets=[8], runtime_path=str(root), runtime_subdirectory="ratelimit",
                local_cache_size_in_bytes=0, expiration_jitter_max_seconds=0,
            ),
            **extra,
        )
        r.start()
        made[pkg] = r
    yield made
    for r in made.values():
        r.stop()


CALLS = [
    ["--domain", "cli", "--descriptors", "key1=a"],
    ["--domain", "cli", "--descriptors", "key1=a"],
    ["--domain", "cli", "--descriptors", "key1=a"],
    ["--domain", "cli", "--descriptors", "key1=b", "--hits-addend", "2"],
    ["--domain", "cli", "--descriptors", "key1=banned"],
    ["--domain", "cli", "--descriptors", "other=x"],
    ["--domain", "", "--descriptors", "key1=a"],
    ["--domain", "cli", "--descriptors", "key1=a", "--tls-cert", "c.pem"],
]


def test_client_against_a_port_runner(runners, capsys):
    """The same sequence of calls through each package's client to its
    own package's runner: the same exit codes, replies and errors."""

    def observe(client, r):
        dial = ["--dial_string", f"127.0.0.1:{r.grpc_server.bound_port}"]
        return [_run_main(client.main, dial + argv, capsys) for argv in CALLS]

    got = observe(port_client, runners["port"])
    assert [rc for rc, _, _ in got] == [0, 0, 0, 0, 0, 0, 1, 2]
    assert "overall_code: OVER_LIMIT" in got[2][1] and "OVER_LIMIT" in got[4][1]
    assert "error: UNKNOWN" in got[6][2] and "must be given together" in got[7][2]
    assert got == observe(jax_client, runners["jax"])


def test_client_as_a_module_against_a_port_runner(runners):
    dial = f"127.0.0.1:{runners['port'].grpc_server.bound_port}"
    got = _module("ratelimit_tpu_torch.cli.client", "--dial_string", dial,
                  "--domain", "cli", "--descriptors", "key1=module")
    assert got[0] == 0 and "overall_code: OK" in got[1] and "limit_remaining: 1" in got[1]
    dial = f"127.0.0.1:{runners['jax'].grpc_server.bound_port}"
    assert got == _module("ratelimit_tpu.cli.client", "--dial_string", dial,
                          "--domain", "cli", "--descriptors", "key1=module")
