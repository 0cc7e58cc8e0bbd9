"""Package-level contracts of the port: it stands alone (importing
every module pulls in neither jax nor the JAX package), its registry
builds every algorithm's model and refuses devices it has no kernel
for instead of falling back, and its CPU dispatch is explicit."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import ratelimit_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
leaked = sorted(
    m for m in sys.modules
    if m == "jax" or m.startswith("jax.")
    or m == "ratelimit_tpu" or m.startswith("ratelimit_tpu.")
)
print(len(names), leaked)
assert not leaked, leaked
assert "ratelimit_tpu_torch.parallel.sharded" in names, names
for plane in ("events", "flight", "launches", "slo", "hotkeys", "detectors", "timeseries"):
    assert "ratelimit_tpu_torch.observability." + plane in names, plane
for mod in ("overload.controller", "cluster.hashing", "cluster.handoff", "cluster.faults",
            "cluster.router", "cluster.proxy", "cluster.fleet", "cli.client", "cli.config_check"):
    assert "ratelimit_tpu_torch." + mod in names, mod
"""


def test_port_imports_no_jax_and_no_reference_package():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL],
        cwd=REPO,
        env=env,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    count = int(proc.stdout.split()[0])
    assert count >= 30  # every module of the package was imported


@pytest.mark.parametrize("name", ["sliding_window", "gcra"])
def test_registry_refuses_unported_algorithms(name):
    """Both algorithm banks are ported: the registry builds each model
    on the device it is given, and refuses a device it has no kernel
    for instead of falling back."""
    from ratelimit_tpu_torch.models.registry import get_algorithm

    spec = get_algorithm(name)
    model = spec.make_model(64, 0.8, device="cpu")
    assert model.algo == name and model.state_rows == spec.state_rows
    assert not model.windowed_keys and model.device.type == "cpu"
    assert tuple(model.init_state().shape) == (len(spec.state_rows), 64)
    with pytest.raises(ValueError, match="unsupported device"):
        spec.make_model(64, 0.8, device="meta")


def test_registry_builds_fixed_window_on_cpu():
    from ratelimit_tpu_torch.models.registry import get_algorithm

    model = get_algorithm("fixed_window").make_model(64, 0.5, device="cpu")
    assert model.num_slots == 64 and model.device.type == "cpu"


def test_config_with_algorithm_rules_loads_like_the_reference():
    """The algorithm table stays complete, so a config naming gcra
    loads (and, with no bank, enforces fixed-window) as it does in the
    JAX package."""
    from ratelimit_tpu.config.loader import ConfigFile as JaxConfigFile
    from ratelimit_tpu.config.loader import load_config as jax_load
    from ratelimit_tpu.stats.manager import Manager as JaxManager
    from ratelimit_tpu_torch.config.loader import ConfigFile, load_config
    from ratelimit_tpu_torch.stats.manager import Manager

    yaml = (
        "domain: d\n"
        "descriptors:\n"
        "  - key: k\n"
        "    rate_limit:\n"
        "      unit: minute\n"
        "      requests_per_unit: 3\n"
        "      algorithm: gcra\n"
    )
    port = load_config([ConfigFile("config.d", yaml)], Manager())
    ref = jax_load([JaxConfigFile("config.d", yaml)], JaxManager())
    assert sorted(port.domains) == sorted(ref.domains) == ["d"]


def test_kernel_wrappers_refuse_unknown_devices():
    import torch

    from ratelimit_tpu_torch.models.fixed_window import fw_unique_step

    counts = torch.zeros(8, dtype=torch.int32, device="meta")
    packed = torch.zeros((4, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fw_unique_step(counts, packed, "")


PLANES = ("events", "flight", "launches", "slo", "hotkeys", "detectors", "timeseries")


@pytest.mark.parametrize("plane", PLANES)
def test_observability_plane_is_the_port_own_copy(plane):
    """Each observability plane is a module of the port with the JAX
    module's public names, importing nothing of the JAX package: its
    globals name no module outside ratelimit_tpu_torch but the standard
    library and numpy."""
    import importlib
    import types

    port = importlib.import_module("ratelimit_tpu_torch.observability." + plane)
    ref = importlib.import_module("ratelimit_tpu.observability." + plane)
    public = lambda m: sorted(  # noqa: E731
        n for n, v in vars(m).items()
        if not n.startswith("_") and not isinstance(v, types.ModuleType)
        and getattr(v, "__module__", m.__name__) == m.__name__
    )
    assert public(port) == public(ref)
    for value in vars(port).values():
        mod = getattr(value, "__module__", None) or (
            value.__name__ if isinstance(value, types.ModuleType) else None
        )
        if mod:
            assert not (mod == "ratelimit_tpu" or mod.startswith("ratelimit_tpu.")), (plane, mod)


COPIES = (
    "overload.controller", "cluster.hashing", "cluster.handoff", "cluster.faults",
    "cluster.router", "cluster.proxy", "cluster.fleet", "cli.client", "cli.config_check",
)


@pytest.mark.parametrize("name", COPIES)
def test_overload_and_cluster_modules_are_the_port_own_copies(name):
    """The overload controller, both halves of the cluster tier and the
    command-line tools are modules of the port with the JAX modules'
    public names, naming no module of the JAX package, and the cluster
    package's ReplicaRouter resolves to the port's router.  The handoff
    adds HANDOFF_CHUNK, the keys its import lands per exclusive leg, and
    YIELD_EVERY, the keys a per-key pass handles between two yields of
    the interpreter lock."""
    import importlib
    import types

    port = importlib.import_module("ratelimit_tpu_torch." + name)
    ref = importlib.import_module("ratelimit_tpu." + name)
    public = lambda m: sorted(  # noqa: E731
        n for n, v in vars(m).items()
        if not n.startswith("_") and not isinstance(v, types.ModuleType)
        and getattr(v, "__module__", m.__name__) == m.__name__
    )
    extra = ["HANDOFF_CHUNK", "YIELD_EVERY"] if name == "cluster.handoff" else []
    assert public(port) == sorted(public(ref) + extra)
    for value in vars(port).values():
        mod = getattr(value, "__module__", None) or (
            value.__name__ if isinstance(value, types.ModuleType) else None
        )
        if mod:
            assert not (mod == "ratelimit_tpu" or mod.startswith("ratelimit_tpu.")), (name, mod)
    cluster = importlib.import_module("ratelimit_tpu_torch.cluster")
    router = importlib.import_module("ratelimit_tpu_torch.cluster.router")
    assert cluster.ReplicaRouter is router.ReplicaRouter
    with pytest.raises(AttributeError):
        cluster.NoSuchName


_IMPORT_HOST_TOOLS = """
import sys
import ratelimit_tpu_torch.cluster.proxy, ratelimit_tpu_torch.cli.client
loaded = sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("torch", "jax", "jaxlib", "ratelimit_tpu")
)
print(loaded)
assert not loaded, loaded
"""


def test_proxy_and_client_import_no_torch():
    """The proxy process owns no counters and the client sends one RPC:
    importing either loads no torch (so no CUDA context can be made in
    their processes), no jax and nothing of the JAX package."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_HOST_TOOLS],
        cwd=REPO,
        env=env,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr[-2000:]
    assert proc.stdout.strip() == "[]"


_ANALYSIS_ALONE = """
import runpy, sys
import ratelimit_tpu_torch.analysis
from ratelimit_tpu_torch.analysis import sanitizer
sanitizer.install()
sanitizer.uninstall()
sys.argv = ["ratelimit_tpu_torch.analysis", "--list-rules"]
try:
    runpy.run_module("ratelimit_tpu_torch.analysis", run_name="__main__")
except SystemExit as e:
    assert e.code in (0, None), e.code
leaked = sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "ratelimit_tpu", "torch")
)
print("LEAKED", leaked)
"""


def test_analysis_loads_neither_jax_nor_the_jax_package_nor_torch():
    """The analyzer and the sanitizer are pure stdlib: they run where
    neither stack is installed."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "-c", _ANALYSIS_ALONE],
        cwd=REPO,
        env=env,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "torch-host-sync:" in proc.stdout
    assert proc.stdout.strip().splitlines()[-1] == "LEAKED []"


def test_debug_profiling_mark_is_the_sanitizers():
    """The capture gate's allow_blocking is the port sanitizer's own
    (the placeholder mark is gone), so a sanitized run sees it."""
    from ratelimit_tpu_torch.analysis import sanitizer
    from ratelimit_tpu_torch.server import debug_profiling

    assert debug_profiling.allow_blocking is sanitizer.allow_blocking
    assert not hasattr(debug_profiling, "_AllowBlocking")
    with pytest.raises(ValueError, match="justification"):
        debug_profiling.allow_blocking("")
