"""The port's surface is the JAX package's: every public top-level
function, class and method of ``ratelimit_tpu/`` has a counterpart at
the mirrored path of ``ratelimit_tpu_torch/``.

Both packages are read as source with ``ast``; neither is imported.  A
name is public when it does not start with an underscore; a class's
methods count with the methods of the classes it names as bases in the
same package.  The only differences allowed are the renames and the
Pallas-only names of the tables below, each with its reason, and every
entry of the tables must still be needed.
"""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = os.path.join(ROOT, "ratelimit_tpu")
PORT = os.path.join(ROOT, "ratelimit_tpu_torch")

#: JAX module -> port module, where the port renamed the file.
MODULES = {
    "backends/tpu_cache.py": ("backends/cuda_cache.py", "the cache names the device it serves"),
    "ops/prefix_pallas.py": ("ops/prefix_cuda.py", "the Pallas kernel's module is the CUDA one"),
}
#: (JAX module, name) -> (port name, reason); a class's methods keep
#: their names unless `methods` is False.
NAMES = {
    ("backends/tpu_cache.py", "TpuRateLimitCache"):
        ("CudaRateLimitCache", True, "the cache names the device it serves"),
    ("ops/prefix_pallas.py", "per_slot_inclusive_prefix_pallas"):
        ("per_slot_inclusive_prefix_cuda", True, "the Pallas kernel's wrapper is K2's"),
    ("models/fixed_window.py", "FixedWindowModel.update_unique"):
        ("fw_unique_step", True, "K1's wrapper, a module function beside its plain version"),
    ("models/fixed_window.py", "decision_block"):
        ("fw_decision_block", True, "K3's decision block, named as its kernel"),
    ("analysis/rules.py", "JaxHostSyncRule"):
        ("TorchHostSyncRule", False,
         "the torch twin is a project rule (reachability from the hot-path roots, no jit "
         "scope to visit file by file)"),
    ("analysis/rules.py", "DtypeDisciplineRule"):
        ("TorchDtypeDisciplineRule", True, "the torch twin of the scatter-dtype rule"),
}
#: (JAX module, name) -> reason: no counterpart, Pallas only.
PALLAS_ONLY = {
    ("ops/prefix_pallas.py", "default_interpret"):
        "Pallas's interpret mode on a CPU; a CUDA kernel has none",
}


def _modules(root):
    """Relative path -> parsed module, for every .py file under root."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(d, f)
                with open(path, encoding="utf-8") as fh:
                    out[os.path.relpath(path, root)] = ast.parse(fh.read(), path)
    return out


def _class_entry(node):
    """(methods defined in a class's body, its base names)."""
    methods = {m.name for m in node.body if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))}
    bases = [b.id if isinstance(b, ast.Name) else getattr(b, "attr", "") for b in node.bases]
    return methods, bases


def _classes(modules):
    """Class name -> _class_entry, over every module of a package: where
    a base class is looked up (by name)."""
    return {node.name: _class_entry(node) for tree in modules.values() for node in tree.body
            if isinstance(node, ast.ClassDef)}


def _methods(name, classes, seen=()):
    if name not in classes or name in seen:
        return set()
    own, bases = classes[name]
    return set(own).union(*(_methods(b, classes, seen + (name,)) for b in bases))


def _public(tree, classes):
    """The module's public names: top-level functions and classes, and
    'Class.method' for each public method a class defines or inherits
    from a base found in `classes`."""
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            if node.name.startswith("_"):
                continue
            names.add(node.name)
            if isinstance(node, ast.ClassDef):
                own, bases = _class_entry(node)
                methods = set(own).union(*(_methods(b, classes) for b in bases))
                names |= {f"{node.name}.{m}" for m in methods if not m.startswith("_")}
    return names


_JAX_MODULES = _modules(JAX)
_PORT_MODULES = _modules(PORT)
_JAX_CLASSES = _classes(_JAX_MODULES)
_PORT_CLASSES = _classes(_PORT_MODULES)


def _counterpart(module, name):
    """(port module, port name) of a JAX name, or None where it has none
    by the tables; and the table entry used, if any."""
    if (module, name) in PALLAS_ONLY:
        return None, (module, name)
    target = MODULES.get(module, (module,))[0]
    if (module, name) in NAMES:
        return (target, NAMES[(module, name)][0]), (module, name)
    cls, _, method = name.partition(".")
    if method and (module, cls) in NAMES:
        new, methods, _ = NAMES[(module, cls)]
        if not methods:
            return None, (module, cls)
        return (target, f"{new}.{method}"), (module, cls)
    return (target, name), None


def missing(jax_modules=_JAX_MODULES, port_modules=_PORT_MODULES, jax_classes=_JAX_CLASSES,
            port_classes=_PORT_CLASSES):
    """The JAX names with no counterpart, as 'module: name', and the
    table entries that were used.  A class's bases are looked up in
    `jax_classes` / `port_classes` (the whole package's by default)."""
    port = {m: _public(t, port_classes) for m, t in port_modules.items()}
    gone, used = [], set()
    for module, tree in sorted(jax_modules.items()):
        for name in sorted(_public(tree, jax_classes)):
            where, entry = _counterpart(module, name)
            if entry is not None:
                used.add(entry)
            if where is not None and where[1] not in port.get(where[0], ()):
                gone.append(f"{module}: {name}")
    return gone, used


@pytest.mark.parametrize("module", sorted(_JAX_MODULES))
def test_every_public_name_has_a_counterpart(module):
    """Each public function, class and method of the JAX module has a
    counterpart at the mirrored path of the port (or a renamed one)."""
    gone, _ = missing({module: _JAX_MODULES[module]})
    assert gone == [], f"no counterpart in ratelimit_tpu_torch/: {gone}"


def test_every_table_entry_is_needed():
    """The rename and Pallas-only tables name only what the JAX package
    has, each entry with a reason, and each still used: a name the port
    has as it is needs no entry."""
    _, used = missing()
    for table in (NAMES, PALLAS_ONLY):
        for entry, value in table.items():
            assert entry in used, f"{entry} is no longer needed"
            assert value[-1], f"{entry} gives no reason"
    for module, (target, reason) in MODULES.items():
        assert module in _JAX_MODULES and target in _PORT_MODULES and reason
        assert module not in _PORT_MODULES, f"{module} exists in the port: no rename needed"


def test_a_name_the_port_lacks_is_found():
    """The check is live: a JAX module with a function, a class and a
    method the port does not have reports all three, and nothing else."""
    tree = ast.parse(
        "def set_stage_sink(fn):\n    pass\n\n"
        "class CounterEngine:\n    def reset(self):\n        pass\n    def gc(self, now):\n"
        "        pass\n    def _private(self):\n        pass\n\n"
        "class NoSuchClass:\n    pass\n\n"
        "def _hidden():\n    pass\n"
    )
    port = {"backends/engine.py": ast.parse(
        "class CounterEngine:\n    def gc(self, now):\n        pass\n")}
    gone, _ = missing({"backends/engine.py": tree}, port, _classes({"": tree}), _classes(port))
    assert gone == ["backends/engine.py: CounterEngine.reset", "backends/engine.py: NoSuchClass",
                    "backends/engine.py: set_stage_sink"]
