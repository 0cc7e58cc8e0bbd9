"""Build, load and count the hand-written CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into
its own shared library with a plain C interface under ``_build/``
(listed in ``.gitignore``), and is loaded with ``ctypes``.  Sources
build at first use, or all together (one ``nvcc`` per source, started
in parallel) through :func:`build_all`.  A library's file name carries
a digest of its source, the shared ``csrc/*.cuh`` headers and the
flags, so a changed source or header rebuilds and an unchanged one
loads as is.

Nothing here runs at import: the CPU tests import every module of the
package on a machine without ``nvcc``.  A wrapper calls
:func:`library` only when it has a CUDA tensor in hand; a failed build
or launch raises, and there is no fallback to the plain versions.

``launches`` counts kernel launches by kernel name.  Every wrapper adds
one where it launches its kernel, and nowhere else, so a run can show
that its main path went through the kernels.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")

#: library name -> source file under csrc/
SOURCES = {
    "prefix": "prefix.cu",
    "fixed_window": "fixed_window.cu",
    "algorithms": "algorithms.cu",
    "sharded": "sharded.cu",
}

NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xptxas=-v",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)

_VP = ctypes.c_void_p
_I32 = ctypes.c_int
_I64 = ctypes.c_longlong
_F32 = ctypes.c_float

#: The general step's arguments after its table (counts and its shape):
#: slots, hits, fresh, limits, shadow, near_ratio, afters, incl, out,
#: set_lc, epilogue, n, stream (csrc/counter_update.cuh,
#: launch_general_step).
_GENERAL_STEP = [_VP, _VP, _VP, _VP, _VP, _F32, _VP, _VP, _VP, _VP, _I32, _I32, _VP]

#: C signatures: name -> (library, argtypes).  Every function returns
#: the cudaError_t of its launch(es) as an int (0 = success).
SIGNATURES = {
    "rl_per_slot_inclusive_prefix": ("prefix", [_VP, _VP, _VP, _I32, _VP]),
    "rl_fw_unique_step": (
        "fixed_window",
        [_VP, _I64, _VP, _I32, _VP, _I32, _VP],
    ),
    "rl_fw_unique_step_lanes": (
        "fixed_window",
        [_VP, _I64, _VP, _I32, _VP, _I32, _VP],
    ),
    "rl_mapped_alias": ("fixed_window", [_VP, ctypes.POINTER(_VP)]),
    "rl_fw_general_step": (
        "fixed_window",
        [_VP, _I64, *_GENERAL_STEP],
    ),
    "rl_fw_decision_block": (
        "fixed_window",
        [_VP, _VP, _VP, _VP, _F32, _I32, _VP, _VP, _VP],
    ),
    "rl_sw_serve_step": ("algorithms", [_VP, _I64, _VP, _I32, _I32, _VP, _VP]),
    "rl_gcra_serve_step": ("algorithms", [_VP, _I64, _VP, _I32, _I32, _VP, _VP]),
    "rl_sw_serve_step_lanes": ("algorithms", [_VP, _I64, _VP, _I32, _I32, _VP, _VP]),
    "rl_gcra_serve_step_lanes": ("algorithms", [_VP, _I64, _VP, _I32, _I32, _VP, _VP]),
    "rl_sharded_routed_step": (
        "sharded",
        [_VP, _I64, _VP, _I32, _I32, _VP, _I32, _VP],
    ),
    "rl_sharded_routed_step_lanes": (
        "sharded",
        [_VP, _I64, _VP, _I32, _I32, _VP, _I32, _VP],
    ),
    "rl_sharded_general_step": (
        "sharded",
        [_VP, _I32, _I64, *_GENERAL_STEP],
    ),
}

#: Launch counts by kernel name (see module docstring).
launches: collections.Counter = collections.Counter()

#: nvcc's output (ptxas register/shared-memory report) per library,
#: filled by the builds this process ran.
build_logs: Dict[str, str] = {}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


class KernelError(RuntimeError):
    """A kernel failed to build, load or launch.  `code` is the
    cudaError_t a launch returned (None for a build or load failure)."""

    def __init__(self, message: str, code=None):
        super().__init__(message)
        self.code = code


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        candidate = "/usr/local/cuda/bin/nvcc"
        if os.path.exists(candidate):
            nvcc = candidate
    if nvcc is None:
        raise KernelError(
            "nvcc not found: the CUDA kernels build only where the CUDA "
            "toolkit is installed"
        )
    return nvcc


def _so_path(name: str) -> str:
    h = hashlib.sha256()
    # The source and every shared header it may include.
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for f in (SOURCES[name], *headers):
        with open(os.path.join(CSRC_DIR, f), "rb") as fh:
            h.update(fh.read())
    h.update("\0".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build_all(names=None) -> Dict[str, float]:
    """Build every missing library, one nvcc per source, all started
    together; returns the wall seconds each build took (0.0 for one
    already built).  Raises KernelError naming every source that
    failed, with nvcc's output."""
    names = list(SOURCES) if names is None else list(names)
    with _LOCK:
        return _build_locked(names)


def _build_locked(names) -> Dict[str, float]:
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = None
    procs = {}
    seconds: Dict[str, float] = {}
    for name in names:
        path = _so_path(name)
        if os.path.exists(path):
            seconds[name] = 0.0
            continue
        nvcc = nvcc or find_nvcc()
        tmp = f"{path}.tmp.{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, SOURCES[name])]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
            tmp,
            path,
            time.perf_counter(),
        )
    failed = []
    for name, (proc, tmp, path, t0) in procs.items():
        try:
            out, _ = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
            out += "\n(nvcc timed out after 600 s)"
        seconds[name] = time.perf_counter() - t0
        build_logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{SOURCES[name]} (rc={proc.returncode}):\n{out}")
            if os.path.exists(tmp):
                os.unlink(tmp)
            continue
        os.replace(tmp, path)
    if failed:
        raise KernelError("kernel build failed: " + "\n".join(failed))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library `name`, building it first when needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        _build_locked([name])
        path = _so_path(name)
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            raise KernelError(f"cannot load {path}: {e}") from e
        for fn, (owner, argtypes) in SIGNATURES.items():
            if owner != name:
                continue
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _LIBS[name] = lib
        return lib


def function(fn: str):
    """The ctypes function `fn` (see SIGNATURES)."""
    return getattr(library(SIGNATURES[fn][0]), fn)


def check(rc: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if rc != 0:
        raise KernelError(f"{kernel}: CUDA launch failed with error {rc}", code=rc)


def mapped_alias(host_ptr: int) -> int:
    """The device address through which a kernel reaches the pinned
    host memory at `host_ptr` (cudaHostGetDevicePointer); raises
    KernelError where there is none."""
    dev = ctypes.c_void_p()
    check(function("rl_mapped_alias")(host_ptr, ctypes.byref(dev)), "rl_mapped_alias")
    return dev.value or 0


def stream_ptr(device) -> int:
    """Raw handle of the current CUDA stream on `device`."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
