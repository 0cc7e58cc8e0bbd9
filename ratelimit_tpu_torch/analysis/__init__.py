"""tpu-lint for the PyTorch/CUDA port: project-native static analysis
for torch host syncs, the CUDA kernels' C boundary and threaded-backend
lock discipline, plus the runtime lock sanitizer.

Port of ratelimit_tpu/analysis: the same engine, baseline ratchet,
whole-program index and concurrency rules, with the JAX-specific rules
replaced by torch twins (``torch-host-sync``, ``torch-dtype-
discipline``) and the ABI rule extended to the ``SIGNATURES`` table of
kernels.py and the ``extern "C"`` entries of csrc/*.cu.

Usage:
    python -m ratelimit_tpu_torch.analysis [paths...]

Pure stdlib (ast + tokenize + re): importable and runnable on machines
without torch, CUDA or grpc installed, so CI can gate on it before any
heavy dependency resolves.
"""

from .engine import (  # noqa: F401
    AnalysisEngine,
    FileContext,
    Finding,
    Rule,
    analyze_paths,
    run_paths,
)
from .project import ProjectIndex, ProjectRule  # noqa: F401
from .rules import DEFAULT_PROJECT_RULES, DEFAULT_RULES  # noqa: F401
