"""Bank-sharded counter tables.

Port of ratelimit_tpu/parallel: the slot space split into banks
(modulo striping, slot % num_banks), served by a routed unique step
(K6) and updated by a duplicate-tolerant general step (K7).  A mesh
here is a number of banks on ONE CUDA device; a mesh across several
cards is refused (ROADMAP.md, Queue 3).
"""

from .sharded import Mesh, ShardedCounterEngine, ShardedFixedWindowModel, make_mesh

__all__ = ["Mesh", "ShardedCounterEngine", "ShardedFixedWindowModel", "make_mesh"]
