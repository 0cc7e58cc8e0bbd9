"""Bank-sharded counter tables.

Port of ratelimit_tpu/parallel: the slot space split into banks
(modulo striping, slot % num_banks), served by a routed unique step
(K6) and updated by a duplicate-tolerant general step (K7).  A mesh
places its banks in groups, one device each (several groups may share
a card); ``make_mesh()`` gives one bank per visible card, as the JAX
package's takes every local device.
"""

from .sharded import Mesh, ShardedCounterEngine, ShardedFixedWindowModel, make_mesh

__all__ = ["Mesh", "ShardedCounterEngine", "ShardedFixedWindowModel", "make_mesh"]
