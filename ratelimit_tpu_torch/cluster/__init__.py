"""The replica half of the cluster tier: key ownership (hashing.py),
counter handoff on membership change (handoff.py) and the fault
injectors that prove both (faults.py).

Port of ratelimit_tpu/cluster/ without its front tier: the rendezvous
router, the proxy process and the fleet view are still to be ported
(ROADMAP.md, Queue 1), so asking for ``ReplicaRouter`` raises.  The
modules here are stdlib and numpy, and touch a bank's tensors only
through the engine's handoff legs.
"""

from .hashing import owner_of, routing_key  # noqa: F401


def __getattr__(name):
    if name == "ReplicaRouter":
        raise AttributeError(
            f"module {__name__!r} has no attribute 'ReplicaRouter': the cluster's "
            "front tier (router, proxy, fleet) is not ported yet (ROADMAP.md, Queue 1)"
        )
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
