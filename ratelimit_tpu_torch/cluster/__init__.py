"""Multi-replica scale-out: key-ownership routing across service
replicas (the rendezvous router, the proxy process and the fleet view),
counter handoff on membership change, and the fault injectors that
prove both.

Port of ratelimit_tpu/cluster/.  PEP-562 lazy on the router, as there:
the hashing and handoff halves are stdlib and numpy and are imported by
the replica backend (which must never pay a grpc import for them);
``ReplicaRouter`` pulls the wire protos only when used (the proxy
process, the cluster tests).  Nothing here touches a card but the
handoff's legs, through the engine.
"""

from .hashing import owner_of, routing_key  # noqa: F401


def __getattr__(name):
    if name == "ReplicaRouter":
        from .router import ReplicaRouter

        return ReplicaRouter
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
