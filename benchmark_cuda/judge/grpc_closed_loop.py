"""The served cells' comparison with the plain reference.

The clients kept every request with its answer and its send and reply
times; the driver kept the program's counters after the window.  A
request's window is the server clock's second at some instant between
send and reply, and concurrent requests are decided in the server's
order; neither is an input.  So the reference of the configuration's
algorithm (``reference/<algorithm>.py``, its ``served_checks``) asks for
each address whether some choice of windows and order explains every
answer and every counter the program still holds.

Check (limit 0): ``keys_wrong``, the addresses nothing explains (an
answer whose overall code is not its one descriptor's code included),
and counters the program holds for an address it was never sent.
"""

from __future__ import annotations


def judge(obs, control: bool = False) -> dict:
    import harness

    reference = harness.part("reference", obs["algorithm"])
    if not hasattr(reference, "served_checks"):
        raise ValueError(f"no served reference for {obs['algorithm']}")
    return {"keys_wrong": (reference.served_checks(obs, control), 0)}
