"""Map cells the native slot table's assign walk examined per lookup over
the window: the change of the engine's ``stat_probes`` over that of its
``stat_lookups`` (the table's own counters, stamped after each chunk's
assign).  A program without the counters reads nothing."""


def read(run):
    got = run.get("probes")
    return got[0] / got[1] if got and got[1] else None
