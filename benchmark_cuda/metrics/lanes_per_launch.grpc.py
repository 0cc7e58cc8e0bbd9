"""Engine lanes over launches, from the program's launch recorder over the
window."""


def read(run):
    rec = run.get("launch_records")
    return float(rec["lanes"].sum()) / len(rec) if rec is not None and len(rec) else None
