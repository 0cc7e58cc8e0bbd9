"""One minus the device's busy time (the union of every activity
torch.profiler saw) over the capture's host window, in percent.  Only a
capture whose kernels match the program's launch count is read."""


def read(run):
    got = run.get("capture")
    if not got:
        return None
    return 100.0 * (1.0 - got["busy_s"] / got["window_s"])
