"""fw_unique_step_mapped's share of its roofline in percent: the least time of the
captured chunks (roofline.least_seconds, from each chunk's distinct keys)
over their kernels' device time from torch.profiler.  Read only where every
launch of the capture was fw_unique_step_mapped and the capture saw each."""


def read(run):
    got = run.get("capture")
    if not got or set(got["launches"]) != {"fw_unique_step_mapped"}:
        return None
    return 100.0 * got["least_s"] / got["kernel_s"]
