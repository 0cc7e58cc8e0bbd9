"""Device activity from torch.profiler, held to the program's own launch
count.

torch.profiler loses device activities now and then, in a process past
its first minute about every other session (the program's
scripts/torch_profiler_window.py showed it).  So a capture counts only
when the kernels it saw match the launches the program's wrappers counted
(``ratelimit_tpu_torch.kernels.launches``) while it ran, and one that does
not is taken again, as the program's chip_smoke.py takes its captures
again (``PROFILE_TRIES``).  A traced run that gets no whole capture reports no
share from one: the readers find nothing and the metrics are left out.

The launches of a served window come from other threads, so the count is
bracketed: a kernel counted after the profiler started and before the
synchronize that ends the work must be seen; one counted at any time
around the session may be.
"""

from __future__ import annotations

import time


def launched() -> int:
    """Kernel launches the program has counted so far."""
    from ratelimit_tpu_torch import kernels

    return sum(kernels.launches.values())


def launches_by_name() -> dict:
    from ratelimit_tpu_torch import kernels

    return dict(kernels.launches)


def is_copy(name: str) -> bool:
    return name.startswith("Memcpy") or name.startswith("Memset")


def take(torch, work, tries: int):
    """Run `work()` under the profiler until a whole capture, at most
    `tries` times.  Returns a dict (activities: [(name, start_us, dur_us)]
    in time order, kernels: the kernel activities, window_s: host seconds
    of the work, launches: the program's launches by kernel name) or None
    where no capture was whole."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(tries):
        names = launches_by_name()
        before = launched()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            first = launched()
            t0 = time.perf_counter()
            work()
            last = launched()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        after = launched()
        acts = sorted(
            (
                (ev.name, float(ev.time_range.start), float(ev.time_range.elapsed_us()))
                for ev in prof.events()
                if ev.device_type == cuda
            ),
            key=lambda a: a[1],
        )
        kernels = [a for a in acts if not is_copy(a[0])]
        if last - first <= len(kernels) <= after - before and kernels:
            now = launches_by_name()
            launches = {k: v - names.get(k, 0) for k, v in now.items() if v != names.get(k, 0)}
            return dict(activities=acts, kernels=kernels, window_s=t1 - t0, launches=launches)
    return None


def busy_s(acts) -> float:
    """Seconds in which some device activity ran (the union of their
    intervals)."""
    total, end = 0.0, None
    for _name, start, dur in acts:
        stop = start + dur
        if end is None or start >= end:
            total += dur
            end = stop
        elif stop > end:
            total += stop - end
            end = stop
    return total / 1e6


def breakdown(acts) -> dict:
    """The ten device operations that took most time, and the ten longest
    idle gaps, each named by the activity before it."""
    by_name = {}
    for name, _start, dur in acts:
        by_name[name] = by_name.get(name, 0.0) + dur / 1e6
    gaps, end, prev = [], None, None
    for name, start, dur in acts:
        if end is not None and start > end:
            gaps.append([f"after {prev}", (start - end) / 1e6])
        if end is None or start + dur > end:
            end, prev = start + dur, name
    return {
        "device_ops": sorted(([k, v] for k, v in by_name.items()), key=lambda x: -x[1])[:10],
        "idle_gaps": sorted(gaps, key=lambda x: -x[1])[:10],
    }
