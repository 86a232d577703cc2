"""Reading torch.profiler's trace of a traced stretch: the device's
activities, its busy time, and where it sat idle.

The profiler records CUDA activity only (kernels, copies, memsets and the
host's CUDA runtime calls): recording every aten operator on the host as
well would slow the host, and the idle share would read the profiler. Its
timestamps are nanoseconds on the host's wall clock (time.time_ns()), the
device's converted onto it, so the harness's own phase marks line up with
them.
"""

from __future__ import annotations

import bisect


def events(prof):
    """(device, host): the trace's device activities and the host's CUDA
    runtime calls, each a list of (name, start_ns, end_ns) sorted by start."""
    from torch.autograd import DeviceType

    device, host = [], []
    for ev in prof.profiler.kineto_results.events():
        start = int(ev.start_ns())
        row = (ev.name(), start, start + int(ev.duration_ns()))
        if ev.device_type() == DeviceType.CUDA:
            device.append(row)
        else:
            host.append(row)
    device.sort(key=lambda r: r[1])
    host.sort(key=lambda r: r[1])
    return device, host


def union(intervals):
    """The merged (start, end) intervals that at least one interval covers
    (chip_smoke.py's union_ms, copied, returning the intervals)."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1][1] = b
        else:
            merged.append([a, b])
    return merged


def busy_seconds(device) -> float:
    """Seconds in which at least one device activity ran: overlaps count
    once."""
    return sum(b - a for a, b in union((s, e) for _, s, e in device)) / 1e9


def device_ops(device, top: int = 10):
    """[[name, seconds], ...]: the device activities that took the most
    time in all, summed by name."""
    total = {}
    for name, s, e in device:
        total[name] = total.get(name, 0) + (e - s)
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:top]
    return [[name[:200], ns / 1e9] for name, ns in ranked]


def idle_gaps(device, host, phases, top: int = 10):
    """[[label, seconds], ...]: the device's idle time inside the traced
    window, by what the host was doing. `phases` lists the harness's
    (phase, start_ns, end_ns) marks. A gap's time goes to each phase it
    overlaps; within a phase, the label names the CUDA runtime call that
    covers the overlap's midpoint, if one does ("phase:call"), else the
    phase alone (the host in Python)."""
    busy = union((s, e) for _, s, e in device)
    if not busy or not phases:
        return []
    w0, w1 = phases[0][1], phases[-1][2]
    gaps, prev = [], w0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, min(a, w1)))
        prev = max(prev, b)
    if prev < w1:
        gaps.append((prev, w1))
    phase_ends = [p1 for _, _, p1 in phases]
    host_starts = [s for _, s, _ in host]
    total = {}
    for g0, g1 in gaps:
        i = bisect.bisect_right(phase_ends, g0)
        while i < len(phases) and phases[i][1] < g1:
            name, p0, p1 = phases[i]
            i += 1
            lo, hi = max(g0, p0), min(g1, p1)
            if hi <= lo:
                continue
            mid = (lo + hi) // 2
            j = bisect.bisect_right(host_starts, mid) - 1
            call = host[j][0] if j >= 0 and host[j][2] > mid else None
            label = f"{name}:{call}" if call else name
            total[label] = total.get(label, 0) + (hi - lo)
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:top]
    return [[label[:200], ns / 1e9] for label, ns in ranked]
