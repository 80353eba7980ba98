"""A profiled slice of the window: device time by kernel, the device's
busy time, and the longest idle gaps by what the host was calling.

``torch.profiler`` records CUDA activity only (kernels, copies, sets,
and the CUDA runtime calls of every host thread), over a slice seconds
long that the caller sleeps through while the server runs. Nothing is
written to disk: the events are reduced in memory.
"""

from __future__ import annotations

import time

NAME_CHARS = 120
TOP = 10


def _union(intervals: list) -> tuple:
    """(total covered length, gaps between covered stretches as
    (start, end)) of (start, end) intervals."""
    total, gaps = 0.0, []
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            total += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total, gaps


def _events(prof) -> list:
    """(name, on_device, start_s, end_s) of every recorded event."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        on_device = ev.device_type().name == "CUDA"
        start = ev.start_ns() * 1e-9
        out.append((ev.name(), on_device, start,
                    start + ev.duration_ns() * 1e-9))
    return out


def reduce_events(events: list, window_s: float) -> dict:
    """The slice's numbers from its events: each device interval clipped
    to [first event, first event + window_s]. ``launches`` counts each
    device operation by the share of its run that lies in the slice."""
    if not events:
        return {"window_s": window_s, "busy_s": 0.0, "kernels": {},
                "launches": {}, "device_ops": [], "idle_gaps": []}
    lo = min(e[2] for e in events)
    hi = lo + window_s
    dev, host = [], []
    launches: dict = {}
    for name, on_device, s0, e0 in events:
        s, e = max(s0, lo), min(e0, hi)
        if e <= s:
            continue
        (dev if on_device else host).append((name, s, e))
        if on_device:
            launches[name] = launches.get(name, 0.0) + (e - s) / (e0 - s0)
    busy, gaps = _union([(s, e) for _, s, e in dev])
    kernels: dict = {}
    for name, s, e in dev:
        kernels[name] = kernels.get(name, 0.0) + (e - s)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:TOP]
    host.sort(key=lambda x: x[1])
    idle = []
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]:
        over = [(min(e, g1) - max(s, g0), n) for n, s, e in host
                if s < g1 and e > g0]
        label = max(over)[1] if over else "host code, no CUDA call"
        idle.append([label[:NAME_CHARS], g1 - g0])
    return {"window_s": window_s, "busy_s": busy, "kernels": kernels,
            "launches": launches,
            "device_ops": [[n[:NAME_CHARS], t] for n, t in top],
            "idle_gaps": idle}


def profile_slice(seconds: float) -> tuple:
    """Trace the card for ``seconds`` while other threads work: (the
    profiler, the slice's length). Reduce it with ``reduce_profile`` once
    the window has closed: reading the events holds the interpreter
    lock, which the engine's host loop needs."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        time.sleep(seconds)
        window_s = time.monotonic() - t0
    return prof, window_s


def reduce_profile(prof, window_s: float) -> dict:
    return reduce_events(_events(prof), window_s)


def kernel_seconds(trace: dict, pattern: str) -> float:
    """Device seconds of the kernels whose name holds ``pattern``."""
    return sum(t for n, t in trace["kernels"].items() if pattern in n)


def kernel_launches(trace: dict, pattern: str) -> float:
    """Runs in the slice of the kernels whose name holds ``pattern``."""
    return sum(c for n, c in trace.get("launches", {}).items()
               if pattern in n)
