"""Reduction of a ``torch.profiler`` trace of one replay: the device's
busy time (the union of the intervals in which an operation ran on the
card), its operations by time, its launches, and the longest idle gaps
named by what the host was doing meanwhile."""

from __future__ import annotations

import time

import torch


def start_tracing() -> None:
    """One empty profiler session: CUDA's activity tracing records the
    kernels of a graph only when the graph was instantiated after it
    started."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()


def profile_call(fn) -> dict:
    """Run *fn* once under the profiler (after a synchronize) and reduce
    the trace: ``wall_s``, ``busy_s``, ``launches``, ``device_ops`` and
    ``idle_gaps`` (each ``[[name, seconds], ...]``, at most 10)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev, host = [], []
    for e in prof.events():
        span = (e.time_range.start, e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            dev.append((span, e.name))
        else:
            host.append((span, e.name))
    return reduce(dev, host, wall)


def _is_transfer(name: str) -> bool:
    low = name.lower()
    return low.startswith("memcpy") or low.startswith("memset")


def reduce(dev: list, host: list, wall: float) -> dict:
    """The reduction of device spans and host spans (each ``((start_us,
    end_us), name)``) of a window of *wall* seconds."""
    by_name = {}
    for (s, e), name in dev:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    merged = []
    for (s, e), _ in sorted(dev):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged) / 1e6
    if host:  # the host's first and last moments bound the window
        merged = ([[min(s for (s, _), _ in host)] * 2] + merged
                  + [[max(e for (_, e), _ in host)] * 2])
    gaps = sorted(((b - a, a, b) for (_, a), (b, _) in
                   zip(merged, merged[1:]) if b > a), reverse=True)[:10]
    named = []
    for length, a, b in gaps:
        mid = 0.5 * (a + b)
        inside = [(e - s, name) for (s, e), name in host if s <= mid <= e]
        named.append([min(inside)[1] if inside else "host (no operator)",
                      length / 1e6])
    ops = sorted(([k, v] for k, v in by_name.items()), key=lambda g: -g[1])
    return {"wall_s": wall, "busy_s": busy,
            "launches": sum(not _is_transfer(n) for _, n in dev),
            "device_ops": ops[:10], "idle_gaps": named}
