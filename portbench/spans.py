"""The program's own spans and device stamps, read once a traced run for
the readers that need them (``driver.host_us_per_interval``,
``window.head_us``, ``window.tail_us``, ``solver.newton_us``,
``setup.create_s``, ``setup.first_interval_s``).

``measure(probe)``, on its first call (the result is cached on the
probe): the set-up's spans kept since the process started (the
simulation's creation and the process's first interval, recorded with
tracing off too); then two more interval graphs of the simulation, one
built with the program's tracing on (with its stamps) and one without,
beside the one the window ran; then the cell's period replayed from the
snapshot in the order ``ORDER``: traced on the first, untraced on the
second, in turns (both graphs built after the profiled interval, so that
the comparison is not the profile's), then untraced on the window's
graph.  The traced replays give the stamp sums and walls, the spans,
Newton iterations and windows.  On stderr: the traced over the untraced
median wall (the tracing's cost), the window graph's median wall over
the probe's unprofiled replay wall (taken before the profiled interval:
how much replays slowed after it), the same for the new untraced graph,
each traced replay's heads, solves and tails over its wall, each span's
microseconds an interval, and the set-up's steps.

A program without ``shud_tpu_torch.trace`` (an older checkout) or without
an interval graph gives None: its readers then find nothing to read.
"""

from __future__ import annotations

import gc
import statistics
import sys
import time

# the replays: on the graph with stamps (tracing on), on one built beside
# it without, in turns, then on the graph the window ran
ORDER = ("traced", "untraced", "untraced", "traced", "traced", "untraced",
         "window", "window", "window")
REPLAYS = ORDER.count("traced")
# the host's steps an interval: the interval's span and its fetch, less
# the time the host is blocked until the graph has run
HOST = ("shud.advance_interval", "shud.fetch")
WAIT = "shud.interval.wait"


def measure(probe) -> "dict | None":
    """The readings above, measured once a probe."""
    if not hasattr(probe, "_program_trace"):
        probe._program_trace = _measure(probe)
    return probe._program_trace


def first_seconds(spans: list, name: str) -> "float | None":
    """The duration of the first span named *name*, in seconds."""
    for s in spans:
        if s.name == name:
            return (s.end_ns - s.start_ns) / 1e9
    return None


def host_ns(spans: list) -> int:
    """The host's nanoseconds in *spans*: ``HOST`` spans less ``WAIT``
    spans."""
    total = 0
    for s in spans:
        if s.name in HOST:
            total += s.end_ns - s.start_ns
        elif s.name == WAIT:
            total -= s.end_ns - s.start_ns
    return total


def mean_us(spans: list, intervals: int) -> dict:
    """Each span name's microseconds an interval."""
    out = {}
    for s in spans:
        out[s.name] = out.get(s.name, 0.0) + (s.end_ns - s.start_ns) / 1e3
    return {k: v / intervals for k, v in out.items()}


def _replay(prog) -> float:
    """One whole replay from the snapshot: its wall in seconds."""
    prog.restore()
    t0 = time.perf_counter()
    for _ in range(prog.n_intervals):
        prog.interval()
    return time.perf_counter() - t0


def _measure(probe) -> "dict | None":
    try:
        from shud_tpu_torch import trace
    except ImportError:
        return None
    from shud_tpu_torch.solver import bdf

    prog = probe.prog
    sim = prog.sim
    plain = sim.interval
    if plain is None:
        return None
    setup = trace.spans()
    got = {"create_s": first_seconds(setup, "shud.setup.create"),
           "first_interval_s": first_seconds(setup, "shud.advance_interval"),
           "setup_spans": {n: first_seconds(setup, n) for n in (
               "shud.setup.create", "shud.library.load", "shud.graph.build",
               "shud.graph.warmup", "shud.graph.capture",
               "shud.graph.instantiate")},
           "create_after_s": _since_start(setup)}
    gc.collect()
    gc.disable()
    graphs = {"window": plain}
    try:
        for kind in ("traced", "untraced"):
            (trace.enable if kind == "traced" else trace.disable)()
            sim.interval = graphs[kind] = type(plain)(sim, plain.w_max,
                                                      plain.capture)
            prog.restore()
            prog.interval()  # builds it
        trace.disable()
        trace.clear()
        stamped = graphs["traced"]
        phases, walls = [], {k: [] for k in graphs}
        iters = windows = 0
        for kind in ORDER:
            (trace.enable if kind == "traced" else trace.disable)()
            sim.interval = graphs[kind]
            it0, w0 = bdf.newton_iters, stamped.stats["windows"]
            stamped.reset_phases()
            walls[kind].append(_replay(prog))
            if kind == "traced":
                phases.append(stamped.phases())
                iters += bdf.newton_iters - it0
                windows += stamped.stats["windows"] - w0
        spans = trace.spans()
    finally:
        trace.disable()
        sim.interval = plain
        for kind in ("traced", "untraced"):
            if kind in graphs:
                graphs[kind].close()
        gc.enable()
    n = REPLAYS * prog.n_intervals
    got.update(newton_iters=iters, windows=windows, intervals=n,
               host_ns=host_ns(spans), span_us=mean_us(spans, n),
               phases={k: sum(p[k] for p in phases) for k in phases[0]},
               walls=walls)
    _report(got, phases, probe.device_time["wall_s"])
    return got


def _since_start(setup: list) -> "float | None":
    """Seconds from the process's start (``run.py``'s ``T_START``, on the
    spans' clock) to the simulation's creation."""
    t_start = getattr(sys.modules.get("__main__"), "T_START", None)
    first = [s for s in setup if s.name == "shud.setup.create"]
    if t_start is None or not first:
        return None
    return first[0].start_ns / 1e9 - t_start


def _report(got: dict, phases: list, unprofiled_wall: float) -> None:
    med = {k: statistics.median(v) for k, v in got["walls"].items()}
    shares = [sum(p.values()) / 1e9 / w
              for p, w in zip(phases, got["walls"]["traced"])]
    print(f"program trace: traced / untraced replay wall "
          f"{med['traced'] / med['untraced']!r}; replay walls {med!r} s; "
          f"after / before the profile: the window's graph "
          f"{med['window'] / unprofiled_wall!r}, a new one "
          f"{med['untraced'] / unprofiled_wall!r}; head+solve+tail / wall "
          f"{shares!r}; phases {got['phases']!r}; windows "
          f"{got['windows']}, Newton iterations {got['newton_iters']}, "
          f"intervals {got['intervals']}; us an interval "
          f"{got['span_us']!r}; set-up {got['setup_spans']!r}, process "
          f"start to create {got['create_after_s']!r} s", file=sys.stderr)
