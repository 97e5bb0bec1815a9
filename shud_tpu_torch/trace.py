"""Spans of the port's host steps, on the clock the profiler shares.

A span is one host step of the program, named ``shud.<layer>.<step>``:
its start and end in ``time.perf_counter_ns()``, the span that encloses
it and the output interval it belongs to.  Each ``advance_interval``
takes the next interval number (``next_interval``); the spans opened
until the next one, the fetch of the interval's results among them,
carry it.  Spans are kept in memory, the newest ``CAPACITY``; nothing is
written out.

Recording is off by default.  ``enable()`` records the spans of every
interval; the steps that run once a process or once a graph build
(set-up, the library's load, a graph's build, the process's first
interval) are recorded always.  Whenever a ``torch.profiler`` session is
active, every span is also a host range of the profile under the same
name, recorded or not, so that a profiler trace (the CLI's ``--profile``)
places the host's steps beside the card's kernels.  With recording off
and no profiler, ``span`` returns one shared no-op context.

A counter is a number the program states (``count``, kept always, and
kept by ``clear``; ``counters()``): at set-up the mega path's lakes,
lake cells, widest lists and, on a lake mesh, stage C's gather rounds
(``shud.mega.*``), and the nanoseconds of the set-up's steps
(``shud.setup.mesh_ns``, ``shud.setup.tables_ns``: ``step``); at each
fetch the bytes it moved (``shud.fetch.bytes``).

The device's side is the stamps inside the interval graph
(``driver/fused.py`` ``IntervalGraph.phases``) and the mega kernels' lake
stage clock (``core/mega.py`` ``lake_stage_ns``), each on while tracing
is.

    from shud_tpu_torch import trace
    trace.enable()
    ...  # advance intervals
    for s in trace.spans():
        print(s.name, s.interval, (s.end_ns - s.start_ns) / 1e3, "us")
"""

from __future__ import annotations

import collections
import contextlib
import functools
import time
from typing import NamedTuple

import torch

CAPACITY = 65536


class Span(NamedTuple):
    index: int  # the order in which spans were opened in the process
    name: str
    start_ns: int  # time.perf_counter_ns()
    end_ns: int
    parent: int  # index of the enclosing span, -1 for none
    interval: int  # interval number, 0 before the process's first


class Recorder:
    """The recorder's state: on or off, the spans kept (oldest dropped),
    the indices of the spans open, the interval number."""

    def __init__(self, capacity: int = CAPACITY):
        self.on = False
        self.kept = collections.deque(maxlen=capacity)
        self.open = []
        self.opened = 0
        self.interval = 0
        self.counters = {}


_REC = Recorder()
_NOOP = contextlib.nullcontext()


class _Open:
    """One span being timed (*rec* None: a profiler range only)."""

    __slots__ = ("rec", "name", "range", "index", "parent", "interval",
                 "start", "end")

    def __init__(self, rec, name: str, profiling: bool):
        self.rec, self.name = rec, name
        # a host range only: ``record_function``'s user annotation also
        # puts a range on the card's timeline, over the kernels launched
        # inside it, which a trace's reduction would count as device work
        self.range = (torch._C._profiler._RecordFunctionFast(name)
                      if profiling else None)

    def __enter__(self):
        if self.range is not None:
            self.range.__enter__()
        rec = self.rec
        if rec is not None:
            self.index, rec.opened = rec.opened, rec.opened + 1
            self.parent = rec.open[-1] if rec.open else -1
            self.interval = rec.interval
            rec.open.append(self.index)
            self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if rec is not None:
            self.end = end = time.perf_counter_ns()
            rec.open.pop()
            rec.kept.append(Span(self.index, self.name, self.start, end,
                                 self.parent, self.interval))
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str, always: bool = False):
    """A context that times the step *name*: recorded when recording is
    on, or *always* (a step that runs once a process or a graph build),
    and a profiler range whenever a profiler is active."""
    rec = _REC
    if not (rec.on or always):
        if not torch.autograd._profiler_enabled():
            return _NOOP
        return _Open(None, name, True)
    return _Open(rec, name, torch.autograd._profiler_enabled())


def spanned(name: str, always: bool = False):
    """A decorator: each call of the function in ``span(name, always)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def timed(*args, **kwargs):
            with span(name, always):
                return fn(*args, **kwargs)
        return timed
    return wrap


@contextlib.contextmanager
def step(name: str):
    """A set-up step: ``span(name, always=True)``, whose nanoseconds are
    also stated as the counter ``<name>_ns`` when it ends (a counter
    outlives ``clear``, which drops the span)."""
    with span(name, always=True) as s:
        yield
    count(f"{name}_ns", s.end - s.start)


def record(name: str, start_ns: int, end_ns: int) -> None:
    """A span timed by the caller's own clock readings (each in
    ``time.perf_counter_ns()``), inside the span open now; recorded
    always."""
    rec = _REC
    index, rec.opened = rec.opened, rec.opened + 1
    rec.kept.append(Span(index, name, start_ns, end_ns,
                         rec.open[-1] if rec.open else -1, rec.interval))


def count(name: str, value) -> None:
    """State the counter *name* (kept always; a later value replaces
    it)."""
    _REC.counters[name] = value


def counters() -> dict:
    """The counters stated so far, by name."""
    return dict(_REC.counters)


def next_interval() -> int:
    """The next interval's number (the first is 1): the spans opened from
    now on belong to it."""
    _REC.interval += 1
    return _REC.interval


def enable() -> None:
    _REC.on = True


def disable() -> None:
    _REC.on = False


def enabled() -> bool:
    return _REC.on


def spans() -> list:
    """The spans kept, in the order they were opened."""
    return sorted(_REC.kept)


def clear() -> None:
    """Drop the spans kept (the open ones are still recorded when they
    end)."""
    _REC.kept.clear()
