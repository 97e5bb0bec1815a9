"""The readers of the program's own spans and stamps
(``portbench/spans.py`` and its six metrics): their arithmetic on a fake
probe, nothing read from a program without tracing, the helper run on
the CPU at a tiny size through an interval graph with ``capture=False``,
and, on a card, a traced run of a real cell that prints them all."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import gen, harness, spans
from portbench.program import Program
from portbench.test_portbench_data import _tiny_root

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "portbench"
READERS = ("driver.host_us_per_interval", "window.head_us", "window.tail_us",
           "solver.newton_us", "setup.create_s", "setup.first_interval_s")


def _span(index, name, start_us, end_us, parent=-1, interval=1):
    from shud_tpu_torch.trace import Span

    return Span(index, name, int(start_us * 1e3), int(end_us * 1e3), parent,
                interval)


def test_span_arithmetic():
    """Host time: each interval's span and fetch less its wait; the first
    span of a name; the mean microseconds a name an interval."""
    got = [_span(0, "shud.advance_interval", 0, 1000),
           _span(1, "shud.interval.launch", 100, 150, 0),
           _span(2, "shud.interval.wait", 150, 900, 0),
           _span(3, "shud.fetch", 1000, 1200),
           _span(4, "shud.advance_interval", 2000, 2600, interval=2),
           _span(5, "shud.interval.wait", 2100, 2500, 4, 2),
           _span(6, "shud.fetch", 2600, 2700, interval=2)]
    want_us = (1000 + 200 - 750) + (600 + 100 - 400)
    assert spans.host_ns(got) == want_us * 1000
    assert spans.first_seconds(got, "shud.advance_interval") == 1e-3
    assert spans.first_seconds(got, "shud.setup.create") is None
    assert spans.mean_us(got, 2)["shud.interval.wait"] == pytest.approx(575)


def _fake(**trace) -> SimpleNamespace:
    base = {"create_s": 2.5, "first_interval_s": 1.25, "host_ns": 6_000_000,
            "intervals": 6, "windows": 36, "newton_iters": 360,
            "phases": {"head_ns": 3_600_000, "solve_ns": 18_000_000,
                       "tail_ns": 7_200_000}}
    base.update(trace)
    return SimpleNamespace(_program_trace=base)


@pytest.mark.parametrize("name,want", [
    ("driver.host_us_per_interval", 1000.0), ("window.head_us", 100.0),
    ("window.tail_us", 200.0), ("solver.newton_us", 50.0),
    ("setup.create_s", 2.5), ("setup.first_interval_s", 1.25)])
def test_reader_arithmetic(name, want):
    assert harness.reader(BENCH, name).read(_fake()) == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
def test_readers_find_nothing_without_program_trace(name):
    """A program without the trace module gives no reading; a replay
    without windows or Newton iterations gives none of what divides by
    them."""
    mod = harness.reader(BENCH, name)
    assert mod.read(SimpleNamespace(_program_trace=None)) is None
    empty = _fake(intervals=0, windows=0, newton_iters=0)
    assert (mod.read(empty) is None) == (not name.startswith("setup."))


def test_older_program_reads_nothing(monkeypatch):
    """Without ``shud_tpu_torch.trace`` (the parent of the tracing) the
    helper returns None and runs nothing."""
    import shud_tpu_torch

    monkeypatch.delattr(shud_tpu_torch, "trace")
    monkeypatch.setitem(sys.modules, "shud_tpu_torch.trace", None)
    probe = SimpleNamespace(prog=None)
    assert spans.measure(probe) is None


def test_measure_on_the_cpu(tmp_path):
    """The helper on the tiny cell on the CPU (an interval graph with
    ``capture=False``): the replays' windows and Newton iterations, the
    phases of every window, the host's time, each kind of replay's walls;
    the program's tracing off afterwards and its window graph back."""
    from shud_tpu_torch import trace
    from shud_tpu_torch.driver.fused import IntervalGraph

    torch.set_num_threads(1)
    root, spec = _tiny_root(tmp_path)
    cell = harness.load_cell(root, spec, "tiny-storm")
    raw = gen.make_raw(cell["config"], cell["traffic"])
    prog = Program(raw, cell["config"], cell["traffic"], "cpu",
                   str(root / "build"))
    plain = prog.sim.interval = IntervalGraph(prog.sim, 6, capture=False)
    prog.snapshot()
    prog.interval()
    prog.restore()
    probe = SimpleNamespace(prog=prog, device_time={"wall_s": 1.0})
    t = spans.measure(probe)
    assert spans.measure(probe) is t
    assert not trace.enabled() and prog.sim.interval.phases() is None
    n = prog.n_intervals
    assert t["intervals"] == spans.REPLAYS * n
    assert t["windows"] == spans.REPLAYS * n * 6
    assert t["newton_iters"] > 0 and t["host_ns"] > 0
    assert all(v >= 0 for v in t["phases"].values())
    assert sum(t["phases"].values()) <= 1e9 * sum(t["walls"]["traced"])
    assert {k: len(v) for k, v in t["walls"].items()} == {
        "traced": spans.REPLAYS, "untraced": spans.REPLAYS,
        "window": spans.ORDER.count("window")}
    assert prog.sim.interval is plain
    assert t["span_us"]["shud.advance_interval"] > 0
    for name in READERS:
        value = harness.reader(BENCH, name).read(probe)
        assert value is None or np.isfinite(value), name
    prog.close()


@pytest.mark.cuda
def test_traced_run_on_the_card():
    """One short traced run of the smallest cell on a card: correct, and
    the six readings of the program's spans and stamps in its line."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "mega-32k-storm",
         "--seed", str(2**31 + 11), "--seconds", "1", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] is True
    for name in READERS:
        assert r["metrics"][name]["value"] > 0, name
