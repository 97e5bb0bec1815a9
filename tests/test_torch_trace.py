"""The port's tracing (``shud_tpu_torch/trace.py``) and the interval
graph's stamps (``IntervalGraph.phases``), on the CPU.

* With tracing off the interval program holds no ``Stamp``, and its
  results are bitwise those of the program with stamps.
* With tracing on an interval's spans form the tree of the driver's
  steps (``shud.advance_interval`` over ``shud.interval.*``, then
  ``shud.fetch``), all with the interval's number; the stamp sums are
  not negative and the heads, solves and tails fit in the interval.
* Turning tracing on or off rebuilds the graph at the next interval.
* The span buffer is bounded; ``clear`` empties it; with tracing off the
  spans are still ranges of an active ``torch.profiler``.
The stamps on the card (``%globaltimer`` in the captured graph) are
tested in ``tests/test_torch_kernels.py`` (marker ``cuda``).
"""

import numpy as np
import pytest
import torch

from shud_tpu_torch import trace
from shud_tpu_torch.driver.fused import FusedSimulation, IntervalGraph
from shud_tpu_torch.driver.run_fast import _to_host
from shud_tpu_torch.solver.graph import If, Stamp, While
from shud_tpu_torch.utils.synthetic import make_synthetic_project

torch.set_num_threads(1)

NX, NY = 6, 4
MINUTES = 60.0  # six 10-minute windows an interval


@pytest.fixture(autouse=True)
def _tracing_off():
    trace.disable()
    trace.clear()
    yield
    trace.disable()
    trace.clear()


def _sim(path="edge"):
    """A 6x4 simulation on the CPU whose intervals run through an
    ``IntervalGraph`` with ``capture=False``."""
    sim = FusedSimulation.create(
        "synthetic", inp=make_synthetic_project(NX, NY, end_day=1.0),
        float_dtype=torch.float32 if path == "mega" else torch.float64,
        device="cpu", mega=(path == "mega"))
    sim.interval = IntervalGraph(sim, round(MINUTES / 10.0), capture=False)
    return sim


def _stamps(nodes) -> list:
    """The ``Stamp`` nodes of a program's node tree, in order."""
    out = []
    for n in nodes:
        if isinstance(n, Stamp):
            out.append(n)
        elif isinstance(n, (While, If)):
            out += _stamps(n.body)
    return out


def _shape(nodes) -> tuple:
    """A node tree with its predicates left out (they are closures)."""
    return tuple(n if isinstance(n, (str, Stamp))
                 else (type(n).__name__, _shape(n.body)) for n in nodes)


def _interval(sim):
    """One interval and its fetch, as ``run_project_fast`` makes them."""
    out = sim.advance_interval(MINUTES)
    return _to_host({"out": out, "y": sim.bdf.y})


def _same(a, b, what):
    if isinstance(a, dict):
        assert list(a) == list(b), what
        for k in a:
            _same(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), what
        for k, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}/{k}")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), what
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), what
    else:
        assert a == b and type(a) is type(b), (what, a, b)


@pytest.mark.parametrize("path", ("edge", "mega"))
def test_untraced_program_has_no_stamp_and_matches_traced(path):
    """Two intervals of one simulation untraced and of a twin traced: the
    untraced program holds no stamp, the traced one four (one before the
    windows, three in each); every result bitwise equal."""
    plain, traced = _sim(path), _sim(path)
    for _ in range(2):
        trace.disable()
        a = _interval(plain)
        trace.enable()
        b = _interval(traced)
        _same(a, b, "interval")
        _same(tuple(plain.bdf), tuple(traced.bdf), "bdf")
    assert _stamps(plain.interval.program.nodes) == []
    assert plain.interval.phases() is None
    assert [s.slot for s in _stamps(traced.interval.program.nodes)] == [
        0, 1, 2, 3]


def test_interval_spans_and_stamps():
    """One traced interval: its spans form the driver's tree and share
    its number; the stamp sums are not negative, and the heads, solves
    and tails together fit inside its ``shud.advance_interval``."""
    sim = _sim()
    trace.enable()
    _interval(sim)  # the graph with stamps
    sim.interval.reset_phases()
    trace.clear()
    _interval(sim)
    got = trace.spans()
    by_name = {}
    for s in got:
        by_name.setdefault(s.name, []).append(s)
    top = by_name["shud.advance_interval"]
    assert len(top) == 1 and top[0].parent == -1
    k, root = top[0].interval, top[0].index
    assert {s.interval for s in got} == {k}
    assert [(s.name, s.parent) for s in got] == [
        ("shud.advance_interval", -1),
        ("shud.interval.prepare", root),  # the windows' table rows
        ("shud.interval.prepare", root),  # the index buffer's fill
        ("shud.interval.launch", root),
        ("shud.interval.wait", root),
        ("shud.interval.copy_out", root),
        ("shud.fetch", -1)]
    assert all(s.end_ns >= s.start_ns for s in got)
    ph = sim.interval.phases()
    assert set(ph) == {"head_ns", "solve_ns", "tail_ns"}
    assert all(v >= 0 for v in ph.values()) and ph["solve_ns"] > 0
    assert sum(ph.values()) <= top[0].end_ns - top[0].start_ns
    sim.interval.reset_phases()
    assert set(sim.interval.phases().values()) == {0}


def test_toggling_tracing_rebuilds_the_graph():
    """Tracing on: a new graph with stamps at the next interval; off
    again: another, node for node the untraced one's."""
    sim = _sim()
    _interval(sim)
    g0 = sim.interval
    trace.enable()
    _interval(sim)
    g1 = sim.interval
    assert g1 is not g0 and g1.key != g0.key
    assert len(_stamps(g1.program.nodes)) == 4
    trace.disable()
    _interval(sim)
    g2 = sim.interval
    assert g2 is not g1 and g2.key == g0.key
    assert _shape(g2.program.nodes) == _shape(g0.program.nodes)
    assert g2.capture is False


def test_span_buffer_is_bounded(monkeypatch):
    """The newest spans are kept up to the capacity; ``clear`` empties
    the buffer; off, a span is the shared no-op."""
    assert trace.span("shud.fetch") is trace.span("shud.interval.wait")
    monkeypatch.setattr(trace, "_REC", trace.Recorder(capacity=8))
    trace.enable()
    with trace.span("outer"):
        for k in range(20):
            with trace.span(f"s{k}"):
                pass
    got = trace.spans()
    assert len(got) == 8
    assert [s.name for s in got] == ["outer"] + [f"s{k}" for k in
                                                 range(13, 20)]
    assert all(s.parent == got[0].index for s in got[1:])
    trace.clear()
    assert trace.spans() == []
    trace.disable()
    with trace.span("shud.fetch"):
        pass
    with trace.span("shud.setup.create", always=True):
        pass
    assert [s.name for s in trace.spans()] == ["shud.setup.create"]


def test_spans_are_profiler_ranges_with_tracing_off():
    """Under a CPU ``torch.profiler`` with tracing off, an interval's
    steps appear as ranges of the profile and none is recorded."""
    from torch.profiler import ProfilerActivity, profile

    sim = _sim()
    _interval(sim)
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _interval(sim)
    names = {e.name for e in prof.events()}
    assert {"shud.advance_interval", "shud.interval.prepare",
            "shud.interval.launch", "shud.interval.wait",
            "shud.interval.copy_out", "shud.fetch"} <= names
    assert trace.spans() == []


SETUP_STEPS = ("shud.setup.mesh", "shud.setup.tables")


@pytest.fixture
def recorder(monkeypatch):
    """A fresh recorder: no span or counter of other tests."""
    monkeypatch.setattr(trace, "_REC", trace.Recorder())


@pytest.mark.parametrize("path", ("edge", "mega"))
def test_create_records_setup_steps_with_tracing_off(recorder, path):
    """``create`` with tracing off records the mesh's and the tables'
    steps inside ``shud.setup.create``, one after the other, and states
    each one's nanoseconds as a counter."""
    _sim(path)
    got = {s.name: s for s in trace.spans()}
    assert set(got) == {"shud.setup.create", *SETUP_STEPS}
    create, mesh, tables = (got[n] for n in ("shud.setup.create",
                                             *SETUP_STEPS))
    assert mesh.parent == tables.parent == create.index
    assert create.start_ns <= mesh.start_ns <= mesh.end_ns
    assert mesh.end_ns <= tables.start_ns <= tables.end_ns <= create.end_ns
    counters = trace.counters()
    for name in SETUP_STEPS:
        assert counters[f"{name}_ns"] == got[name].end_ns - got[name].start_ns


def test_setup_counters_survive_clear(recorder):
    _sim()
    before = {k: v for k, v in trace.counters().items()
              if k.startswith("shud.setup.")}
    assert set(before) == {f"{n}_ns" for n in SETUP_STEPS}
    assert all(isinstance(v, int) and v > 0 for v in before.values())
    trace.clear()
    assert trace.spans() == []
    assert {k: trace.counters()[k] for k in before} == before


def test_fetch_states_its_bytes(recorder):
    """``_to_host`` states the bytes of the tensors it fetched, of every
    dtype, the last call's."""
    tree = {"a": torch.zeros(5, 3, dtype=torch.float32),
            "b": [torch.ones(7, dtype=torch.float64), 2.5],
            "c": {"d": torch.arange(4), "e": torch.zeros((), dtype=torch.int32),
                  "f": "text"}}
    _to_host(tree)
    assert trace.counters()["shud.fetch.bytes"] == 15 * 4 + 7 * 8 + 4 * 8 + 4
    _to_host({"y": torch.zeros(3, dtype=torch.float32), "n": 1})
    assert trace.counters()["shud.fetch.bytes"] == 12
    _to_host({"n": 1})
    assert trace.counters()["shud.fetch.bytes"] == 0


def _reader(name):
    from portbench import harness

    return harness.reader(harness.OWN, name)


def _probe(**trace_got):
    """A probe as the benchmark's readers see it after a traced window:
    the interval graph's counters and ``portbench/spans.py``'s readings
    (6 intervals, the fetch's mean span 250 us an interval)."""
    from types import SimpleNamespace

    got = {"intervals": 6, "span_us": {"shud.fetch": 250.0}}
    got.update(trace_got)
    return SimpleNamespace(graph_stats={"windows": 36}, _program_trace=got)


@pytest.mark.parametrize("name", ("setup.mesh_s", "driver.fetch_gbps"))
def test_readers_find_nothing_without_the_counters(recorder, name):
    """The benchmark's readers of the set-up and fetch counters give None
    for a program that states neither; with the counters they read them.
    Without an interval graph the fetch's reader has no span to read, and
    the set-up's reader still reads its counter."""
    read = _reader(name).read
    assert read(_probe()) is None
    trace.count("shud.setup.mesh_ns", 2_500_000_000)
    trace.count("shud.fetch.bytes", 50_000_000)
    want = {"setup.mesh_s": 2.5, "driver.fetch_gbps": 200.0}[name]
    assert read(_probe()) == pytest.approx(want)
    # no interval graph: no graph counters, and spans.py reads nothing
    graphless = _probe()
    graphless.graph_stats = graphless._program_trace = None
    if name == "setup.mesh_s":
        assert read(graphless) == pytest.approx(2.5)
    else:
        assert read(graphless) is None
