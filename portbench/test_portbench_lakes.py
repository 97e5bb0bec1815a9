"""The lake basin's cell (``lakes-32k-storm``): its files found by name,
its own generator and reference, the rooflines' work counting the lakes'
tables, and the reader of ``lake.stage_us``: its arithmetic on a fake
program, and nothing read on a lake-free cell or from a program without
the lakes' stage clock.  The port's RHS against the reference's, the
generator's basin and a replay against the reference are in
``tests/test_torch_lakebasin.py``; the clock on the card in
``tests/test_torch_kernels.py``."""

from __future__ import annotations

import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import gen, harness, work
from portbench.program import Program

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "portbench"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "lakes-32k-storm"


def test_cell_takes_its_own_generator_and_reference():
    cell = harness.load_cell(ROOT, SPEC, CELL)
    h = cell["hooks"]
    assert h.generator.__name__ == "portbench.generators.lakebasin"
    assert h.program is Program
    assert h.reference.__name__ == "portbench.lakes"
    assert h.ref("driver").__name__ == "portbench.lakes.driver"
    entry = next(c for c in SPEC["configs"] if c["name"] == "lakes-32k")
    assert entry["reduced"] == [] and len(entry["source"]) <= 200
    assert "lake.stage_us" in [m["name"] for m in cell["per_layer"]]
    for other in (w["name"] for w in SPEC["workloads"] if w["name"] != CELL):
        got = harness.load_cell(ROOT, SPEC, other)["per_layer"]
        assert "lake.stage_us" not in [m["name"] for m in got]
    # every accepted per-layer metric reads in the new cell too
    assert {m["name"] for m in cell["per_layer"]} == {
        m["name"] for m in SPEC["per_layer"]}


def _small():
    cell = harness.load_cell(ROOT, SPEC, CELL)
    cfg = dict(cell["config"], nx=16, ny=12)
    return cell, gen.make_raw(cfg, cell["traffic"],
                              generator=cell["hooks"].generator)


def test_work_counts_the_lake_tables():
    """The rooflines' work on the basin counts the lakes' gather lists:
    the same mesh with its lakes turned to land and its reaches to
    outlets reads at least their entries fewer."""
    cell, raw = _small()
    lakes = cell["hooks"].reference
    wet = work.evaluation_work(raw, 4, lakes)
    down = raw["riv"][:, 1]
    riv = raw["riv"].copy()
    riv[:, 1] = np.where(down <= -4, -3, down)
    att = raw["att"].copy()
    att[:, 8] = 0
    dry = work.evaluation_work(dict(raw, riv=riv, att=att, lake_bathy=None),
                               4, lakes)
    h = cell["hooks"]
    inp = gen.to_input(raw, h.ref("project"), ".")
    dm = h.ref("device").to_torch(h.ref("mesh").build_mesh(inp),
                                  torch.float64, "cpu")
    lists = dm.lists
    entries = sum(getattr(lists, k).numel() for k in (
        "cell_to_lake", "edge_to_lake", "riv_to_lake"))
    assert wet["rhs"][0] - dry["rhs"][0] >= 4 * entries
    assert wet["rhs"][1] > dry["rhs"][1]
    assert wet["jv"][0] > dry["jv"][0]


class _Graph:
    """An interval graph's stand-in: built, closed."""

    made = []

    def __init__(self, sim, w_max, capture):
        self.w_max, self.capture, self.closed = w_max, capture, False
        _Graph.made.append(self)

    def close(self):
        self.closed = True


def _fake_probe(nl=3, graph=True, mega=True):
    tables = SimpleNamespace(ne=384, nr=131, ns=231, nl=nl)
    sim = SimpleNamespace(interval=_Graph(None, 6, True) if graph else None,
                          mega=tables if mega else None)
    prog = SimpleNamespace(sim=sim, n_intervals=2, restore=lambda: None,
                           interval=lambda: None)
    return SimpleNamespace(prog=prog)


def test_stage_reader_arithmetic(monkeypatch):
    """The slowest lake's RHS and J·v nanoseconds over the RHS and J·v
    calls of the replays, in microseconds; the diagnostics left out; the
    graph built for it closed and the window's put back; tracing off."""
    from shud_tpu_torch import trace
    from shud_tpu_torch.core import mega

    counts = iter([{"mega_rhs": 10, "mega_jvp": 30, "mega_diag": 4},
                   {"mega_rhs": 12, "mega_jvp": 36, "mega_diag": 5}])
    monkeypatch.setattr(mega, "device_launch_counts", lambda: next(counts))
    monkeypatch.setattr(mega, "reset_lake_stage", lambda t: None)
    monkeypatch.setattr(mega, "lake_stage_ns", lambda t: {
        "mega_rhs": [2000, 8000, 100], "mega_jvp": [6000, 16000, 300],
        "mega_diag": [10**9, 10**9, 10**9]})
    probe = _fake_probe()
    window = probe.prog.sim.interval
    value = harness.reader(BENCH, "lake.stage_us").read(probe)
    assert value == pytest.approx((8000 + 16000) / 8 / 1e3)
    assert probe.prog.sim.interval is window
    assert _Graph.made[-1].closed and not trace.enabled()


@pytest.mark.parametrize("case", ("no lake", "edge path", "no graph"))
def test_stage_reader_none_without_lakes(case):
    probe = {"no lake": _fake_probe(nl=0), "edge path": _fake_probe(
        mega=False), "no graph": _fake_probe(graph=False)}[case]
    assert harness.reader(BENCH, "lake.stage_us").read(probe) is None


def test_stage_reader_none_for_a_program_without_the_clock(monkeypatch):
    from shud_tpu_torch.core import mega

    monkeypatch.delattr(mega, "lake_stage_ns")
    assert harness.reader(BENCH, "lake.stage_us").read(_fake_probe()) is None
