"""The benchmark's ``edge-2m`` configuration (``portbench/configs/
edge-2m.json``): the synthetic hillslope at 1024 x 1024 quads on the edge
path, checked here at 16 x 8 quads (256 cells) on the CPU.

* The file is ``edge-131k``'s uncut: the same settings, 1024 x 1024
  quads, on the edge path, listed in ``BENCHMARK.json`` with nothing
  ``reduced`` and one cell ``edge-2m-storm`` (storm traffic, one chip).
  The generator gives 2 nx ny cells and nx reaches and segments (checked
  at two small sizes), so the file gives 2,097,152 cells, 1,024 reaches
  and a state of 6,292,480 entries; the mesh itself is not built here at
  that size.
* The program (``portbench/program.py``: the port's ``FusedSimulation``,
  float32, on the edge path's plain versions on the CPU) replays the
  storm's first hour within one tolerance unit of the plain reference
  (``portbench/reference/``, float64, at the configuration's tolerances)
  in both WRMS numbers, on the configuration's cell numbering and on two
  others drawn from seeds; the reference on bfloat16 inputs (the
  calibration's control) misses by more than that.
* The configuration's own reference (``portbench/tight/``, which the
  benchmark compares against) runs ``reference/``'s solve at a tenth of
  the tolerances and, on the card, reads a result it kept for the same
  input back instead of solving again.
"""

import json
from pathlib import Path

import pytest
import torch

from portbench import compare, gen, harness
from portbench.program import Program

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NX, NY = 16, 8
# one tolerance unit: each adaptive solver keeps its local error a step
# under reltol * |w| + abstol, so two sound runs of an hour's few steps
# (float32 against float64) part by a fraction of it (~0.03 measured at
# this size), while bfloat16 inputs move the water by several units
UNIT = 1.0


def _config(nx=NX, ny=NY):
    cfg = json.loads((ROOT / "portbench/configs/edge-2m.json").read_text())
    return dict(cfg, nx=nx, ny=ny)


def _traffic():
    """The storm traffic, cut to its first output interval."""
    t = json.loads((ROOT / "portbench/traffic/storm.json").read_text())
    return dict(t, end_min=t["start_min"] + t["interval_min"])


def test_configuration_is_edge_131k_uncut():
    full = json.loads((ROOT / "portbench/configs/edge-2m.json").read_text())
    small = json.loads((ROOT / "portbench/configs/edge-131k.json").read_text())
    differ = {k for k in full if full[k] != small.get(k)}
    assert set(full) == set(small) | {"reference"}
    assert differ == {"name", "nx", "ny", "deployment", "reference",
                      "assumed"}
    # edge-131k's assumptions, and the scale's besides
    assert full["assumed"][:-1] == small["assumed"]
    assert full["assumed"][-1].startswith("the scale: 1024 x 1024 quads")
    assert full["reference"] == "tight"
    assert (full["nx"], full["ny"], full["path"]) == (1024, 1024, "edge")
    assert full["float"] == "float32"
    entry = {c["name"]: c for c in SPEC["configs"]}["edge-2m"]
    assert entry["reduced"] == []
    assert entry["file"] == "portbench/configs/edge-2m.json"
    cells = [w for w in SPEC["workloads"] if w["config"] == "edge-2m"]
    assert [(w["name"], w["traffic"], w["chips"]) for w in cells] == [
        ("edge-2m-storm", "storm", 1)]


@pytest.mark.parametrize("nx,ny", [(16, 8), (12, 20)])
def test_full_size_gives_two_million_cells(nx, ny):
    """The generator's sizes at small meshes, then the file's at full
    size."""
    raw = gen.make_raw(_config(nx, ny), _traffic())
    assert len(raw["tri"]) == 2 * nx * ny
    assert len(raw["riv"]) == len(raw["rivseg"]) == nx
    full = json.loads((ROOT / "portbench/configs/edge-2m.json").read_text())
    ne, nr = 2 * full["nx"] * full["ny"], full["nx"]
    assert (ne, nr, 3 * ne + nr) == (2_097_152, 1_024, 6_292_480)


@pytest.fixture(scope="module")
def cell():
    """The configuration and its hooks with the plain reference."""
    cfg = _config()
    return cfg, harness.hooks(harness.OWN, dict(cfg, reference="reference"))


@pytest.fixture(scope="module")
def tight():
    """The configuration and its own hooks: the tight reference."""
    cfg = _config()
    return cfg, harness.hooks(harness.OWN, cfg)


@pytest.mark.parametrize("order", [None, 12, 2**31 + 7])
def test_first_storm_hour_matches_the_reference(cell, order):
    cfg, hooks = cell
    traffic = _traffic()
    raw = gen.make_raw(cfg, traffic, order, hooks.generator)
    ref_inp = gen.to_input(raw, hooks.ref("project"), ".")
    ref = hooks.ref("driver").simulate(ref_inp, traffic["interval_min"],
                                       "cpu")
    prog = Program(raw, cfg, traffic, "cpu", ".")  # raises off the edge path
    assert prog.sim.mega is None and prog.sim.md.num_ele == 2 * NX * NY
    assert prog.sim.bdf.y.dtype == torch.float32
    prog.snapshot()
    got = [prog.interval() for _ in range(prog.n_intervals)]
    assert len(got) == 1 and got[0]["t"] == traffic["end_min"]
    numbers, _ = compare.gaps(got, ref, cfg["control"])
    assert numbers["water_wrms"] <= UNIT and numbers["state_wrms"] <= UNIT, (
        numbers)
    if order is None:
        control = hooks.ref("driver").simulate(
            ref_inp, traffic["interval_min"], "cpu",
            round_inputs=torch.bfloat16)
        missed, _ = compare.gaps(control, ref, cfg["control"])
        assert missed["water_wrms"] > UNIT and missed["state_wrms"] > UNIT, (
            missed)


def test_tight_reference_runs_at_a_tenth_of_the_tolerances(tight):
    """The configuration's reference is ``reference/``'s solve on the input
    with RELTOL and ABSTOL divided by ten, and the input is left as it
    was."""
    cfg, hooks = tight
    traffic = _traffic()
    raw = gen.make_raw(cfg, traffic, None, hooks.generator)
    inp = gen.to_input(raw, hooks.ref("project"), ".")
    drv = hooks.ref("driver")
    assert drv.__name__ == "portbench.tight.driver"
    tight = drv.tightened(inp)
    assert (tight.control.reltol, tight.control.abstol) == (1e-5, 1e-5)
    assert (inp.control.reltol, inp.control.abstol) == (1e-4, 1e-4)
    assert tight.tri is inp.tri
    # the modules the rooflines read are reference/'s own
    from portbench.reference import rhs
    assert hooks.ref("rhs")._rhs is rhs._rhs


def test_tight_reference_reads_back_what_it_kept(tight, tmp_path,
                                                  monkeypatch):
    """On the card a result is kept under the key of its input and read
    back by the next call with that input; another input, or the control's
    rounding, has another key.  (The read back is checked here by writing
    the CPU's solve where a card's call looks for it.)"""
    cfg, hooks = tight
    drv = hooks.ref("driver")
    monkeypatch.setattr(drv, "CACHE", tmp_path)
    traffic = _traffic()
    raw = gen.make_raw(cfg, traffic, None, hooks.generator)
    inp = gen.to_input(raw, hooks.ref("project"), ".")
    minutes = traffic["interval_min"]
    solved = drv.simulate(inp, minutes, "cpu")
    assert list(tmp_path.iterdir()) == []  # nothing kept off the card
    k = drv.key(drv.tightened(inp), minutes, None)
    assert k == drv.key(drv.tightened(inp), minutes, None)
    assert k != drv.key(drv.tightened(inp), minutes, torch.bfloat16)
    other = gen.to_input(gen.make_raw(cfg, traffic, 12, hooks.generator),
                         hooks.ref("project"), ".")
    assert k != drv.key(drv.tightened(other), minutes, None)
    drv._save(tmp_path / f"{k}.npz", solved)
    kept = drv.simulate(inp, minutes, "cuda")  # no solve: read back
    assert len(kept) == len(solved) == 1
    for a, b in zip(kept, solved):
        assert a["t"] == b["t"]
        for name in ("y", "sy", "q_riv_down"):
            assert a[name].dtype == b[name].dtype
            assert (a[name] == b[name]).all(), name
