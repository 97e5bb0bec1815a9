"""The benchmark is driven by data: every cell, configuration, traffic mix,
limit and per-layer metric that ``BENCHMARK.json`` names is a file found
by its name, a configuration's own generator, program and reference too,
and a new cell needs new files only."""

from __future__ import annotations

import ast
import json
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import compare, gen, harness, work
from portbench.program import Program

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "portbench"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
FORBIDDEN = {"jax", "jaxlib", "flax", "shud_tpu"}


@pytest.mark.parametrize("workload", CELLS)
def test_cell_files_found_by_name(workload):
    cell = harness.load_cell(ROOT, SPEC, workload)
    assert cell["config"]["name"] == next(
        w["config"] for w in SPEC["workloads"] if w["name"] == workload)
    assert cell["limits"] and set(cell["limits"]) <= set(compare.NUMBERS)
    assert {"start_min", "end_min", "interval_min"} <= set(cell["traffic"])
    assert {m["name"] for m in cell["end_to_end"]} >= {"setup_s"}
    assert cell["per_layer"], "every cell reports a per-layer metric"
    for m in cell["per_layer"]:
        assert callable(harness.reader(BENCH, m["name"]).read)
    # no configuration of the repository names a hook: the defaults
    assert not set(cell["config"]) & set(harness.DEFAULT_HOOKS)
    h = cell["hooks"]
    assert h.generator.__name__ == "portbench.generators.hillslope"
    assert h.program is Program
    assert h.reference.__name__ == "portbench.reference"


def test_contract_keys_and_files():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert len(w["why"]) <= 200
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert {m["moves"] for m in SPEC["per_layer"]} <= e2e


def _tiny_root(tmp_path: Path) -> tuple:
    """A checkout-like directory holding the benchmark's files plus one
    tiny cell added by files alone: a configuration, a traffic mix, its
    limits and a per-layer metric reader."""
    root = tmp_path / "root"
    bench = root / "portbench"
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(BENCH / sub, bench / sub)
    spec = json.loads(json.dumps(SPEC))
    cfg = json.loads((BENCH / "configs" / "mega-32k.json").read_text())
    cfg.update(name="tiny", nx=12, ny=8, path="edge")
    (bench / "configs" / "tiny.json").write_text(json.dumps(cfg))
    traffic = json.loads((BENCH / "traffic" / "storm.json").read_text())
    traffic.update(end_min=840.0)
    (bench / "traffic" / "tiny-storm.json").write_text(json.dumps(traffic))
    (bench / "limits" / "tiny-storm.json").write_text(
        json.dumps({"water_wrms": 5.0, "flow_gap": 0.1}))
    (bench / "metrics" / "tiny.cells.py").write_text(
        "def read(probe):\n    return len(probe.raw['tri'])\n")
    spec["configs"].append({"name": "tiny", "source": "test",
                            "file": "portbench/configs/tiny.json",
                            "reduced": ["nx", "ny"], "why": "test"})
    spec["workloads"].append({"name": "tiny-storm", "config": "tiny",
                              "traffic": "tiny-storm", "chips": 1,
                              "why": "test"})
    spec["per_layer"].append({"name": "tiny.cells", "unit": "cells",
                              "better": "higher", "source": "host_clock",
                              "layer": "test", "moves": "setup_s",
                              "workloads": ["tiny-storm"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root, spec


# a configuration's own generator, program and reference, as test doubles
# that record their calls: the hillslope, the default program on the CPU,
# the default reference on the CPU
DOUBLES = {
    "generators/double.py": """
from portbench.generators import hillslope

CALLS = []


def make(config, traffic):
    CALLS.append(config["name"])
    return dict(hillslope.make(config, traffic), made_by="double")
""",
    "programs/double.py": """
from portbench import program

BUILT = []


class Program(program.Program):
    def __init__(self, raw, config, traffic, device, where):
        BUILT.append((raw.get("made_by"), device))
        super().__init__(raw, config, traffic, "cpu", where)
""",
    "doubleref/__init__.py": '"""The reference, recorded."""\n',
    "doubleref/driver.py": """
from portbench.reference import driver

CALLS = []


def simulate(inp, interval_min, device, round_inputs=None):
    CALLS.append((len(inp.tri), device))
    return driver.simulate(inp, interval_min, "cpu", round_inputs)
""",
    "doubleref/project.py": """
from portbench.reference.project import (  # noqa: F401
    Calib, Control, FilePaths, ForcingCSV, ProjectInput)
""",
}


def _module_of(cls):
    return sys.modules[cls.__module__]


def _own_root(tmp_path: Path) -> tuple:
    """``_tiny_root`` plus a configuration ``tiny-own`` that names its own
    generator, program and reference, added by files alone, and its cell
    ``tiny-own-storm``."""
    root, spec = _tiny_root(tmp_path)
    bench = root / "portbench"
    for rel, text in DOUBLES.items():
        (bench / rel).parent.mkdir(parents=True, exist_ok=True)
        (bench / rel).write_text(text.lstrip())
    cfg = json.loads((bench / "configs" / "tiny.json").read_text())
    cfg.update(name="tiny-own", generator="double", program="double",
               reference="doubleref")
    (bench / "configs" / "tiny-own.json").write_text(json.dumps(cfg))
    shutil.copy(bench / "limits" / "tiny-storm.json",
                bench / "limits" / "tiny-own-storm.json")
    spec["configs"].append({"name": "tiny-own", "source": "test",
                            "file": "portbench/configs/tiny-own.json",
                            "reduced": ["nx", "ny"], "why": "test"})
    spec["workloads"].append({"name": "tiny-own-storm", "config": "tiny-own",
                              "traffic": "tiny-storm", "chips": 1,
                              "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root, spec


def test_new_cell_needs_only_files(tmp_path):
    root, spec = _own_root(tmp_path)
    cell = harness.load_cell(root, spec, "tiny-storm")
    assert cell["config"]["nx"] == 12
    assert "tiny.cells" in [m["name"] for m in cell["per_layer"]]
    other = harness.load_cell(root, spec, CELLS[0])
    assert "tiny.cells" not in [m["name"] for m in other["per_layer"]]

    class Probe:
        raw = gen.make_raw(cell["config"], cell["traffic"], 5)

    assert harness.reader(cell["bench"], "tiny.cells").read(Probe) == 192
    # the hooks a configuration names are its files under the checkout
    h = harness.load_cell(root, spec, "tiny-own-storm")["hooks"]
    bench = (root / "portbench").resolve()
    assert Path(h.generator.__file__) == bench / "generators" / "double.py"
    assert Path(_module_of(h.program).__file__) == (
        bench / "programs" / "double.py")
    assert Path(h.ref("driver").__file__) == bench / "doubleref" / "driver.py"
    assert h.program is not Program and issubclass(h.program, Program)


@pytest.mark.parametrize("workload", CELLS)
def test_default_hooks_named_are_the_defaults(workload):
    """A configuration that names ``hillslope``, ``program`` and
    ``reference`` gets the watershed, program and work of one that names
    nothing."""
    cell = harness.load_cell(ROOT, SPEC, workload)
    cfg = dict(cell["config"], nx=12, ny=8)
    named = dict(cfg, generator="hillslope", program="program",
                 reference="reference")
    assert harness.hooks(BENCH, named) == harness.hooks(BENCH, cfg)
    a = gen.make_raw(cfg, cell["traffic"])
    b = gen.make_raw(named, cell["traffic"])
    c = gen.make_raw(cfg, cell["traffic"], generator=cell["hooks"].generator)
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            np.testing.assert_array_equal(a[k], c[k], err_msg=k)
    assert a["forc"]["t_min"][0].tobytes() == b["forc"]["t_min"][0].tobytes()
    assert a["control"] == b["control"]
    h = harness.hooks(BENCH, named)
    assert (work.evaluation_work(b, 4, h.reference)
            == work.evaluation_work(a, 4))


def test_own_hooks_are_the_ones_called(tmp_path, monkeypatch):
    """``make_raw``, ``run_cell``'s program and ``check`` call the
    configuration's own generator, program and reference: a run of the
    12 x 8 cell on the CPU (``run_cell`` with its card calls stubbed)."""
    root, spec = _own_root(tmp_path)
    h = harness.load_cell(root, spec, "tiny-own-storm")["hooks"]
    monkeypatch.setattr(h.generator, "CALLS", [])
    monkeypatch.setattr(_module_of(h.program), "BUILT", [])
    monkeypatch.setattr(h.ref("driver"), "CALLS", [])
    monkeypatch.setattr(harness, "check_device", lambda chips: {
        "platform": "cpu", "kind": "cpu", "count": chips})
    for name in ("reset_peak_memory_stats", "synchronize", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda: 0)
    threads = torch.get_num_threads()
    try:
        r = harness.run_cell(root, spec, "tiny-own-storm", 2**31 + 7, 0.5,
                             False, time.perf_counter())
    finally:
        torch.set_num_threads(threads)
    assert h.generator.CALLS == ["tiny-own"]
    assert _module_of(h.program).BUILT == [("double", "cuda")]
    assert h.ref("driver").CALLS == [(192, "cuda")]
    assert r["correct"] is True, r["compared"]


@pytest.mark.parametrize("kind", sorted(harness.DEFAULT_HOOKS))
def test_unknown_hook_refused(tmp_path, kind):
    """A configuration that names a generator, program or reference that
    is not there is refused by ``load_cell``, naming it."""
    root, spec = _tiny_root(tmp_path)
    path = root / "portbench" / "configs" / "tiny.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()),
                                    **{kind: "no-such-part"})))
    with pytest.raises(harness.Refused, match="no-such-part"):
        harness.load_cell(root, spec, "tiny-storm")


@pytest.mark.parametrize("package", ["program", "reference"])
def test_input_takes_lakes_and_initial_conditions(package):
    """``to_input`` passes a generator's ``ic``, ``lake_bathy`` and ``bc``
    into either package's ``ProjectInput``, copied."""
    if package == "program":
        from shud_tpu_torch.io import project
    else:
        from portbench.reference import project
    cfg = json.loads((BENCH / "configs" / "mega-32k.json").read_text())
    cfg.update(nx=12, ny=8)
    traffic = json.loads((BENCH / "traffic" / "storm.json").read_text())
    raw = gen.make_raw(cfg, traffic)
    ne, nr = len(raw["tri"]), len(raw["riv"])
    raw.update(
        ic={"ele": np.full((ne, 5), 0.5), "riv": np.full(nr, 0.2),
            "lake": np.array([1.5])},
        lake_bathy=[np.array([[1.0, 0.0, 1e4], [2.0, 3.0, 2e4]])],
        bc={"riv_y": (np.array([0.0, 1440.0]), np.ones((2, 1)))})
    inp = gen.to_input(raw, project, ".")
    for got, want in ((inp.ic["lake"], raw["ic"]["lake"]),
                      (inp.ic["ele"], raw["ic"]["ele"]),
                      (inp.lake_bathy[0], raw["lake_bathy"][0]),
                      (inp.bc["riv_y"][1], raw["bc"]["riv_y"][1])):
        np.testing.assert_array_equal(got, want)
        assert got is not want
    plain = gen.to_input(gen.make_raw(cfg, traffic), project, ".")
    assert plain.ic is None and plain.lake_bathy is None and plain.bc == {}


def test_unknown_workload_refused():
    with pytest.raises(harness.Refused):
        harness.load_cell(ROOT, SPEC, "no-such-cell")


def test_generator_is_the_repository_storm_watershed():
    """Seed 0 gives the watershed of the repository's generator with the
    storm at minute 720, shuffled by ``default_rng(0)`` and RCM-ordered."""
    from shud_tpu_torch.utils.reorder import localize_project, permute_project
    from shud_tpu_torch.utils.synthetic import make_synthetic_project

    cfg = json.loads((BENCH / "configs" / "mega-32k.json").read_text())
    cfg.update(nx=10, ny=6)
    traffic = json.loads((BENCH / "traffic" / "storm.json").read_text())
    raw = gen.make_raw(cfg, traffic, 0)
    inp = make_synthetic_project(10, 6, end_day=1.0)
    inp.forc.t_min = [t - 720.0 for t in inp.forc.t_min]
    perm = np.random.default_rng(0).permutation(inp.tri.shape[0])
    inp, _ = localize_project(permute_project(inp, perm))
    for k in ("tri", "nodes", "att", "riv", "rivseg", "rivtype", "soil",
              "geol", "lc", "lai", "mf"):
        np.testing.assert_array_equal(raw[k], getattr(inp, k), err_msg=k)
    np.testing.assert_array_equal(raw["forc"]["data"][0][:4],
                                  inp.forc.data[0][:4])
    np.testing.assert_array_equal(raw["forc"]["t_min"][0][:4],
                                  inp.forc.t_min[0][:4])


def test_orders_renumber_the_same_watershed():
    cfg = json.loads((BENCH / "configs" / "mega-32k.json").read_text())
    cfg.update(nx=10, ny=6)
    traffic = json.loads((BENCH / "traffic" / "storm.json").read_text())
    a = gen.make_raw(cfg, traffic, 2**31 + 11)
    b = gen.make_raw(cfg, traffic, 12)
    assert not np.array_equal(a["tri"], b["tri"])
    assert np.array_equal(gen.make_raw(cfg, traffic)["tri"],
                          gen.make_raw(cfg, traffic, 0)["tri"])
    for k in ("tri", "att"):
        assert np.array_equal(np.sort(a[k][:, 1:4], axis=0),
                              np.sort(b[k][:, 1:4], axis=0))


def _top_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(
    p.relative_to(BENCH).as_posix() for p in BENCH.rglob("*.py")
    if not p.name.startswith("test_")))
def test_no_jax_imports(path):
    """No module of the benchmark imports JAX or the JAX package (whole
    top-level names: the port's name begins with the JAX package's), and
    the reference imports nothing of the program."""
    found = _top_imports(BENCH / path)
    assert not found & FORBIDDEN, found & FORBIDDEN
    if path.startswith(("reference/", "generators/")):
        assert "shud_tpu_torch" not in found
