"""The benchmark is driven by data: every cell, configuration, traffic mix,
limit and per-layer metric that ``BENCHMARK.json`` names is a file found
by its name, and a new cell needs new files only."""

from __future__ import annotations

import ast
import json
import shutil
from pathlib import Path

import numpy as np
import pytest

from portbench import compare, gen, harness

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


def test_new_cell_needs_only_files(tmp_path):
    root, spec = _tiny_root(tmp_path)
    cell = harness.load_cell(root, spec, "tiny-storm")
    assert cell["config"]["nx"] == 12
    assert "tiny.cells" in [m["name"] for m in cell["per_layer"]]
    other = harness.load_cell(root, spec, CELLS[0])
    assert "tiny.cells" not in [m["name"] for m in other["per_layer"]]

    class Probe:
        raw = gen.make_raw(cell["config"], cell["traffic"], 5)

    assert harness.reader(cell["bench"], "tiny.cells").read(Probe) == 192


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
    if path.startswith("reference/"):
        assert "shud_tpu_torch" not in found
