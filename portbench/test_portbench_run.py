"""A run's pieces on the CPU at a tiny size (the program, the window, the
reference's check and the result line, driven directly: the harness's
``run_cell`` runs on the card only): the result line's schema, ``correct``
false under each fault of the timed path that the cell can have, and the
refusals of ``run.py``; on a card, one short run of a real cell."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import gen, harness, trace
from portbench.program import Program
from portbench.test_portbench_data import _tiny_root

ROOT = Path(__file__).resolve().parent.parent


def _run(tmp_path, seed=2**31 + 3):
    """The tiny cell's run on the CPU, piece by piece as ``run_cell``
    makes it on the card."""
    root, spec = _tiny_root(tmp_path)
    cell = harness.load_cell(root, spec, "tiny-storm")
    raw = gen.make_raw(cell["config"], cell["traffic"])
    where = str(root / "build")
    t0 = time.perf_counter()
    prog = Program(raw, cell["config"], cell["traffic"], "cpu", where)
    prog.snapshot()
    prog.interval()
    prog.restore()
    run = {"setup_s": time.perf_counter() - t0, "peak_bytes": 0}
    run["window"] = harness.measure_window(
        prog, 0.5, np.random.default_rng([seed % 2**63, 1]))
    metrics = harness.end_to_end(cell, run)
    prog.close()
    numbers, failed = harness.check(raw, cell, run["window"]["sample"],
                                    "cpu", where)
    return harness.result_line(
        metrics, numbers, failed, cell["limits"], run["window"]["intervals"],
        {"platform": "cpu", "kind": "cpu", "count": 0,
         "memory_peak_bytes": 0})


def test_result_line_schema(tmp_path):
    r = _run(tmp_path)
    assert r["correct"] is True and r["failed"] == 0
    assert r["attempted"] >= 2
    # interval_p95_ms names its cells: the tiny cell is not among them
    assert set(r["metrics"]) == {"sim_days_per_s", "peak_mem_mib",
                                 "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in r["metrics"].values())
    assert r["metrics"]["sim_days_per_s"]["value"] > 0
    assert set(r["device"]) >= {"platform", "kind", "count",
                                "memory_peak_bytes"}
    assert list(r)[-1] == "compared"
    assert all(set(v) == {"value", "limit"} for v in r["compared"].values())
    json.dumps(r)


def test_trace_reduction():
    dev = [((0, 10), "k1"), ((5, 20), "k2"), ((40, 50), "k1")]
    host = [((0, 60), "cudaGraphLaunch"), ((25, 35), "aten::cat")]
    r = trace.reduce(dev, host, 6e-5)
    assert r["busy_s"] == pytest.approx(30e-6)
    assert r["launches"] == 3
    assert r["device_ops"][0] == ["k1", pytest.approx(20e-6)]
    assert r["idle_gaps"][0] == ["aten::cat", pytest.approx(20e-6)]
    assert r["idle_gaps"][1] == ["cudaGraphLaunch", pytest.approx(10e-6)]


def _unchanged(fused):
    """Each window's solve returns its state unchanged (time advanced)."""
    def solve_to(f, state, tout, *a, **kw):
        return state._replace(t=type(state.t)(tout))
    return {"solve_to": solve_to}


def _half(fused):
    """Half of the batch left out: each window's solve updates the first
    half of the cells only, the rest keep their state."""
    orig = fused.solve_to

    def solve_to(f, state, *a, **kw):
        st = orig(f, state, *a, **kw)
        y = st.y.clone()
        ne = (y.numel() - 12) // 3
        for k in range(3):
            y[k * ne + ne // 2:(k + 1) * ne] = state.y[k * ne + ne // 2:
                                                       (k + 1) * ne]
        return st._replace(y=y)
    return {"solve_to": solve_to}


def _altered(fused):
    """One answer altered where it is produced: a cell's groundwater after
    each window's solve."""
    orig = fused.solve_to

    def solve_to(*a, **kw):
        st = orig(*a, **kw)
        y = st.y.clone()
        ne = (y.numel() - 12) // 3
        y[2 * ne + 5] += 0.05
        return st._replace(y=y)
    return {"solve_to": solve_to}


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered])
def test_faults_are_not_correct(tmp_path, monkeypatch, fault):
    from shud_tpu_torch.driver import fused

    for name, fn in fault(fused).items():
        monkeypatch.setattr(fused, name, fn)
    r = _run(tmp_path)
    assert r["correct"] is False, r["compared"]


@pytest.mark.parametrize("name", ["unchanged", "half", "altered"])
def test_planted_faults_are_not_correct(tmp_path, name):
    """``calibrate.py --faults`` plants each fault around
    ``advance_interval`` (as on the card's interval graph); the judge of a
    run finds each."""
    from portbench import calibrate

    root, spec = _tiny_root(tmp_path)
    cell = harness.load_cell(root, spec, "tiny-storm")
    raw = gen.make_raw(cell["config"], cell["traffic"])
    where = str(root / "build")
    prog = Program(raw, cell["config"], cell["traffic"], "cpu", where)
    calibrate.plant(prog.sim, calibrate.FAULTS[name], len(raw["tri"]))
    prog.snapshot()
    got = [prog.interval() for _ in range(prog.n_intervals)]
    prog.close()
    numbers, failed = harness.check(raw, cell, got, "cpu", where)
    r = harness.result_line({}, numbers, failed, cell["limits"], len(got),
                            {})
    assert r["correct"] is False and failed > 0, r["compared"]


def test_replays_start_from_the_same_tensors(tmp_path):
    """Each replay starts in the same tensors and repeats the first."""
    root, spec = _tiny_root(tmp_path)
    cell = harness.load_cell(root, spec, "tiny-storm")
    raw = gen.make_raw(cell["config"], cell["traffic"])
    prog = Program(raw, cell["config"], cell["traffic"], "cpu",
                   str(root / "build"))
    prog.snapshot()
    ptrs, runs = [], []
    for _ in range(2):
        prog.restore()
        ptrs.append(prog.sim.bdf.y.data_ptr())
        runs.append([prog.interval()["y"] for _ in range(prog.n_intervals)])
    prog.close()
    assert ptrs[0] == ptrs[1]
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)


def _run_py(cwd: Path, env_extra: dict):
    env = dict(os.environ, **env_extra)
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "mega-32k-storm",
         "--seed", "5", "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_no_card_fails_without_result():
    """Without a CUDA card the run fails and prints no result: no CPU
    fallback."""
    p = _run_py(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_bare_benchmark_directory_fails(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files:
    the run fails and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run_py(tmp_path, {})
    assert p.returncode != 0
    assert p.stdout.strip() == ""


@pytest.mark.cuda
def test_short_run_on_the_card():
    """One short run of the smallest cell on a card: correct, and a result
    line with the card's name."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    p = _run_py(ROOT, {})
    assert p.returncode == 0, p.stderr[-2000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] is True
    assert r["device"]["kind"] == torch.cuda.get_device_name(0)
