"""The port's calibration tools (``shud_tpu_torch.tools``) against the JAX
package's ``tools/autocalibrate.py`` and ``tools/calib_tournament.py``.

A twin experiment: the observations are the JAX fused driver's daily
outlet discharge (f64) on the synthetic 6x4 watershed at a known
calibration, computed as the tools compute it and written as
``synthetic.tsd.obs`` into a temporary input directory.  Both tools run on
the same in-memory project (JAX's as a script, its ``load_project``
replaced), the port's with ``--cpu``, both in f64.  Bars: the same
candidate vectors bitwise, each score within 1e-9, ``.cfg.calib.opt`` and
``--best-file`` byte-equal, the same ``eval`` lines; ``--log``, ``--bound``
and ``--x0`` reach the same start and box; an NFE budget aborts at the
same day with the penalty 5.0; the same refusals; the tournament's
scores, water balance and winner; without ``--cpu`` and without a card the
port's tools raise.

The searched keys scale the precipitation (``ts_prcp`` around 0.1), so a
candidate's storm day costs ~600 NFE instead of ~6,900 and the water
balance penalty is active (AET above P over the two days).
"""

import os
import runpy
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

torch.set_num_threads(1)

import shud_tpu.io.project as jproject  # noqa: E402
import shud_tpu.utils.calibrate as jcal  # noqa: E402
from shud_tpu.driver.fused import FusedSimulation as JSim  # noqa: E402
from shud_tpu.utils import synthetic as jsynth  # noqa: E402
from shud_tpu_torch.io.project import read_calib  # noqa: E402
from shud_tpu_torch.tools import autocalibrate as tac  # noqa: E402
from shud_tpu_torch.tools import calib_tournament as ttour  # noqa: E402
from shud_tpu_torch.utils import synthetic as tsynth  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DAYS = 2
NAMES = ["ts_prcp", "geol_ksath"]
TRUTH = [0.15, 0.5]
START = "0.1,1.0"
SEARCH = ["synthetic", "--days", str(DAYS), "--params", ",".join(NAMES),
          "--x0", START]


def project(pkg, inpath):
    synth = jsynth if pkg == "jax" else tsynth
    inp = synth.make_synthetic_project(6, 4, end_day=DAYS)
    inp.paths.inpath = str(inpath)
    return inp


@pytest.fixture(scope="module")
def inpath(tmp_path_factory):
    """A directory holding synthetic.tsd.obs: JAX's daily outlet discharge
    at TRUTH, the mean of |Q| over each day's windows x 1440 (as the tools
    compute it), at day d + 0.5."""
    d = tmp_path_factory.mktemp("input")
    inp = project("jax", d)
    sim = JSim.create("synthetic", inp=inp, day_end=DAYS,
                      calib=jcal.calib_from_vector(NAMES, TRUTH, inp.calib))
    md = sim.md
    outlet = np.flatnonzero((np.asarray(md.riv_down) < 0)
                            & (np.asarray(md.riv_to_lake) < 0))
    wpd = int(round(1440.0 / inp.control.solver_step))
    _, _, _, qdowns = sim.advance_interval(DAYS * 1440.0)
    qn = np.asarray(qdowns)[:, outlet].sum(axis=1)
    q = np.abs(qn).reshape(DAYS, wpd).mean(axis=1) * 1440.0
    with open(d / "synthetic.tsd.obs", "w") as f:
        f.write(f"{DAYS}\t2\t20000101\nTime_Day\tQ\n")
        for day, v in enumerate(q):
            f.write(f"{day + 0.5:.17g}\t{v:.17g}\n")
    return d


def run_jax(tool, argv, inpath, monkeypatch):
    """The JAX tool *tool* as a script on the in-memory project; returns
    the objective's (z, f) pairs, the calibration vectors it built and the
    NSEs it computed, in call order."""
    rec = {"evals": [], "x": [], "nse": []}
    cma, cfv, nse = jcal.cma_es, jcal.calib_from_vector, jcal.nse

    def cma_es(objective, *a, **k):
        def wrapped(z):
            f = objective(z)
            rec["evals"].append((np.array(z), f))
            return f
        return cma(wrapped, *a, **k)

    def calib_from_vector(names, x, base=None):
        rec["x"].append(np.array(x, dtype=float))
        return cfv(names, x, base=base)

    def record_nse(sim, obs):
        rec["nse"].append(nse(sim, obs))
        return rec["nse"][-1]

    monkeypatch.setattr(jcal, "cma_es", cma_es)
    monkeypatch.setattr(jcal, "calib_from_vector", calib_from_vector)
    monkeypatch.setattr(jcal, "nse", record_nse)
    monkeypatch.setattr(jproject, "load_project",
                        lambda prj, base=".": project("jax", inpath))
    monkeypatch.setattr(sys, "argv", [tool, *argv])
    monkeypatch.setattr(sys, "path", list(sys.path))
    runpy.run_path(os.path.join(ROOT, "tools", tool), run_name="__main__")
    return rec


def use_port_project(monkeypatch, module, inpath):
    monkeypatch.setattr(module, "load_project",
                        lambda prj, base=".": project("torch", inpath))


def eval_lines(text):
    return [s for s in text.splitlines() if s.lstrip().startswith("eval ")]


def read(path):
    with open(path, "rb") as f:
        return f.read()


def test_search_matches_jax(inpath, tmp_path, monkeypatch, capsys):
    """Two generations of two candidates under --log, --bound, --x0 and
    --wb-penalty: the same vectors bitwise, scores within 1e-9, the same
    eval lines, byte-equal .cfg.calib.opt and --best-file."""
    argv = SEARCH + ["--gens", "2", "--popsize", "2", "--log",
                     "--bound", "geol_ksath=-0.5:0.5", "--wb-penalty", "0.5"]
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    rec = run_jax("autocalibrate.py", argv + [
        "-o", str(jdir), "--best-file", str(tmp_path / "jax.best")],
        inpath, monkeypatch)
    jout = capsys.readouterr().out
    use_port_project(monkeypatch, tac, inpath)
    res = tac.main(argv + ["--cpu", "-o", str(tdir), "--best-file",
                           str(tmp_path / "torch.best")])
    tout = capsys.readouterr().out

    assert len(res.candidates) == len(rec["evals"]) == 4
    for c, x, (_, f) in zip(res.candidates, rec["x"], rec["evals"]):
        np.testing.assert_array_equal(c.x, x)
        assert abs(c.f - f) <= 1e-9
        assert not c.aborted and c.days == DAYS and c.nfe > 0
        assert c.device_bytes is None
    np.testing.assert_array_equal(res.x, rec["x"][-1])
    assert eval_lines(tout) == eval_lines(jout)
    assert "pen=" in jout  # the penalty was active
    name = "synthetic.cfg.calib.opt"
    assert read(tdir / name) == read(jdir / name)
    assert read(tmp_path / "torch.best") == read(tmp_path / "jax.best")
    # either package's file reads back as the search's winner
    got = read_calib(str(jdir / name))
    assert [getattr(got, n) for n in NAMES] == [
        float(f"{v:g}") for v in res.x]
    assert "first candidate: set-up" in tout


def test_nfe_budget_abort_matches_jax(inpath, tmp_path, monkeypatch,
                                      capsys):
    """A budget below day 0's NFE with one-day chunks: both tools abort
    every candidate after day 1 with the penalty 5.0."""
    argv = SEARCH + ["--gens", "1", "--popsize", "2", "--chunk-days", "1",
                     "--nfe-budget-per-day", "600"]
    rec = run_jax("autocalibrate.py", argv + ["-o", str(tmp_path / "j")],
                  inpath, monkeypatch)
    jout = capsys.readouterr().out
    use_port_project(monkeypatch, tac, inpath)
    res = tac.main(argv + ["--cpu", "-o", str(tmp_path / "t")])
    tout = capsys.readouterr().out
    assert [f for _, f in rec["evals"]] == [5.0, 5.0]
    assert [c.f for c in res.candidates] == [5.0, 5.0]
    assert all(c.aborted and c.days == 1 for c in res.candidates)
    assert eval_lines(tout) == eval_lines(jout)
    assert all("ABORT" in s and s.endswith("at day 1")
               for s in eval_lines(tout))


class _Stop(Exception):
    pass


@pytest.mark.parametrize("flags", [
    [],
    ["--log"],
    ["--log", "--log-bound", "1.5", "--bound", "ts_prcp=-1.2:-0.9"],
    ["--x0", "0.01,30"],
    ["--log", "--params", "ts_sfctmp+,GEOL_KSATH", "--x0=-2,0.3",
     "--bound", "geol_ksath=-0.2:0.2"],
])
def test_search_space_matches_jax(inpath, monkeypatch, capsys, flags):
    """--log, --log-bound, --bound and --x0 hand CMA-ES the same start,
    box, sigma and population as the JAX tool (captured at its call)."""
    seen = []

    def capture(objective, x0, sigma0=0.3, bounds=None, popsize=None,
                **kw):
        seen.append((np.array(x0), np.array(bounds[0]),
                     np.array(bounds[1]), sigma0, popsize, kw))
        raise _Stop

    argv = ["synthetic", "--params", ",".join(NAMES), *flags]
    monkeypatch.setattr(jcal, "cma_es", capture)  # run_jax's wrapper calls it
    with pytest.raises(_Stop):
        run_jax("autocalibrate.py", argv, inpath, monkeypatch)
    jout = capsys.readouterr().out
    use_port_project(monkeypatch, tac, inpath)
    monkeypatch.setattr(tac, "cma_es", capture)
    with pytest.raises(_Stop):
        tac.main(argv + ["--cpu"])
    tout = capsys.readouterr().out
    (jz, jlo, jhi, *jrest), (tz, tlo, thi, *trest) = seen[-2:]
    for a, b in ((jz, tz), (jlo, tlo), (jhi, thi)):
        np.testing.assert_array_equal(a, b)
    assert jrest == trest
    assert ("warning: --x0 outside" in jout) == (
        "warning: --x0 outside" in tout)


@pytest.mark.parametrize("flags, message", [
    (["--params", "geol_ksath,no_such_key"],
     "unknown calibration key(s): no_such_key"),
    (["--params", "geol_ksath", "--x0", "1.0,2.0"],
     "--x0 has 2 values but --params names 1 keys"),
    (["--params", "geol_ksath", "--bound", "soil_kinf=0:1"],
     "--bound key 'soil_kinf' not in --params"),
])
def test_refusals_match_jax(inpath, monkeypatch, capsys, flags, message):
    argv = ["synthetic", *flags]
    with pytest.raises(SystemExit) as j:
        run_jax("autocalibrate.py", argv, inpath, monkeypatch)
    jerr = capsys.readouterr().err
    use_port_project(monkeypatch, tac, inpath)
    with pytest.raises(SystemExit) as t:
        tac.main(argv + ["--cpu"])
    terr = capsys.readouterr().err
    assert j.value.code == t.value.code == 2
    assert jerr.splitlines()[-1].split("error: ")[1] == message
    assert terr.splitlines()[-1].split("error: ")[1] == message


def test_tournament_matches_jax(inpath, tmp_path, monkeypatch, capsys):
    """Three candidates over the record: the same NSE (1e-9) and water
    balance line per candidate, the same winner, byte-equal
    .cfg.calib.opt."""
    argv = ["synthetic", "--days", str(DAYS), "--warmup", "0", "--f64",
            "--params", ",".join(NAMES), "--cand", f"start:{START}",
            "--cand", "truth:" + ",".join(map(str, TRUTH)),
            "--cand", "wet:0.2,2.0"]
    jdir = tmp_path / "jax"
    jdir.mkdir()
    monkeypatch.chdir(jdir)
    rec = run_jax("calib_tournament.py", argv, inpath, monkeypatch)
    jout = capsys.readouterr().out
    use_port_project(monkeypatch, ttour, inpath)
    tdir = tmp_path / "torch"
    tdir.mkdir()
    monkeypatch.chdir(tdir)
    entries, path = ttour.main(argv + ["--cpu"])
    tout = capsys.readouterr().out

    by_label = {e.label: e for e in entries}
    for label, v in zip(("start", "truth", "wet"), rec["nse"]):
        assert abs(by_label[label].nse - v) <= 1e-9
    assert entries[0].label == "truth" and entries[0].nse > 1 - 1e-9

    def scores(text):  # the per-candidate lines up to the wall time
        return [s.split(" wall=")[0] for s in text.splitlines()
                if " over days " in s]

    assert scores(tout) == scores(jout) and len(scores(tout)) == 3
    assert "winner: truth" in tout and "winner: truth" in jout
    name = os.path.join("output", "synthetic.out", "synthetic.cfg.calib.opt")
    assert path == os.path.join(str(tdir), name)
    assert read(tdir / name) == read(jdir / name)
    got = read_calib(path)
    assert [getattr(got, n) for n in NAMES] == TRUTH


@pytest.mark.parametrize("tool", ("autocalibrate", "tournament"))
def test_no_card_raises(inpath, tmp_path, monkeypatch, tool):
    """Without --cpu the tools run on the card; with none they raise
    (no CPU fallback)."""
    if tool == "autocalibrate":
        use_port_project(monkeypatch, tac, inpath)
        run = tac.main
        argv = SEARCH + ["--gens", "1", "--popsize", "2", "-o",
                         str(tmp_path)]
    else:
        use_port_project(monkeypatch, ttour, inpath)
        run = ttour.main
        argv = ["synthetic", "--params", "geol_ksath", "--cand", "a:1.0"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run(argv)


def test_module_help():
    """``python -m shud_tpu_torch.tools.<tool> -h`` exits 0 in a fresh
    process."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    for tool, flag in (("autocalibrate", "--nfe-budget-per-day"),
                       ("calib_tournament", "--cand")):
        r = subprocess.run([sys.executable, "-m",
                            f"shud_tpu_torch.tools.{tool}", "-h"],
                           capture_output=True, text=True, cwd=ROOT, env=env)
        assert r.returncode == 0 and flag in r.stdout and "--cpu" in r.stdout
