"""The port's command line (``python -m shud_tpu_torch``), per-window driver,
debug tables and calibration helpers against the JAX package's.

The per-window driver: ``Simulation.advance_window`` against JAX's on a
synthetic 8x4 mesh in f64 (states within 1e-9, equal NFE), the per-window
run against the port's fused run, and ``run_project`` (and its ``-0``
IO-only mode, on a frozen-ground project too, with JAX's file set).
The debug tables byte-equal to JAX's; ``calib_from_vector``, ``nse`` and
``cma_es`` equal to JAX's.  The CLI: each honoured flag reaches the right
driver with the right arguments (the drivers are replaced by recorders),
each refused flag exits non-zero with its message.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

torch.set_num_threads(1)

from shud_tpu_torch import cli  # noqa: E402
from shud_tpu_torch.driver import run as trun  # noqa: E402
from shud_tpu_torch.driver import run_fast as trf  # noqa: E402
from shud_tpu_torch.driver import uncoupled as tun  # noqa: E402
from torch_variants import make_project  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# the per-window driver
# ---------------------------------------------------------------------------


def _jax_simulation(inp):
    """JAX's Simulation from a project in memory, through its dataclass
    fields (its create loads from disk)."""
    from shud_tpu.core.device import to_device
    from shud_tpu.core.landsurface import BucketState
    from shud_tpu.core.mesh import build_mesh
    from shud_tpu.driver.forcing import build_forcing
    from shud_tpu.driver.init import initial_buckets, initial_state
    from shud_tpu.driver.simulate import Simulation
    from shud_tpu.solver.bdf import SolverConfig, bdf_init

    md = build_mesh(inp)
    cs = inp.control
    cfg = SolverConfig(rtol=cs.reltol, atol=cs.abstol, h_init=cs.init_step,
                       h_max=cs.max_step)
    ic0, snow0 = initial_buckets(inp, md)
    return Simulation(
        inp=inp, md=md, dm=to_device(md, jnp.float64),
        fr=build_forcing(inp, md), cfg=cfg,
        bdf=bdf_init(cs.start_time, jnp.asarray(initial_state(inp, md)),
                     cfg),
        buckets=BucketState(ic_stg=jnp.asarray(ic0),
                            snow=jnp.asarray(snow0)),
        t=cs.start_time)


def _storm(pkg, variant):
    """The 8x4 *variant* project from the storm's onset (minute 720)."""
    inp = make_project(pkg, variant, 8, 4, 1.0)
    inp.control.day_start = 0.5
    return inp


def _torch_simulation(inp):
    from shud_tpu_torch.driver.simulate import Simulation

    return Simulation.create("synthetic", inp=inp, device="cpu")


@pytest.mark.parametrize("variant", ("plain", "lake"))
def test_window_step_matches_jax(variant):
    """Six windows (one hour from the storm's onset at minute 720, where
    the surface wets) through both packages' per-window drivers:
    the states within 1e-9 and equal NFE after every window."""
    a, b = (make(_storm(pkg, variant)) for pkg, make in (
        ("jax", _jax_simulation), ("torch", _torch_simulation)))
    assert a.t == b.t == float(b.bdf.t) == 720.0
    for w in range(6):
        tout = 730.0 + 10.0 * w
        fj, _ = a.advance_window(tout)
        ft, _ = b.advance_window(tout)
        assert b.bdf.nfe == int(a.bdf.nfe), w
        assert np.abs(b.bdf.y.numpy() - np.asarray(a.bdf.y)).max() <= 1e-9
    assert b.bdf.nsteps == int(a.bdf.nsteps) > 6
    dj, dt = a.diagnostics(fj), b.diagnostics(ft)
    for k in ("q_riv_down", "q_infil", "q_sub_tot"):
        np.testing.assert_allclose(dt[k].numpy(), np.asarray(dj[k]),
                                   rtol=1e-9, atol=1e-15, err_msg=k)


def test_per_window_matches_fused():
    """The port's per-window driver and its fused driver over one hour of
    storm: the same windows, so the same states and NFE."""
    from shud_tpu_torch.driver.fused import FusedSimulation

    b = _torch_simulation(_storm("torch", "plain"))
    f = FusedSimulation.create("synthetic", inp=_storm("torch", "plain"),
                               device="cpu")
    assert f.t == b.t == 720.0
    b.run(t_end=780.0)
    f.advance_interval(60.0)
    assert b.bdf.nfe == f.bdf.nfe and b.bdf.nsteps == f.bdf.nsteps
    assert np.abs(b.bdf.y.numpy() - f.y_np()).max() <= 1e-9


@pytest.mark.parametrize("dummy", (False, True))
def test_run_project(tmp_path, dummy):
    """run_project writes the reference's file set, one record a window
    for the solved run; the -0 run opens the same files and solves
    nothing."""
    inp = make_project("torch", "lake", 8, 4, 1.0)
    for name in vars(inp.control):
        if name.startswith("dt_"):
            setattr(inp.control, name, 60)
    inp.control.update_ic_step = 60
    out = str(tmp_path / "out")
    sim = trun.run_project("synthetic", end_day=2.0 / 24, verbose=False,
                           dummy=dummy, outpath=out, device="cpu", inp=inp)
    assert sim.t == 120.0
    assert sim.bdf.nfe == 0 if dummy else sim.bdf.nfe > 0
    files = set(os.listdir(out))
    for want in ("synthetic.eleygw.dat", "synthetic.rivqdown.dat",
                 "synthetic.lakystage.dat", "synthetic.flood.csv",
                 "synthetic.cfg.ic.bak", "synthetic.time.csv"):
        assert want in files, want
    assert ("synthetic.cfg.ic.update" in files) != dummy
    from shud_tpu_torch.io.output import read_dat

    _, _, t, v = read_dat(os.path.join(out, "synthetic.eleygw.dat"))
    assert (len(t) == 0) if dummy else (len(t) == 2
                                        and np.isfinite(v).all())


def test_per_window_refuses_cryosphere():
    inp = make_project("torch", "plain", 8, 4, 1.0)
    inp.control.cryosphere = 1
    with pytest.raises(ValueError, match="cryosphere"):
        _torch_simulation(inp)


def test_dummy_run_on_frozen_ground_matches_jax(tmp_path, monkeypatch):
    """-0 on a cryosphere=1 project solves nothing, so the frozen-ground
    module cannot change its output: the port writes the file set of the
    JAX package's run_project(..., dummy=True) on the same project, each
    binary file the same size."""
    from shud_tpu.driver import run as jrun
    from shud_tpu.driver import simulate as jsim

    def project(pkg):
        inp = make_project(pkg, "lake", 8, 4, 1.0)
        inp.control.cryosphere = 1
        for name in vars(inp.control):
            if name.startswith("dt_"):
                setattr(inp.control, name, 60)
        return inp

    jinp = project("jax")
    monkeypatch.setattr(jsim, "load_project", lambda prj, base=".": jinp)
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "torch")
    jrun.run_project("synthetic", end_day=2.0 / 24, verbose=False,
                     dummy=True, outpath=out_j)
    sim = trun.run_project("synthetic", end_day=2.0 / 24, verbose=False,
                           dummy=True, outpath=out_t, device="cpu",
                           inp=project("torch"))
    assert sim.t == 120.0 and sim.bdf.nfe == 0
    files = sorted(os.listdir(out_j))
    assert files == sorted(os.listdir(out_t))
    assert "synthetic.lakystage.dat" in files
    for f in files:
        if f.endswith(".dat"):
            assert (os.path.getsize(os.path.join(out_j, f))
                    == os.path.getsize(os.path.join(out_t, f))), f


# ---------------------------------------------------------------------------
# debug tables and calibration
# ---------------------------------------------------------------------------


def test_debug_tables_byte_equal(tmp_path):
    from shud_tpu.core.mesh import build_mesh as jbuild
    from shud_tpu.io.debugtables import write_debug_tables as jwrite
    from shud_tpu_torch.core.mesh import build_mesh as tbuild
    from shud_tpu_torch.io.debugtables import write_debug_tables as twrite

    ji, ti = (make_project(p, "lake", 8, 4) for p in ("jax", "torch"))
    pj = jwrite(jbuild(ji), ji, str(tmp_path / "j"))
    pt = twrite(tbuild(ti), ti, str(tmp_path / "t"))
    assert [os.path.basename(p) for p in pj] == [
        os.path.basename(p) for p in pt] and len(pt) == 3
    for a, b in zip(pj, pt):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), b


def test_run_project_fast_writes_debug_tables(tmp_path, monkeypatch):
    """SHUD_DEBUG_TABLES=1 makes run_project_fast write the tables, as
    the JAX package's does."""
    monkeypatch.setenv("SHUD_DEBUG_TABLES", "1")
    inp = make_project("torch", "plain", 8, 4, 1.0)
    for name in vars(inp.control):
        if name.startswith("dt_"):
            setattr(inp.control, name, 60)
    out = str(tmp_path / "out")
    trf.run_project_fast("synthetic", end_day=1.0 / 24, verbose=False,
                         outpath=out, inp=inp, device="cpu")
    files = set(os.listdir(out))
    assert {"Debug_Table_Element.csv", "Debug_Table_River.csv"} <= files


def test_calibration_helpers_match_jax():
    from shud_tpu.utils import calibrate as JCal
    from shud_tpu_torch.utils import calibrate as TCal

    names = ["GEOL_KSATH", "soil_kinf", "LC_ROUGH", "TS_PRCP"]
    x = np.array([1.5, 0.7, 2.0, 1.1])
    gj, gt = JCal.calib_from_vector(names, x), TCal.calib_from_vector(names, x)
    assert dataclasses.asdict(gj) == dataclasses.asdict(gt)
    with pytest.raises(KeyError):
        TCal.calib_from_vector(["no_such_key"], [1.0])
    rng = np.random.default_rng(3)
    obs = rng.uniform(0, 5, 50)
    sim = obs + rng.normal(0, 0.5, 50)
    sim[4] = np.nan
    assert TCal.nse(sim, obs) == JCal.nse(sim, obs)
    assert TCal.nse(sim, np.ones(50)) == JCal.nse(sim, np.ones(50))

    def f(v):
        return float(np.sum((v - 0.3) ** 2))

    rj = JCal.cma_es(f, [1.0, -1.0], max_gen=5, seed=2)
    rt = TCal.cma_es(f, [1.0, -1.0], max_gen=5, seed=2)
    np.testing.assert_array_equal(rj[0], rt[0])
    assert rj[1:] == rt[1:]


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------


@pytest.fixture
def drivers(monkeypatch):
    """Recorders in place of run_project_fast and run_project: each call
    appends (driver name, args, kwargs)."""
    calls = []

    def record(name):
        def fn(*args, **kwargs):
            calls.append((name, args, kwargs))
        return fn

    monkeypatch.setattr(trf, "run_project_fast", record("fast"))
    monkeypatch.setattr(trun, "run_project", record("per_window"))
    monkeypatch.setattr(tun, "run_project_split", record("split"))
    return calls


def test_cli_default_route(drivers):
    cli.main(["prj"])
    (name, args, kw), = drivers
    assert name == "fast" and args == ("prj",)
    assert kw == dict(base=".", end_day=None, verbose=True,
                      float_dtype=torch.float64, outpath=None, calib=None,
                      resume=None, inp=None, device="cuda",
                      edge_kernel="auto", mega="auto")


def test_cli_fused_flags(drivers):
    cli.main(["--cpu", "--f32", "--no-pallas", "--mega", "-e", "2.5", "-o",
              "out", "-b", "base", "--resume", "ck.npz", "-q", "prj"])
    (name, _, kw), = drivers
    assert name == "fast"
    assert (kw["device"], kw["float_dtype"], kw["edge_kernel"], kw["mega"],
            kw["end_day"], kw["outpath"], kw["base"], kw["resume"],
            kw["verbose"]) == ("cpu", torch.float32, False, True, 2.5, "out",
                               "base", "ck.npz", False)
    drivers.clear()
    cli.main(["--pallas", "--no-mega", "-v", "-q", "prj"])
    kw = drivers[0][2]
    assert (kw["edge_kernel"], kw["mega"], kw["verbose"]) == (True, False,
                                                              True)


@pytest.mark.parametrize("flag,dummy", (("--per-window", False),
                                        ("-0", True), ("--dummy", True)))
def test_cli_per_window_route(drivers, flag, dummy):
    cli.main([flag, "--cpu", "--f32", "--pallas", "-e", "1", "prj"])
    (name, args, kw), = drivers
    assert name == "per_window" and args == ("prj",)
    assert kw == dict(base=".", end_day=1.0, verbose=True, dummy=dummy,
                      outpath=None, calib=None, device="cpu",
                      float_dtype=torch.float32, edge_kernel=True)


@pytest.mark.parametrize("flag", ("-g", "--split"))
def test_cli_split_route(drivers, flag):
    """-g reaches run_project_split with the device, paths and
    calibration, as the JAX CLI passes them (shud_tpu/cli.py:179-184)."""
    cli.main([flag, "--cpu", "-e", "0.5", "-o", "out", "-b", "base", "-q",
              "prj"])
    (name, args, kw), = drivers
    assert name == "split" and args == ("prj",)
    assert kw == dict(base="base", end_day=0.5, verbose=False, outpath="out",
                      calib=None, device="cpu")
    drivers.clear()
    cli.main([flag, "prj"])
    assert drivers[0][2]["device"] == "cuda"


def test_cli_calib_fflush_and_workers(drivers, tmp_path, monkeypatch,
                                      capsys):
    from shud_tpu_torch.io import output
    from shud_tpu_torch.io.project import Calib, write_calib

    path = str(tmp_path / "x.cfg.calib")
    gc = dataclasses.replace(Calib(), geol_ksath=3.5)
    write_calib(gc, path)
    monkeypatch.setattr(output, "FFLUSH_MODE", False)
    cli.main(["-c", path, "-f", "-n", "4", "prj"])
    kw = drivers[0][2]
    assert kw["calib"].geol_ksath == 3.5
    assert output.FFLUSH_MODE is True
    assert "-n 4: accepted for CLI parity" in capsys.readouterr().out


def test_cli_project_file(drivers, monkeypatch):
    from shud_tpu_torch.io import project

    class Paths:
        project = "fromfile"
        outpath = "out_from_file"

    monkeypatch.setattr(project, "read_project_file", lambda fn: Paths)
    monkeypatch.setattr(project, "load_project",
                        lambda prj, paths=None: ("loaded", prj, paths))
    cli.main(["-p", "x.SHUD"])
    (name, args, kw), = drivers
    assert name == "fast" and args == ("fromfile",)
    assert kw["inp"] == ("loaded", "fromfile", Paths)
    assert kw["outpath"] == "out_from_file"
    for flag in ("--per-window", "-g"):
        with pytest.raises(SystemExit) as e:
            cli.main(["-p", "x.SHUD", flag])
        assert e.value.code != 0


def test_cli_cmaes_dir(drivers, tmp_path):
    d = tmp_path / "cmaes"
    d.mkdir()
    (d / "calib_varnames.txt").write_text("GEOL_KSATH\n# comment\nLC_ROUGH\n")
    (d / "calib_x.txt").write_text("2.5 0.5\n")
    cli.main(["--cmaes-dir", str(d), "-q", "-b", str(tmp_path), "prj"])
    kw = drivers[0][2]
    assert (kw["calib"].geol_ksath, kw["calib"].lc_rough) == (2.5, 0.5)
    # no outputs were written by the recorder: the objective is NaN
    assert (d / "objective.txt").read_text().strip() == "nan"
    assert (d / "cfg.calib.out").exists()


def test_cli_profile(monkeypatch, tmp_path):
    def run(*args, **kwargs):
        torch.ones(4).sum()

    monkeypatch.setattr(trf, "run_project_fast", run)
    cli.main(["--cpu", "--profile", str(tmp_path / "prof"), "-q", "prj"])
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0


def test_cli_shud_error_exit_code(monkeypatch):
    from shud_tpu_torch.utils.errors import NanError

    def fail(*args, **kwargs):
        raise NanError("non-finite state")

    monkeypatch.setattr(trf, "run_project_fast", fail)
    with pytest.raises(SystemExit) as e:
        cli.main(["prj"])
    assert e.value.code == NanError.code


@pytest.mark.parametrize("argv,message", (
    (["-g", "--f32", "prj"], "--f32: not supported with -g"),
    (["-g", "--resume", "ck", "prj"], "--resume: not supported with -g"),
    (["-g", "-0", "prj"], "-0: not supported with -g"),
    (["-g", "--mega", "prj"], "--mega/--no-mega: not supported with -g"),
    (["--split", "--no-pallas", "--per-window", "prj"],
     "--pallas/--no-pallas, --per-window: not supported with -g"),
    (["--shards", "2", "prj"], "multi-GPU"),
    (["--distributed", "prj"], "multi-GPU"),
    (["--distributed=host:1234,2,0", "prj"], "multi-GPU"),
    (["--compile-cache", "dir", "prj"], "TPU workaround"),
    (["--per-window", "--mega", "prj"], "fused driver"),
    (["--per-window", "--resume", "ck", "prj"], "fused driver"),
    ([], "project name"),
))
def test_cli_refused(drivers, capsys, argv, message):
    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    assert e.value.code != 0
    assert message in capsys.readouterr().err
    assert drivers == []


def test_cli_module_help():
    """``python -m shud_tpu_torch -h`` exits 0 and a refused flag
    (``--shards 2``) exits non-zero, in a fresh process."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    ok = subprocess.run([sys.executable, "-m", "shud_tpu_torch", "-h"],
                        capture_output=True, text=True, cwd=ROOT, env=env)
    assert ok.returncode == 0 and "--per-window" in ok.stdout
    bad = subprocess.run([sys.executable, "-m", "shud_tpu_torch", "--shards",
                          "2", "prj"], capture_output=True, text=True,
                         cwd=ROOT, env=env)
    assert bad.returncode != 0 and "multi-GPU" in bad.stderr
