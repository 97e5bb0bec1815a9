"""The port's sharded driver (``parallel/runtime.py``) against the JAX
package's and against the port's single-device driver.

``ShardedSimulation`` at P = 4 (gloo ranks on the CPU, float64) against
JAX's on 4 virtual devices, on the 12x6 lake mesh over 2 windows: equal
steps and NFE after each window, state within 1e-9 m; on JAX's BC and
cryosphere project, against the port's single-device fused driver over 6
windows within 1e-9 m, every BC and the frozen fractions in effect.
``run_project_sharded`` at P = 4 against ``run_project_fast`` on the JAX
package's twin project (``tests/test_sharded_driver.py:_twin``): the same
file set, byte-identical .dat headers, payloads within 1e-4 (the JAX
test's bar).  A checkpoint written at P = 4 resumed bitwise.  The command
line: a two-process ``--distributed host:port,2,rank`` run on gloo against
a one-process ``--shards 2 --cpu`` run, byte for byte.  The ranks run
``tests/torch_sharded_ranks.py``, which imports no JAX.
"""

import dataclasses
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

torch.set_num_threads(1)

from shud_tpu_torch.io.output import read_dat  # noqa: E402
from shud_tpu_torch.parallel import comm  # noqa: E402
from torch_sharded_ranks import bc_cryo_project, driver_rank  # noqa: E402
from torch_sharded_ranks import twin  # noqa: E402
from torch_sharded_ranks import windows_rank  # noqa: E402
from torch_variants import make_project  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = 4


def test_sharded_simulation_matches_jax():
    from shud_tpu.core.mesh import build_mesh
    from shud_tpu.parallel.runtime import ShardedSimulation

    port = comm.spawn(windows_rank, P, "gloo", ["cpu"] * P, timeout=600,
                      args=(make_project("torch", "lake", 12, 6, 1.0), 2,
                            torch.float64))
    jinp = make_project("jax", "lake", 12, 6, 1.0)
    sim = ShardedSimulation(jinp, build_mesh(jinp), P)
    for w in range(2):
        sim.advance_window(sim.t + jinp.control.solver_step)
        for r in port:  # every rank took the same steps
            assert (r[w]["nsteps"], r[w]["nfe"]) == (int(sim.state.nsteps),
                                                     int(sim.state.nfe)), w
            np.testing.assert_array_equal(r[w]["y"], port[0][w]["y"])
        assert np.abs(port[0][w]["y"] - sim.y_full()).max() <= 1e-9, w


def test_sharded_bc_cryo_matches_fused():
    """Every BC/SS class and the cryosphere through the sharded forcing
    (JAX's ``test_sharded_bc_cryo_trajectory``): 4 ranks over 6 windows
    against the port's single-device fused driver, f64."""
    from shud_tpu_torch.driver.fused import FusedSimulation
    from shud_tpu_torch.driver.init import initial_state

    inp = bc_cryo_project()
    port = comm.spawn(windows_rank, P, "gloo", ["cpu"] * P, timeout=600,
                      args=(inp, 6, torch.float64))
    fused = FusedSimulation.create("synthetic", inp=bc_cryo_project(),
                                   device="cpu")
    fused.advance_interval(60.0)
    y = port[0][-1]["y"]
    assert np.abs(y - fused.y_np()).max() <= 1e-9
    assert port[0][-1]["nfe"] == fused.bdf.nfe
    # the head BC holds gw at its cell
    ne = fused.md.num_ele
    y0 = initial_state(inp, fused.md)
    assert abs(y[2 * ne + 10] - y0[2 * ne + 10]) < 1e-12
    # the BCs and the frozen ground took effect: without them (BC series
    # zero, 15 C, cryosphere off) the basin lands elsewhere
    warm = bc_cryo_project()
    warm.control.cryosphere = 0
    warm.forc.data[0][:, 1] = 15.0
    warm.bc = {k: (t, np.zeros_like(v)) for k, (t, v) in warm.bc.items()}
    other = FusedSimulation.create("synthetic", inp=warm, device="cpu")
    other.advance_interval(60.0)
    assert np.abs(y - other.y_np()).max() > 1e-3


def _compare_dirs(sh_dir, sd_dir):
    """The sharded run's output directory against the single-device one's,
    as the JAX package's test compares its two drivers."""
    sh_files, sd_files = sorted(os.listdir(sh_dir)), sorted(os.listdir(sd_dir))
    assert sh_files == sd_files
    for fn in sd_files:
        if fn.endswith(".dat"):
            s0, c0, t0, d0 = read_dat(os.path.join(sh_dir, fn))
            s1, c1, t1, d1 = read_dat(os.path.join(sd_dir, fn))
            with open(os.path.join(sh_dir, fn), "rb") as f0, \
                    open(os.path.join(sd_dir, fn), "rb") as f1:
                assert f0.read(1024) == f1.read(1024), f"{fn}: header"
            assert s0 == s1 and (c0 == c1).all(), fn
            assert (t0 == t1).all(), f"{fn}: timestamps differ"
            assert d0.shape == d1.shape, fn
            scale = max(1.0, np.abs(d1).max())
            assert np.abs(d0 - d1).max() / scale < 1e-4, fn
        elif fn.endswith(".nc"):
            import h5py

            with h5py.File(os.path.join(sh_dir, fn)) as f0, \
                    h5py.File(os.path.join(sd_dir, fn)) as f1:
                assert sorted(f0.keys()) == sorted(f1.keys()), fn
                for k in f1.keys():
                    a0, a1 = np.asarray(f0[k]), np.asarray(f1[k])
                    assert a0.shape == a1.shape, f"{fn}:{k}"
                    if a1.dtype.kind == "f" and a1.size:
                        scale = max(1.0, np.abs(a1).max())
                        assert np.abs(a0 - a1).max() / scale < 1e-4, \
                            f"{fn}:{k}"
    with open(os.path.join(sh_dir, "synthetic.cfg.ic.update")) as f:
        sh_ic = f.read().splitlines()
    with open(os.path.join(sd_dir, "synthetic.cfg.ic.update")) as f:
        sd_ic = f.read().splitlines()
    assert len(sh_ic) == len(sd_ic)
    for a, b in zip(sh_ic[2:], sd_ic[2:]):
        try:
            va = np.array([float(x) for x in a.split()[1:]] or [0.0])
        except ValueError:
            assert a == b  # table headers verbatim
            continue
        vb = np.array([float(x) for x in b.split()[1:]] or [0.0])
        assert np.abs(va - vb).max() < 1e-4
    for name in ("synthetic.flood.csv", "synthetic.time.csv"):
        with open(os.path.join(sh_dir, name)) as f0, \
                open(os.path.join(sd_dir, name)) as f1:
            assert len(f0.readlines()) == len(f1.readlines()), name


def test_run_project_sharded_matches_fast(tmp_path, monkeypatch):
    from shud_tpu_torch.driver.run_fast import run_project_fast

    # the exact water-balance quadrature and the per-element residual
    # channel on both drivers (the ranks inherit the environment)
    monkeypatch.setenv("SHUD_WB_DIAG", "1")
    sh_dir, sd_dir = str(tmp_path / "sh"), str(tmp_path / "sd")
    (sh,) = comm.spawn(driver_rank, P, "gloo", ["cpu"] * P, timeout=600,
                       args=([(twin(), {"outpath": sh_dir})],))[0]
    sim = run_project_fast("synthetic", inp=twin(), outpath=sd_dir,
                           verbose=False, device="cpu")
    assert sh["nfe"] == sim.bdf.nfe
    assert np.abs(sh["y"] - sim.y_np()).max() <= 1e-9
    _compare_dirs(sh_dir, sd_dir)
    wb0 = np.genfromtxt(os.path.join(sh_dir, "synthetic.wb.basin.csv"),
                        delimiter=",", names=True)
    wb1 = np.genfromtxt(os.path.join(sd_dir, "synthetic.wb.basin.csv"),
                        delimiter=",", names=True)
    for col in wb1.dtype.names:
        a0, a1 = np.atleast_1d(wb0[col]), np.atleast_1d(wb1[col])
        assert np.abs(a0 - a1).max() / max(1.0, np.abs(a1).max()) < 1e-3, col
    assert np.abs(np.atleast_1d(wb0["residual_rel"])).max() < 0.01


def test_sharded_checkpoint_resume_bitwise(tmp_path):
    """A run resumed at half-way from a checkpoint written at P = 4 lands
    on the uninterrupted run's state, bit for bit."""
    half = twin()
    half.control.update_ic_step = 180
    for f in dataclasses.fields(half.control):
        if f.name.startswith("dt_") and getattr(half.control, f.name):
            setattr(half.control, f.name, 180)
    d_half = str(tmp_path / "half")
    runs = [(twin(), {"outpath": str(tmp_path / "full")}),
            (half, {"outpath": d_half, "end_day": 0.125}),
            (twin(), {"outpath": str(tmp_path / "res"),
                      "resume": os.path.join(d_half, "synthetic.ckpt.npz")})]
    full, mid, res = comm.spawn(driver_rank, P, "gloo", ["cpu"] * P,
                                timeout=600, args=(runs,))[0]
    assert mid["t"] == 180.0 and res["t"] == full["t"] == 360.0
    np.testing.assert_array_equal(res["y"], full["y"])
    assert res["nfe"] == full["nfe"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_cli_distributed_matches_shards(tmp_path):
    """``--distributed localhost:port,2,rank --cpu`` in two processes and
    ``--shards 2 --cpu`` in one write the same files, byte for byte."""
    script = os.path.join(ROOT, "tests", "torch_sharded_ranks.py")
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("SHUD_WB_DIAG", None)
    d_dist, d_shards = str(tmp_path / "dist"), str(tmp_path / "shards")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, script, "--distributed", f"localhost:{port},2,{r}",
         "--cpu", "-q", "-o", d_dist, "synthetic"], cwd=str(tmp_path),
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    one = subprocess.run(
        [sys.executable, script, "--shards", "2", "--cpu", "-q", "-o",
         d_shards, "synthetic"], cwd=str(tmp_path), env=env,
        capture_output=True, text=True, timeout=600)
    assert one.returncode == 0, one.stdout + one.stderr
    files = sorted(os.listdir(d_shards))
    assert sorted(os.listdir(d_dist)) == files
    assert "synthetic.eleygw.dat" in files
    for fn in files:
        if fn.endswith((".dat", ".csv", ".update", ".bak")) \
                and fn != "synthetic.time.csv":
            with open(os.path.join(d_dist, fn), "rb") as f0, \
                    open(os.path.join(d_shards, fn), "rb") as f1:
                assert f0.read() == f1.read(), fn
    with np.load(os.path.join(d_dist, "synthetic.ckpt.npz")) as a, \
            np.load(os.path.join(d_shards, "synthetic.ckpt.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], k)
