"""The port's operator-split (``-g``) run: ``run_project_split``.

* against the port's implicit driver (``run_project_fast``) on the JAX
  package's ``test_split_driver_output_parity`` project
  (tests/test_driver.py:264-320): the same file set, state channels within
  the splitting bounds (5e-3 m; 5e-2 m for the lake) and the water-balance
  flux columns within 5%;
* a run resumed from its own checkpoint equals the whole run to 1e-12 (the
  JAX package's tests/test_driver.py:323-343, cut from 12 hours with the
  checkpoint at 6 to 2 hours with the checkpoint at 1);
* a JAX ``-g`` checkpoint resumes in the port and reaches JAX's states;
* the run through ``SplitGraph``'s program (``captured=True``; on the CPU
  its pieces run eagerly) writes the eager loop's files byte for byte;
* device and frozen-ground refusals.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

torch.set_num_threads(1)

from shud_tpu.driver import uncoupled as JU  # noqa: E402
from shud_tpu.utils.synthetic import (  # noqa: E402
    make_synthetic_project as jax_project)
from shud_tpu_torch.driver.uncoupled import run_project_split  # noqa: E402
from shud_tpu_torch.io.output import read_dat  # noqa: E402
from shud_tpu_torch.utils.synthetic import make_synthetic_project  # noqa: E402
from test_torch_split import _check  # noqa: E402


def _twin():
    """tests/test_driver.py's test_split_driver_output_parity project."""
    inp = make_synthetic_project(12, 6, end_day=0.25, with_lake=True)
    cs = inp.control
    for f in dataclasses.fields(cs):
        if f.name.startswith("dt_") and getattr(cs, f.name):
            setattr(cs, f.name, 360)
    cs.dt_ye_surf = cs.dt_ye_unsat = cs.dt_ye_gw = 360
    cs.dt_Qr_down = cs.dt_yr_stage = cs.dt_lake = 360
    cs.update_ic_step = 360
    return inp


def test_split_matches_implicit_driver(tmp_path):
    from shud_tpu_torch.driver.run_fast import run_project_fast

    g_dir, f_dir = str(tmp_path / "g"), str(tmp_path / "f")
    st = run_project_split("synthetic", inp=_twin(), outpath=g_dir,
                           verbose=False, device="cpu")
    run_project_fast("synthetic", inp=_twin(), outpath=f_dir, verbose=False,
                     device="cpu")
    assert float(st.lake.t) == 360.0 and st.lake.nfe > 0
    assert sorted(os.listdir(g_dir)) == sorted(os.listdir(f_dir))
    tol = {"eleysurf": 5e-3, "eleygw": 5e-3, "rivystage": 5e-3,
           "lakystage": 5e-2}
    for name, bound in tol.items():
        _, _, tg, dg = read_dat(os.path.join(g_dir, f"synthetic.{name}.dat"))
        _, _, tf, df = read_dat(os.path.join(f_dir, f"synthetic.{name}.dat"))
        assert len(tg) == 1 and (tg == tf).all(), name
        assert np.abs(dg - df).max() < bound, (name, np.abs(dg - df).max())

    def rows(d):
        return np.atleast_1d(np.genfromtxt(
            os.path.join(d, "synthetic.wb.basin.csv"), delimiter=",",
            names=True))

    rows_g, rows_f = rows(g_dir), rows(f_dir)
    for col in ("P_m3", "ET_m3", "Qout_m3", "QBC_m3", "QSS_m3"):
        scale = max(10.0, np.abs(rows_f[col]).max())
        assert np.abs(rows_g[col] - rows_f[col]).max() / scale < 0.05, col


def _short(make, **kw):
    inp = make(8, 4, end_day=1.0, **kw)
    inp.control.update_ic_step = 60
    return inp


def test_split_resume_equals_whole_run(tmp_path):
    full = run_project_split("synthetic", inp=_short(make_synthetic_project),
                             end_day=2.0 / 24, outpath=str(tmp_path / "full"),
                             verbose=False, device="cpu")
    run_project_split("synthetic", inp=_short(make_synthetic_project),
                      end_day=1.0 / 24, outpath=str(tmp_path / "half"),
                      verbose=False, device="cpu")
    res = run_project_split(
        "synthetic", inp=_short(make_synthetic_project), end_day=2.0 / 24,
        outpath=str(tmp_path / "res"), verbose=False, device="cpu",
        resume=str(tmp_path / "half" / "synthetic.ckpt.npz"))
    assert full.lake is None and res.lake is None
    for k in ("surf", "unsat", "gw", "riv"):
        a, b = getattr(full, k), getattr(res, k)
        assert (a.nsteps, a.nfe) == (b.nsteps, b.nfe), k
        assert (a.y - b.y).abs().max() <= 1e-12, k


def test_jax_split_checkpoint_resumes_in_port(tmp_path):
    """A ``-g`` run of the JAX package writes its checkpoint after one
    hour; the port loads it (the five solvers' keys, ``bdf/surf/y``, ...)
    and runs the second hour to JAX's states, and its own checkpoint has
    JAX's keys, dtypes and shapes."""
    half, full = str(tmp_path / "half"), str(tmp_path / "full")
    JU.run_project_split("synthetic", inp=_short(jax_project, with_lake=True),
                         end_day=1.0 / 24, outpath=half, verbose=False)
    ref = JU.run_project_split("synthetic",
                               inp=_short(jax_project, with_lake=True),
                               end_day=2.0 / 24, outpath=full, verbose=False)
    ckpt = os.path.join(half, "synthetic.ckpt.npz")
    out = str(tmp_path / "port")
    res = run_project_split(
        "synthetic", inp=_short(make_synthetic_project, with_lake=True),
        end_day=2.0 / 24, outpath=out, verbose=False, resume=ckpt,
        device="cpu")
    _check(ref, res)
    with np.load(ckpt) as za, \
            np.load(os.path.join(out, "synthetic.ckpt.npz")) as zb:
        assert sorted(za.files) == sorted(zb.files)
        assert {"bdf/lake/y", "bdf/surf/nfe", "buckets/snow"} <= set(za.files)
        for k in za.files:
            assert za[k].dtype == zb[k].dtype and za[k].shape == zb[k].shape, k


def test_split_program_writes_eager_files(tmp_path):
    """``run_project_split(captured=True)`` (a ``SplitGraph`` a run, one
    program launch and one host read a window) against the eager loop
    (``captured=False``, the CPU's default) on ``_twin()``: every file
    byte-equal, but for the time log's CPU and wall seconds (its time,
    progress and NFE columns equal), and the same final states."""
    from shud_tpu_torch.solver import bdf

    # one output path for both (the project file names it), moved aside
    out = str(tmp_path / "out")
    dirs = {c: str(tmp_path / str(c)) for c in (True, False)}
    states, syncs = {}, {}
    for c, d in dirs.items():
        s0 = bdf.host_syncs
        states[c] = run_project_split("synthetic", inp=_twin(), outpath=out,
                                      verbose=False, device="cpu",
                                      captured=c)
        syncs[c] = bdf.host_syncs - s0
        os.rename(out, d)
    n_windows = 360 // 10
    assert syncs[True] == n_windows < syncs[False]
    files = sorted(os.listdir(dirs[True]))
    assert files == sorted(os.listdir(dirs[False])) and len(files) > 10
    for name in files:
        a, b = (os.path.join(dirs[c], name) for c in (True, False))
        if name.endswith(".time.csv"):
            ra, rb = (np.loadtxt(x, skiprows=1, ndmin=2) for x in (a, b))
            keep = [0, 1, 2, 5]  # minutes, days, progress, NFE
            assert np.array_equal(ra[:, keep], rb[:, keep]), name
            continue
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), name
    for k in ("surf", "unsat", "gw", "riv", "lake"):
        x, y = getattr(states[True], k), getattr(states[False], k)
        assert (x.nsteps, x.nfe) == (y.nsteps, y.nfe), k
        assert torch.equal(x.y, y.y), k


def test_split_refusals(monkeypatch):
    """-g runs in float64 on the card unless the caller asks for the CPU,
    and refuses a frozen-ground project, naming the fused driver."""
    inp = _short(make_synthetic_project)
    inp.control.cryosphere = 1
    with pytest.raises(ValueError, match="fused driver"):
        run_project_split("synthetic", inp=inp, verbose=False, device="cpu")
    with pytest.raises(TypeError, match="float_dtype"):
        run_project_split("synthetic", inp=_short(make_synthetic_project),
                          verbose=False, device="cpu",
                          float_dtype=torch.float32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        run_project_split("synthetic", inp=_short(make_synthetic_project),
                          verbose=False)
