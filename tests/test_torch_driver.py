"""The port's fused driver, production run path and checkpoint against the
JAX package's.

f64: one interval within 1e-9 of JAX with equal NFE.  f32: within 2e-5 of
JAX's f32 XLA path (the bar of tests/test_pallas_mega.py:254) with NFE
within 2% (tests/test_f32.py).  run_project_fast writes the same file set,
with .dat payloads within rtol 1e-9 (f64).  A JAX checkpoint loads into
the port and the next interval matches.
"""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

torch.set_num_threads(1)

from shud_tpu.driver.fused import FusedSimulation as JSim  # noqa: E402
from shud_tpu_torch.driver.fused import FusedSimulation as TSim  # noqa: E402
from torch_variants import make_project  # noqa: E402

NX, NY = 8, 4


def _pair(variant, jd, td, nx=NX, ny=NY, **kw):
    a = JSim.create("synthetic", inp=make_project("jax", variant, nx, ny, 1.0),
                    float_dtype=jd, mega=False, pallas_edges=False, **kw)
    b = TSim.create("synthetic",
                    inp=make_project("torch", variant, nx, ny, 1.0),
                    float_dtype=td, device="cpu", **kw)
    return a, b


@pytest.mark.parametrize("variant", ("plain", "lake"))
def test_advance_interval_f64(variant):
    # the lake case also runs the exact water-balance quadrature
    a, b = _pair(variant, jnp.float64, torch.float64,
                 wb_exact=(variant == "lake"))
    ma = a.advance_interval(60.0)
    mb = b.advance_interval(60.0)
    assert b.bdf.nfe == int(a.bdf.nfe) and b.bdf.nsteps == int(a.bdf.nsteps)
    assert np.abs(b.y_np() - a.y_np()).max() <= 1e-9
    for da, db in zip(ma[:2], mb[:2]):
        for k in da:
            np.testing.assert_allclose(db[k].numpy(), np.asarray(da[k]),
                                       rtol=1e-9, atol=1e-15, err_msg=k)
    np.testing.assert_allclose(mb[2].numpy(), np.asarray(ma[2]), rtol=0,
                               atol=1e-9)
    for k, v in (a.bdf.quad or {}).items():
        assert abs(float(b.bdf.quad[k]) - float(v)) <= 1e-9 * max(
            1.0, abs(float(v))), k
    for k, v in a.last_mean_l.items():
        np.testing.assert_allclose(b.last_mean_l[k].numpy(), np.asarray(v),
                                   rtol=1e-9, atol=1e-15, err_msg=k)


def test_advance_interval_f32():
    # 12x8: on the 8x4 mesh the f32 round-off of the two frameworks drifts
    # to 2e-5 within the first window already
    a, b = _pair("plain", jnp.float32, torch.float32, nx=12, ny=8)
    a.advance_interval(60.0)
    b.advance_interval(60.0)
    assert b.y_np().dtype == np.float32
    assert np.abs(b.y_np().astype(np.float64)
                  - np.asarray(a.y_np(), np.float64)).max() < 2e-5
    nfe_a = int(a.bdf.nfe)
    assert abs(b.bdf.nfe - nfe_a) <= 0.02 * nfe_a


def _all_channels(inp):
    """Every output channel on, at two intervals a day."""
    for name in vars(inp.control):
        if name.startswith("dt_"):
            setattr(inp.control, name, 720)
    return inp


def test_run_project_fast_file_set(tmp_path):
    from shud_tpu.driver.run_fast import run_project_fast as jax_run
    from shud_tpu_torch.driver.run_fast import run_project_fast as torch_run

    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "torch")
    jax_run("synthetic",
            inp=_all_channels(make_project("jax", "plain", NX, NY, 1.0)),
            end_day=1.0, verbose=False, outpath=out_j)
    sim = torch_run(
        "synthetic",
        inp=_all_channels(make_project("torch", "plain", NX, NY, 1.0)),
        end_day=1.0, verbose=False, outpath=out_t, device="cpu")
    files = sorted(os.listdir(out_j))
    assert files == sorted(os.listdir(out_t))
    dats = [f for f in files if f.endswith(".dat")]
    assert len(dats) > 20
    for f in dats:
        with open(os.path.join(out_j, f), "rb") as fa, \
                open(os.path.join(out_t, f), "rb") as fb:
            fa.seek(1024)
            fb.seek(1024)
            pa = np.frombuffer(fa.read(), np.float64)
            pb = np.frombuffer(fb.read(), np.float64)
        assert pa.shape == pb.shape and pa.size > 2, f
        np.testing.assert_allclose(pb, pa, rtol=1e-9, atol=1e-15, err_msg=f)
    assert np.isfinite(sim.y_np()).all()
    assert float(sim.bdf.t) == 1440.0


def test_jax_checkpoint_resumes_in_port(tmp_path):
    from shud_tpu.io.checkpoint import save_checkpoint as jax_save
    from shud_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint

    a, b = _pair("lake", jnp.float64, torch.float64, wb_exact=True)
    a.advance_interval(30.0)
    path = str(tmp_path / "jax.ckpt.npz")
    jax_save(path, a)
    load_checkpoint(path, b)
    assert b.t == a.t and b.bdf.nsteps == int(a.bdf.nsteps)
    a.advance_interval(30.0)
    b.advance_interval(30.0)
    assert b.bdf.nfe == int(a.bdf.nfe)
    assert np.abs(b.y_np() - a.y_np()).max() <= 1e-9
    # the port writes the same layout back
    path2 = str(tmp_path / "port.ckpt.npz")
    save_checkpoint(path2, b)
    with np.load(path) as za, np.load(path2) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            assert za[k].dtype == zb[k].dtype and za[k].shape == zb[k].shape, k


@pytest.mark.parametrize("case", ("mega_f64", "mega_ineligible",
                                  "mega_auto_cpu", "cryosphere"))
def test_unported_options_refused(case):
    """Options that do not apply are refused, not silently dropped; on the
    CPU the megakernel path is off unless asked for.  The cryosphere,
    refused until it was ported, now builds its accumulators in the fused
    driver and is refused by the per-window driver, which has none (as in
    the JAX package)."""
    inp = make_project("torch", "plain", 4, 2, 1.0)
    if case == "mega_f64":
        with pytest.raises(ValueError, match="float32"):
            TSim.create("synthetic", inp=inp, mega=True, device="cpu")
    elif case == "mega_ineligible":
        inp.rivseg = inp.rivseg[:0]
        with pytest.raises(ValueError, match="not eligible"):
            TSim.create("synthetic", inp=inp, mega=True,
                        float_dtype=torch.float32, device="cpu")
    elif case == "mega_auto_cpu":
        sim = TSim.create("synthetic", inp=inp, float_dtype=torch.float32,
                          device="cpu")
        assert sim.mega is None
    else:
        from shud_tpu_torch.driver.simulate import Simulation

        inp.control.cryosphere = 1
        sim = TSim.create("synthetic", inp=inp, device="cpu")
        ne = sim.md.num_ele
        assert tuple(sim.cryo.surf.ring.shape) == (7, ne)
        assert tuple(sim.cryo.sub.ring.shape) == (28, ne)
        with pytest.raises(ValueError, match="cryosphere"):
            Simulation.create("synthetic", inp=inp, device="cpu")


def test_entry_points_default_to_the_card(monkeypatch):
    """Without a CUDA device the entry points raise and name the CPU
    option; nothing carries on on the CPU unasked."""
    from shud_tpu_torch.driver.run_fast import run_project_fast

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    inp = make_project("torch", "plain", 4, 2, 1.0)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TSim.create("synthetic", inp=inp)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        run_project_fast("synthetic", inp=inp, end_day=1.0, verbose=False)
