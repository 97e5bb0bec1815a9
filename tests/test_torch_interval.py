"""An output interval as one program (driver/fused.py ``IntervalGraph``),
its cryosphere on device state (core/cryo.py) and the per-window driver's
captured solve (driver/simulate.py), on the CPU.

* ``cryo_step`` on device state bitwise the host-branching version it
  replaced (kept here as the reference) in f32 and f64, and JAX's: bitwise
  in f64, within 1e-5 scaled in f32 (test_torch_window.py's f32 bar), over
  three days of 10-minute windows that flush and fill the rings.
* ``IntervalGraph`` with ``capture=False`` (the pieces a capture holds,
  each WHILE and IF decided by reading its predicate) over two intervals,
  the last one short, bitwise the eager ``run_interval``: state, buckets,
  cryosphere state, means, stages, qdowns, steps, NFE and Newton
  iterations, on the mega path's plain versions (f32) and the edge path
  (f64), with a lake, BCs with the cryosphere, and the quadrature.
* f64 within 1e-12 scaled of JAX's ``run_interval``, equal steps and NFE.
* The window times on the device bitwise the host's.
* ``Simulation.advance_window`` through a ``WindowGraph`` with
  ``capture=False`` bitwise its eager ``solve_to``, and within 1e-9 of
  JAX's ``Simulation`` (test_torch_cli.py's bar).
The interval graph itself (the capture, WHILE nodes) runs only on the
card: ``tests/test_torch_kernels.py`` (marker ``cuda``, no JAX) holds it
against the per-window replay and the eager loop, as ``chip_smoke.py``
phase 20 does at full size.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

torch.set_num_threads(1)

from shud_tpu_torch.core import cryo as TC  # noqa: E402
from shud_tpu_torch.core.landsurface import frozen_fraction  # noqa: E402
from shud_tpu_torch.driver.fused import (  # noqa: E402
    FusedSimulation, IntervalGraph, window_times)
from shud_tpu_torch.solver import bdf  # noqa: E402
from torch_variants import make_project, scaled_err  # noqa: E402

NX, NY = 6, 4
# two intervals: six windows, then a short one of three
INTERVALS = (60.0, 30.0)
BOUNDS = (-1.0, -5.0, -3.0, -10.0)


# ---------------------------------------------------------------------------
# the cryosphere on device state
# ---------------------------------------------------------------------------


def _host_push(st, temp, t_now):
    """The accumulator push as it was with host counters (``size``,
    ``head``, ``n_day``, ``time_start`` Python numbers, the flush decided
    on the host): the reference of the device-state version."""
    acc_day = st["acc_day"] + temp
    n_day = st["n_day"] + 1
    if not (t_now - st["time_start"]) >= 1440.0:
        return dict(st, acc_day=acc_day, n_day=n_day)
    maxlen = st["ring"].shape[0]
    day_mean = acc_day / n_day
    evicted = st["ring"][st["head"]] if st["size"] >= maxlen else 0.0
    ring = st["ring"].clone()
    ring[st["head"]] = day_mean
    return dict(ring=ring, size=min(st["size"] + 1, maxlen),
                head=(st["head"] + 1) % maxlen,
                acc=st["acc"] + day_mean - evicted,
                acc_day=torch.zeros_like(acc_day), n_day=0,
                time_start=t_now)


def _host_step(cs, temp, t_now):
    surf = _host_push(cs["surf"], temp, t_now)
    sub = _host_push(cs["sub"], temp, t_now)
    fu = [1.0 - frozen_fraction(s["acc"] / max(s["size"], 1), hi, lo)
          for s, hi, lo in ((surf, *BOUNDS[:2]), (sub, *BOUNDS[2:]))]
    return {"surf": surf, "sub": sub}, fu[0], fu[1]


@pytest.mark.parametrize("dtype", (torch.float64, torch.float32))
def test_device_cryo_matches_host_and_jax(dtype):
    """Three days of 10-minute windows (cold, then a thaw) into rings of 2
    and 3 days: after every window the device state and frozen fractions
    bitwise the host version's, and JAX's (f64 bitwise, f32 within
    1e-5 scaled); the rings flush four times, fill and evict."""
    from shud_tpu.core import cryo as JC

    ne = 5
    # flushes at minutes 710 (the first sample), 2150, 3590 and 5030
    temps = np.random.default_rng(4).uniform(-12.0, 4.0, (433, ne))
    temps[288:] += 10.0
    jd = {torch.float64: jnp.float64, torch.float32: jnp.float32}[dtype]
    dev = TC.cryo_init(ne, 2, 3, dtype, "cpu")
    z = TC.acc_temp_init(ne, 2, dtype, "cpu")
    host = {part: dict(ring=torch.zeros(n, ne, dtype=dtype), size=0, head=0,
                       acc=torch.zeros(ne, dtype=dtype),
                       acc_day=torch.zeros(ne, dtype=dtype), n_day=0,
                       time_start=-9999.0)
            for part, n in (("surf", 2), ("sub", 3))}
    jst = JC.cryo_init(ne, 2, 3, jd)
    assert z.size.dtype == torch.int64 and z.time_start.dtype == dtype
    dt = np.float64 if dtype == torch.float64 else np.float32
    for k in range(temps.shape[0]):
        t_now = float(dt(710.0) + dt(k) * dt(10.0))
        temp = torch.tensor(temps[k], dtype=dtype)
        dev, fs_d, fb_d = TC.cryo_step(
            dev, temp, torch.tensor(t_now, dtype=dtype), *BOUNDS)
        host, fs_h, fb_h = _host_step(host, temp, t_now)
        jst, fs_j, fb_j = JC.cryo_step(jst, jnp.asarray(temps[k], jd),
                                       t_now, *BOUNDS)
        assert torch.equal(fs_d, fs_h) and torch.equal(fb_d, fb_h), k
        for part in ("surf", "sub"):
            d, h = getattr(dev, part), host[part]
            for name in ("ring", "acc", "acc_day"):
                assert torch.equal(getattr(d, name), h[name]), (k, name)
            assert (int(d.size), int(d.head), int(d.n_day)) == (
                h["size"], h["head"], h["n_day"]), k
            assert float(d.time_start) == h["time_start"], k
        for got, want in ((fs_d, fs_j), (fb_d, fb_j)):
            if dtype == torch.float64:
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            else:
                assert scaled_err(np.asarray(want), got.numpy()) <= 1e-5
    assert int(dev.surf.size) == 2 and int(dev.sub.size) == 3
    assert int(dev.sub.head) == 1  # four flushes into three slots
    np.testing.assert_array_equal(np.asarray(jst.sub.ring, np.float64),
                                  dev.sub.ring.double().numpy())


def test_window_times_bitwise():
    """``t0 + w*win`` and ``t + win`` on 0-d tensors bitwise the host's
    ``dt(t0) + dt(w) * dt(win)`` in f32 and f64, at starts up to ten
    years of minutes."""
    rng = np.random.default_rng(11)
    t0s = np.concatenate([[0.0, 720.0, 5_256_000.0],
                          rng.uniform(0, 5_256_000.0, 200),
                          np.round(rng.uniform(0, 5_256_000.0, 200))])
    for dtype, dt in ((torch.float32, np.float32), (torch.float64,
                                                    np.float64)):
        for t0 in t0s:
            for w, win in ((0, 10.0), (5, 10.0), (143, 10.0), (23, 60.0),
                           (7, 1.5), (2, 0.1)):
                t_h, tout_h = window_times(dt(t0), w, dt(win))
                assert type(t_h) is dt
                t_d, tout_d = window_times(
                    torch.tensor(t0).to(dtype), torch.tensor(w),
                    torch.tensor(win, dtype=dtype))
                assert t_d.dtype == tout_d.dtype == dtype
                assert (float(t_d), float(tout_d)) == (float(t_h),
                                                       float(tout_h)), (
                    dtype, t0, w, win)


# ---------------------------------------------------------------------------
# the interval program
# ---------------------------------------------------------------------------


def _bc_cryo(inp):
    """*inp* with every BC and source class on (step series changing at
    minute 30) and the cryosphere on a frosty record (-4.5 C)."""
    inp.forc.data[0][:, 1] = -4.5
    inp.att[10, 6] = 1     # element head (Dirichlet) BC, series column 1
    inp.att[30, 6] = -1    # element flux (Neumann) BC, column 1
    inp.att[40, 7] = 1     # element source/sink series, column 1
    inp.riv[1, 5] = 1      # river stage BC
    inp.riv[3, 5] = -1     # river flux BC
    bt = np.array([0.0, 30.0])
    inp.bc = {
        "ele_y": (bt, np.array([[6.0], [6.5]])),
        "ele_q": (bt, np.array([[0.05], [0.02]])),
        "ele_ss": (bt, np.array([[0.03], [0.06]])),
        "riv_y": (bt, np.array([[0.8], [0.6]])),
        "riv_q": (bt, np.array([[0.2], [0.1]])),
    }
    inp.control.cryosphere = 1
    return inp


def _project(variant):
    inp = make_project("torch", "lake" if variant == "lake" else "plain",
                       NX, NY, 1.0)
    return _bc_cryo(inp) if variant == "bc_cryo" else inp


def _sims(path, variant, wb_exact=True):
    """Two fused simulations on the CPU, the second running each interval
    through an ``IntervalGraph`` (capture=False)."""
    dtype = torch.float32 if path == "mega" else torch.float64
    sims = [FusedSimulation.create(
        "synthetic", inp=_project(variant), float_dtype=dtype, device="cpu",
        mega=(path == "mega"), wb_exact=wb_exact) for _ in range(2)]
    b = sims[1]
    b.interval = IntervalGraph(b, round(INTERVALS[0] / 10.0), capture=False)
    return sims


def _same_tree(a, b, what):
    """Two trees of tensors and host numbers equal, bit for bit."""
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), what
    elif isinstance(a, dict):
        assert list(a) == list(b), what
        for k in a:
            _same_tree(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, tuple):
        assert len(a) == len(b), what
        for k, (x, y) in enumerate(zip(a, b)):
            _same_tree(x, y, f"{what}/{k}")
    else:
        assert a == b and type(a) is type(b), (what, a, b)


def _step_both(a, b, minutes):
    """One interval of each: (eager's outputs, the program's, eager's
    Newton iterations, the program's)."""
    it0 = bdf.newton_iters
    ma = a.advance_interval(minutes)
    it1 = bdf.newton_iters
    mb = b.advance_interval(minutes)
    return ma, mb, it1 - it0, bdf.newton_iters - it1


@pytest.mark.parametrize("path,variant", (
    ("edge", "lake"), ("mega", "lake"), ("edge", "bc_cryo"),
    ("mega", "bc_cryo")))
def test_interval_program_matches_eager(path, variant):
    """Two intervals, the last short: the program's every output bitwise
    the eager loop's, the same steps, NFE and Newton iterations; one
    launch and one host read an interval."""
    a, b = _sims(path, variant)
    assert b.mega is not None if path == "mega" else b.mega is None
    assert (b.cryo is not None, b.bc is not None) == (
        (variant == "bc_cryo",) * 2)
    for minutes in INTERVALS:
        ma, mb, it_a, it_b = _step_both(a, b, minutes)
        _same_tree(ma, mb, "outputs")
        _same_tree(a.last_mean_l, b.last_mean_l, "mean_l")
        _same_tree(tuple(a.bdf), tuple(b.bdf), "bdf")
        _same_tree(tuple(a.buckets), tuple(b.buckets), "buckets")
        if a.cryo is not None:
            _same_tree(tuple(map(tuple, a.cryo)), tuple(map(tuple, b.cryo)),
                       "cryo")
        assert it_a == it_b > 0
        assert mb[2].shape == (round(minutes / 10.0), b.md.num_riv)
    st = b.interval.stats
    assert st["launches"] == st["syncs"] == len(INTERVALS)
    assert st["windows"] == sum(round(m / 10.0) for m in INTERVALS)
    assert b.bdf.nsteps > st["windows"]
    if variant == "bc_cryo":  # frozen ground: subsurface fluxes cut
        assert float(TC.acc_temp_mean(b.cryo.sub).max()) < BOUNDS[2]


def test_interval_program_syncs_once():
    """The program reads the device once an interval: its host syncs are
    the launches, and its returned tensors are copies the next interval
    leaves alone."""
    _, b = _sims("edge", "plain", wb_exact=False)
    syncs = bdf.host_syncs
    out = b.advance_interval(60.0)
    assert bdf.host_syncs - syncs == 1
    kept = [x.clone() for x in (b.bdf.y, b.buckets.snow, out[0]["eta"],
                                out[2])]
    b.advance_interval(60.0)
    assert bdf.host_syncs - syncs == 2
    for x, y in zip(kept, (b.bdf.y, b.buckets.snow, out[0]["eta"], out[2])):
        assert x is not y
    assert torch.equal(kept[2], out[0]["eta"]) and torch.equal(kept[3],
                                                               out[2])
    assert not torch.equal(kept[0], b.bdf.y)


def test_interval_program_longer_interval_rebuilds():
    """An interval of more windows than the program holds makes a new one
    (one graph a simulation and shape of its buffers), still bitwise the
    eager loop."""
    a, b = _sims("edge", "plain", wb_exact=False)
    first = b.interval
    for minutes in (30.0, 90.0):
        ma, mb, it_a, it_b = _step_both(a, b, minutes)
        _same_tree(ma, mb, "outputs")
        _same_tree(tuple(a.bdf), tuple(b.bdf), "bdf")
        assert it_a == it_b
    assert b.interval is not first and b.interval.w_max == 9
    assert b.interval.capture is False


def test_interval_checkpoint_resume(tmp_path):
    """A checkpoint written between two intervals of the program (the
    cryosphere's device counters in it) resumes bitwise in a new
    simulation, whose program uploads it."""
    from shud_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint

    _, a = _sims("edge", "bc_cryo")
    _, c = _sims("edge", "bc_cryo")
    a.advance_interval(60.0)
    path = str(tmp_path / "mid.ckpt.npz")
    save_checkpoint(path, a)
    with np.load(path) as z:
        assert z["cryo/sub/size"].dtype == np.int32
        assert z["cryo/sub/time_start"].dtype == np.float64
    load_checkpoint(path, c)
    assert c.t == a.t and c.bdf.nsteps == a.bdf.nsteps
    assert c.cryo.sub.size.dtype == torch.int64
    ma = a.advance_interval(60.0)
    mc = c.advance_interval(60.0)
    _same_tree(ma, mc, "outputs")
    _same_tree(tuple(a.bdf), tuple(c.bdf), "bdf")
    _same_tree(tuple(map(tuple, a.cryo)), tuple(map(tuple, c.cryo)), "cryo")


@pytest.mark.parametrize("variant", ("lake", "bc_cryo"))
def test_interval_program_matches_jax_f64(variant):
    """f64 through the program and through JAX's ``run_interval`` (two
    one-hour intervals): equal steps and NFE, the state, the means and
    the stages within 1e-12 scaled.  With the BCs, the second hour only
    within the fused driver's f64 bar against JAX (1e-9 m,
    test_torch_driver.py): reach 2, between the stage and the flux BC,
    amplifies round-off there, and the port's own state moves 4.2e-12
    scaled when its initial state moves by 1e-15 relative."""
    from shud_tpu.driver.fused import FusedSimulation as JSim

    jinp = make_project("jax", "lake" if variant == "lake" else "plain", NX,
                        NY, 1.0)
    if variant == "bc_cryo":
        jinp = _bc_cryo(jinp)
    a = JSim.create("synthetic", inp=jinp, float_dtype=jnp.float64,
                    mega=False, pallas_edges=False)
    b = FusedSimulation.create("synthetic", inp=_project(variant),
                               float_dtype=torch.float64, device="cpu")
    b.interval = IntervalGraph(b, 6, capture=False)
    for hour in range(2):
        ma = a.advance_interval(60.0)
        mb = b.advance_interval(60.0)
        assert (b.bdf.nsteps, b.bdf.nfe) == (int(a.bdf.nsteps),
                                             int(a.bdf.nfe))
        if variant == "bc_cryo" and hour == 1:
            assert np.abs(b.y_np() - a.y_np()).max() <= 1e-9
            continue
        assert scaled_err(np.asarray(a.bdf.y), b.bdf.y.numpy()) <= 1e-12
        for da, db in zip(ma[:2], mb[:2]):
            for k in da:
                assert scaled_err(np.asarray(da[k]), db[k].numpy()) <= 1e-12, k
        assert scaled_err(np.asarray(ma[2]), mb[2].numpy()) <= 1e-12
    assert b.interval.stats["launches"] == 2


# ---------------------------------------------------------------------------
# the per-window driver's captured solve
# ---------------------------------------------------------------------------


def test_per_window_captured_form():
    """``Simulation.advance_window`` through the WHILE-form
    ``WindowGraph`` (capture=False) bitwise its eager ``solve_to`` over six
    storm windows, one host read a window, and within 1e-9 of JAX's
    per-window driver with equal NFE."""
    from shud_tpu_torch.driver.simulate import Simulation
    from shud_tpu_torch.solver.graph import WindowGraph
    from test_torch_cli import _jax_simulation, _storm

    a, b = (Simulation.create("synthetic", inp=_storm("torch", "plain"),
                              device="cpu") for _ in range(2))
    assert a.window is None  # the CPU solves eagerly unless given a graph
    b.window = WindowGraph(*b.window_functions(), b.cfg, capture=False)
    j = _jax_simulation(_storm("jax", "plain"))
    for w in range(6):
        tout = 730.0 + 10.0 * w
        a.advance_window(tout)
        syncs = bdf.host_syncs
        b.advance_window(tout)
        assert bdf.host_syncs - syncs == 1
        j.advance_window(tout)
        _same_tree(tuple(a.bdf), tuple(b.bdf), "bdf")
        _same_tree(tuple(a.buckets), tuple(b.buckets), "buckets")
        assert b.bdf.nfe == int(j.bdf.nfe), w
        assert np.abs(b.bdf.y.numpy() - np.asarray(j.bdf.y)).max() <= 1e-9
    assert b.window.stats["launches"] == 6
    assert sum(b.window.stats["steps"]) == b.bdf.nsteps > 6
