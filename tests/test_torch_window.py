"""The solver's device-scalar step body and the captured window's replay
logic (solver/bdf.py, solver/graph.py), on the CPU.

* The step body against JAX's ``solve_to`` over storm windows with
  rejected steps and Newton failures: equal steps, NFE, failures and
  order; f64 states within 1e-12 scaled, f32 within 1e-5 scaled (two
  frameworks' roundings of the same float32 arithmetic).
* ``WindowGraph`` with ``capture=False``: the pieces a capture holds, run
  eagerly with each IF decided by reading its predicate, S steps a launch,
  bitwise equal to the eager ``solve_to`` loop with equal counters, on the
  solver alone and inside the fused driver (both RHS paths, the
  quadrature on).  The capture itself runs only on the card
  (``chip_smoke.py``).
* ``BDFState`` through the device carry and back, a checkpoint resumed in
  the middle of a run of captured windows, and ``run_fast``'s one-transfer
  fetch against the leaf-by-leaf one.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

torch.set_num_threads(1)

from shud_tpu_torch.solver import bdf  # noqa: E402
from shud_tpu_torch.solver.bdf import (  # noqa: E402
    SolverConfig, bdf_init, solve_to)
from shud_tpu_torch.solver.graph import WindowGraph  # noqa: E402
from torch_variants import (  # noqa: E402
    make_project, meshes, random_inputs, scaled_err)

# a storm on the 6x4 lake mesh with a 10-minute first step and two Newton
# iterations: rejected steps and Newton failures in every window
STORM = dict(rtol=1e-4, atol=1e-4, h_max=10.0, h_init=10.0, newton_iters=2)
WINDOWS = (10.0, 20.0)


def _inputs():
    md_j, md_t, cb = meshes("lake", 6, 4)
    fs, y = random_inputs(md_j, seed=5)
    fs["net_prcp"] = fs["net_prcp"] * 10.0
    return md_j, md_t, cb, fs, y


def _jax_storm(dtype, **kw):
    """JAX's states after each of WINDOWS."""
    from shud_tpu.core import rhs as JR
    from shud_tpu.core.device import to_device
    from shud_tpu.core.state import ForcingSlice as JFS
    from shud_tpu.solver import bdf as JB

    md_j, _, cb, fs, y = _inputs()
    jd = {torch.float64: jnp.float64, torch.float32: jnp.float32}[dtype]
    dm_j = to_device(md_j, jd)
    fs_j = JFS(**{k: jnp.asarray(v, jd) for k, v in fs.items()})
    cfg_j = JB.SolverConfig(**{**STORM, **kw})
    st_j = JB.bdf_init(0.0, jnp.asarray(y, jd), cfg_j)
    states = []
    for tout in WINDOWS:
        st_j = JB.solve_to(lambda t, yy, p: JR.rhs(p[0], p[1], t, yy, cb),
                           st_j, tout, (dm_j, fs_j), cfg_j)
        states.append(st_j)
    return states


def _storm(dtype, **kw):
    """The port's (y0, f, linearize hook, params, cfg) of the storm: the
    params are the forcing slice, the mesh a constant of f."""
    from shud_tpu_torch.core import rhs as TR
    from shud_tpu_torch.core.device import to_torch
    from shud_tpu_torch.core.state import ForcingSlice as TFS

    _, md_t, cb, fs, y = _inputs()
    dm = to_torch(md_t, dtype, "cpu")
    params = TFS(**{k: torch.tensor(v, dtype=dtype) for k, v in fs.items()})

    def f(t, yy, p):
        return TR.rhs(dm, p, t, yy, cb)

    def lin(t, yy, p):
        return TR.linearize(dm, p, t, yy, cb)

    return (torch.tensor(y, dtype=dtype), f, lin, params,
            SolverConfig(**{**STORM, **kw}))


@pytest.mark.parametrize("dtype,bar,max_order", (
    (torch.float64, 1e-12, 2), (torch.float64, 1e-12, 3),
    (torch.float32, 1e-5, 2)))
def test_step_body_matches_jax(dtype, bar, max_order):
    jax_states = _jax_storm(dtype, max_order=max_order)
    y0, f, lin, params, cfg = _storm(dtype, max_order=max_order)
    st = bdf_init(0.0, y0, cfg)
    for tout, sj in zip(WINDOWS, jax_states):
        st = solve_to(f, st, tout, params, cfg, linearize=lin)
        got = (st.nsteps, st.nfe, st.nfails, st.nnifails, st.order)
        want = tuple(int(v) for v in (sj.nsteps, sj.nfe, sj.nfails,
                                      sj.nnifails, sj.order))
        assert got == want, (tout, got, want)
        assert float(st.t) == float(sj.t) == tout
        assert scaled_err(np.asarray(sj.y), st.y.numpy()) <= bar
    assert st.nfails > 0 and st.nnifails > 0


def _same(a, b):
    """Two BDFStates bitwise equal, counters and quadrature included."""
    assert (a.t, a.h, a.h_prev, a.h_prev2) == (b.t, b.h, b.h_prev, b.h_prev2)
    assert (a.order, a.nfe, a.nsteps, a.nfails, a.nnifails) == (
        b.order, b.nfe, b.nsteps, b.nfails, b.nnifails)
    for x, y in ((a.y, b.y), (a.y_prev, b.y_prev), (a.y_prev2, b.y_prev2)):
        assert torch.equal(x, y)
    assert (a.quad is None) == (b.quad is None)
    for k in a.quad or {}:
        assert torch.equal(a.quad[k], b.quad[k]), k


@pytest.mark.parametrize("if_depth", (1, 2, 8))
def test_guarded_window_matches_eager_loop(if_depth):
    """The WHILE form: the step loop under one WHILE node (read here), the
    Newton iterations 2..newton_iters under *if_depth* nested IFs: the
    eager loop's states bitwise, window by window, one launch and one host
    sync a window."""
    y0, f, lin, params, cfg = _storm(torch.float64,
                                     newton_iters=if_depth + 1)
    win = WindowGraph(f, lin, cfg, capture=False)
    a = b = bdf_init(0.0, y0, cfg)
    for k, tout in enumerate(WINDOWS):
        it0 = bdf.newton_iters
        a = solve_to(f, a, tout, params, cfg, linearize=lin)
        it_a, it0 = bdf.newton_iters - it0, bdf.newton_iters
        syncs = bdf.host_syncs
        b = win.solve(b, tout, params)
        it_b = bdf.newton_iters - it0
        _same(a, b)
        assert it_a == it_b > 0
        assert win.stats["launches"] == k + 1
        assert bdf.host_syncs - syncs == 1
    assert b.nfails > 0 and b.nnifails > 0
    assert sum(win.stats["steps"]) == b.nsteps
    assert max(win.stats["steps"]) > 8  # above the IF form's 8 a launch


def test_window_returns_copies():
    """A returned state owns its tensors: the next window does not move
    them, and a state handed back changed is uploaded again."""
    y0, f, lin, params, cfg = _storm(torch.float64)
    win = WindowGraph(f, lin, cfg, capture=False)
    s1 = win.solve(bdf_init(0.0, y0, cfg), WINDOWS[0], params)
    kept = s1.y.clone()
    s2 = win.solve(s1, WINDOWS[1], params)
    assert torch.equal(s1.y, kept) and not torch.equal(s2.y, kept)
    # a new state object (here: the first window's again) is uploaded
    s2b = win.solve(s1._replace(), WINDOWS[1], params)
    _same(s2, s2b)


def _sims(path: str, **kw):
    """Two fused simulations of the 8x4 lake project on the CPU, the
    second solving through a WindowGraph (capture=False)."""
    from shud_tpu_torch.driver.fused import FusedSimulation, window_functions

    dtype = torch.float32 if path == "mega" else torch.float64
    sims = [FusedSimulation.create(
        "synthetic", inp=make_project("torch", "lake", 8, 4, 1.0),
        float_dtype=dtype, device="cpu", mega=(path == "mega"),
        wb_exact=True, **kw) for _ in range(2)]
    b = sims[1]
    f, lin, qfn = window_functions(b.dm, b.mega, bool(
        b.inp.control.close_boundary), b.mega_kernel, True)
    b.window = WindowGraph(f, lin, b.cfg, quad_fn=qfn, capture=False)
    return sims


@pytest.mark.parametrize("path", ("edge", "mega"))
def test_fused_driver_through_window(path):
    """The fused driver with a WindowGraph (its static forcing refilled
    every window) bitwise equal to the eager loop, quadrature included."""
    a, b = _sims(path)
    for _ in range(2):
        ma = a.advance_interval(60.0)
        mb = b.advance_interval(60.0)
        _same(a.bdf, b.bdf)
        for da, db in zip(ma, mb):
            for x, y in (zip(da.values(), db.values())
                         if isinstance(da, dict) else ((da, db),)):
                assert torch.equal(x, y)
    assert len(b.window.stats["steps"]) == 12
    assert sum(b.window.stats["steps"]) == b.bdf.nsteps > 12


def test_carry_round_trip():
    from shud_tpu_torch.solver.bdf import finish, to_carry

    y0, f, lin, params, cfg = _storm(torch.float32)
    st = solve_to(f, bdf_init(0.0, y0, cfg, quad0={
        "et": torch.tensor(1.5, dtype=torch.float32)}), WINDOWS[0], params,
        cfg, linearize=lin, quad_fn=lambda t, y, p: {"et": y.sum()})
    back = finish(to_carry(st), True)
    _same(st, back)
    assert type(back.t) is type(st.t) is np.float32
    assert isinstance(back.nfe, int) and back.nfe == st.nfe > 0


def test_checkpoint_resume_mid_run(tmp_path):
    """A checkpoint written between two captured-path windows resumes in a
    new simulation whose window graph uploads it: the next interval
    bitwise equal to the uninterrupted run's."""
    from shud_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint

    _, a = _sims("edge")
    _, c = _sims("edge")
    a.advance_interval(30.0)
    path = str(tmp_path / "mid.ckpt.npz")
    save_checkpoint(path, a)
    load_checkpoint(path, c)
    assert c.t == a.t and c.bdf.nsteps == a.bdf.nsteps
    a.advance_interval(30.0)
    c.advance_interval(30.0)
    _same(a.bdf, c.bdf)
    assert c.window.stats["steps"] and a.window.stats["steps"]


def test_to_host_one_transfer():
    """run_fast's fetch: every tensor of the tree in one transfer, the
    unpacked dict equal to the leaf-by-leaf one."""
    from shud_tpu_torch.driver import run_fast

    rng = np.random.default_rng(3)

    def t(*shape):
        return torch.tensor(rng.standard_normal(shape))

    tree = {"y": t(40), "ic": t(12), "quad": {"et": t(), "qout": t()},
            "nfe": 17, "none": None,
            "mean_e": {"y_surf": t(12), "eta": t(12)}, "stages": t(6, 5),
            "mean_l": {}, "f32": t(3).float()}
    calls = []
    cpu = torch.Tensor.cpu

    def counted(self, *a, **k):
        calls.append(self.numel())
        return cpu(self, *a, **k)

    torch.Tensor.cpu = counted
    try:
        got = run_fast._to_host(tree)
    finally:
        torch.Tensor.cpu = cpu
    assert len(calls) == 2  # one float64 buffer, one float32

    def leafwise(x):
        if isinstance(x, dict):
            return {k: leafwise(v) for k, v in x.items()}
        return x.numpy() if isinstance(x, torch.Tensor) else x

    want = leafwise(tree)

    def same(g, w):
        assert type(g) is type(w) or isinstance(g, np.ndarray)
        if isinstance(w, dict):
            assert list(g) == list(w)
            for k in w:
                same(g[k], w[k])
        elif isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert np.array_equal(g, w)
        else:
            assert g == w

    same(got, want)
