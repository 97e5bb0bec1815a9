"""The port's operator-split (``-g``) driver against the JAX package's.

``advance_window_uncoupled`` over 3 storm windows in f64 on a 6x4 mesh and
on a 12x6 lake mesh (the 5th, lake, sub-solve), on both routes (the hand
linearizations, ``linearize=True``, and ``torch.func.jvp`` of the sub-RHS):
every sub-state within rtol 1e-9 (atol 1e-12) of JAX's and equal steps and
NFE per sub-solver after every window, and the buckets
``Simulation.forcing_slice`` leaves within 1e-12 of JAX's.  ``SplitGraph``
with ``capture=False`` (the captured program's pieces run eagerly, each
WHILE and IF decided on the host) bitwise the eager sweep
(``sweep_window``) over the same windows, one host read a window.  The
runs of the driver are in tests/test_torch_split_run.py, the hand
linearizations against both packages' J·v in
tests/test_torch_split_lin.py.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

torch.set_num_threads(1)

from shud_tpu.driver import uncoupled as JU  # noqa: E402
from shud_tpu_torch.driver import uncoupled as TU  # noqa: E402
from shud_tpu_torch.driver.simulate import Simulation  # noqa: E402
from test_torch_cli import _jax_simulation  # noqa: E402
from torch_variants import make_project  # noqa: E402

PARTS = ("surf", "unsat", "gw", "riv", "lake")


def _storm(pkg, nx, ny, variant):
    """The project from minute 720 with the forcing shifted half a day, so
    the storm falls on the windows from there (as chip_smoke.py's
    storm_project)."""
    inp = make_project(pkg, variant, nx, ny, 1.0)
    inp.forc.t_min = [t - 720.0 for t in inp.forc.t_min]
    inp.control.day_start = 0.5
    return inp


def _pair(nx, ny, variant):
    a = _jax_simulation(_storm("jax", nx, ny, variant))
    b = Simulation.create("synthetic", inp=_storm("torch", nx, ny, variant),
                          device="cpu")
    return a, b


def _check(uj, ut):
    for k in PARTS:
        sj, st = getattr(uj, k), getattr(ut, k)
        assert (sj is None) == (st is None), k
        if sj is None:
            continue
        assert (st.nsteps, st.nfe) == (int(sj.nsteps), int(sj.nfe)), k
        assert float(st.t) == float(sj.t), k
        np.testing.assert_allclose(st.y.numpy(), np.asarray(sj.y),
                                   rtol=1e-9, atol=1e-12, err_msg=k)


def _wet(y0, ne):
    """*y0* with the surface wet and uneven (uniform(0, 1e-3) m from a
    seed)."""
    y0 = np.asarray(y0).copy()
    y0[:ne] = np.random.default_rng(0).uniform(0.0, 1e-3, ne)
    return y0


# the default route keeps the cases' ids; the torch.func.jvp route's
# cases end in "-jvp"
@pytest.mark.parametrize("nx,ny,variant,linearize", [
    pytest.param(nx, ny, v, lin, id=f"{nx}-{ny}-{v}" + ("" if lin else "-jvp"))
    for lin in (True, False) for nx, ny, v in ((6, 4, "plain"),
                                               (12, 6, "lake"))])
def test_advance_window_uncoupled_matches_jax(nx, ny, variant, linearize):
    """Three storm windows of the five sub-solvers in f64, on the hand
    linearizations and on ``torch.func.jvp``.  The surface starts wet and
    uneven: on a uniformly dry surface under uniform rain the surface
    sub-system's Krylov space is invariant after one vector, and what
    JAX's unguarded GMRES then returns depends on the round-off of its
    Gram-Schmidt remainder (tests/test_torch_solver.py::
    test_gmres_invariant_krylov_space holds the port there)."""
    a, b = _pair(nx, ny, variant)
    ne, nr, nl = a.md.num_ele, a.md.num_riv, a.md.num_lake
    assert (nl > 0) == (variant == "lake")
    y0 = _wet(a.bdf.y, ne)
    uj = JU.init_uncoupled(y0, ne, nr, a.t, a.cfg, nl=nl)
    ut = TU.init_uncoupled(torch.tensor(y0), ne, nr, b.t, b.cfg, nl=nl)
    t = b.t
    for _ in range(3):
        tout = t + 10.0
        fj, _ = a.forcing_slice(tout)
        ft, _ = b.forcing_slice(tout)
        uj = JU.advance_window_uncoupled(a.dm, fj, uj, t, tout, a.cfg)
        ut = TU.advance_window_uncoupled(b.dm, ft, ut, t, tout, b.cfg,
                                         linearize=linearize)
        t = tout
        _check(uj, ut)
    assert ut.surf.nsteps > 3 and ut.riv.nsteps > 3
    for k in ("ic_stg", "snow"):
        np.testing.assert_allclose(getattr(b.buckets, k).numpy(),
                                   np.asarray(getattr(a.buckets, k)),
                                   rtol=1e-12, atol=1e-15, err_msg=k)


def _same(a, b, what):
    """Two BDFStates bitwise equal (tensors and host scalars)."""
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), (what, f)
        else:
            assert x == y and type(x) is type(y), (what, f, x, y)


def _same_tree(a, b, what):
    if isinstance(a, dict):
        assert list(a) == list(b), what
        for k in a:
            _same_tree(a[k], b[k], f"{what}/{k}")
    else:
        assert a.dtype == b.dtype and np.array_equal(a, b), what


@pytest.mark.parametrize("nx,ny,variant", ((6, 4, "plain"),
                                           (12, 6, "lake")))
def test_split_graph_matches_eager_sweep(nx, ny, variant):
    """``SplitGraph(capture=False)``: the program's pieces (the glue, five
    solvers' WHILE and IF nodes, the window's values) run eagerly, bitwise
    the eager sweep over 3 storm windows in every sub-state, its scalars
    and the fetched values, with equal steps, NFE and Newton iterations;
    one host read a window, and the states it returns are copies that the
    next window leaves alone."""
    from shud_tpu_torch.solver import bdf

    b = Simulation.create("synthetic", inp=_storm("torch", nx, ny, variant),
                          device="cpu")
    ne, nr, nl = b.md.num_ele, b.md.num_riv, b.md.num_lake
    y0 = torch.tensor(_wet(b.bdf.y.numpy(), ne))
    ua = ub = TU.init_uncoupled(y0, ne, nr, b.t, b.cfg, nl=nl)
    g = TU.SplitGraph(b.dm, b.cfg, True, False, capture=False)
    t, kept = b.t, None
    for w in range(3):
        tout = t + 10.0
        fs, cf = b.forcing_slice(tout)
        it0 = bdf.newton_iters
        ua, ha = TU.sweep_window(b.dm, fs, cf, b.buckets, ua, t, tout, b.cfg)
        it_a, it0, s0 = bdf.newton_iters - it0, bdf.newton_iters, \
            bdf.host_syncs
        ub, hb = g.sweep(fs, cf, b.buckets, ub, t, tout)
        assert bdf.host_syncs - s0 == 1
        assert bdf.newton_iters - it0 == it_a > 0
        t = tout
        for k in PARTS:
            assert (getattr(ua, k) is None) == (getattr(ub, k) is None), k
            if getattr(ua, k) is not None:
                _same(getattr(ua, k), getattr(ub, k), (w, k))
        _same_tree(ha, hb, f"window {w}")
        if kept is not None:
            assert torch.equal(kept[0].y, kept[1])
        kept = (ub.gw, ub.gw.y.clone())
    assert (ub.lake is not None) == (variant == "lake")
    assert g.program.stats["launches"] == g.stats["syncs"] == 3
    assert not g.capture and ub.surf.nsteps > 3
    assert sum(s["surf"] for s in g.stats["steps"]) == ub.surf.nsteps
