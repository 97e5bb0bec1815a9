"""The port's operator-split (``-g``) driver against the JAX package's.

``advance_window_uncoupled`` over 3 storm windows in f64 on a 6x4 mesh and
on a 12x6 lake mesh (the 5th, lake, sub-solve): every sub-state within
rtol 1e-9 (atol 1e-12) of JAX's and equal steps and NFE per sub-solver
after every window, and the buckets ``Simulation.forcing_slice`` leaves
within 1e-12 of JAX's.  The runs of the driver are in
tests/test_torch_split_run.py.
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


@pytest.mark.parametrize("nx,ny,variant", ((6, 4, "plain"),
                                           (12, 6, "lake")))
def test_advance_window_uncoupled_matches_jax(nx, ny, variant):
    """Three storm windows of the five sub-solvers in f64.  The surface
    starts wet and uneven (uniform(0, 1e-3) m from a seed): on a uniformly
    dry surface under uniform rain the surface sub-system's Krylov space
    is invariant after one vector, and what JAX's unguarded GMRES then
    returns depends on the round-off of its Gram-Schmidt remainder
    (tests/test_torch_solver.py::test_gmres_invariant_krylov_space holds
    the port there)."""
    a, b = _pair(nx, ny, variant)
    ne, nr, nl = a.md.num_ele, a.md.num_riv, a.md.num_lake
    assert (nl > 0) == (variant == "lake")
    y0 = np.asarray(a.bdf.y).copy()
    y0[:ne] = np.random.default_rng(0).uniform(0.0, 1e-3, ne)
    uj = JU.init_uncoupled(y0, ne, nr, a.t, a.cfg, nl=nl)
    ut = TU.init_uncoupled(torch.tensor(y0), ne, nr, b.t, b.cfg, nl=nl)
    t = b.t
    for _ in range(3):
        tout = t + 10.0
        fj, _ = a.forcing_slice(tout)
        ft, _ = b.forcing_slice(tout)
        uj = JU.advance_window_uncoupled(a.dm, fj, uj, t, tout, a.cfg)
        ut = TU.advance_window_uncoupled(b.dm, ft, ut, t, tout, b.cfg)
        t = tout
        _check(uj, ut)
    assert ut.surf.nsteps > 3 and ut.riv.nsteps > 3
    for k in ("ic_stg", "snow"):
        np.testing.assert_allclose(getattr(b.buckets, k).numpy(),
                                   np.asarray(getattr(a.buckets, k)),
                                   rtol=1e-12, atol=1e-15, err_msg=k)
