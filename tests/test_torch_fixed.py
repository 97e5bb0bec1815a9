"""The port's fixed-step BDF1 truth solver (solver/fixed.py) against the
JAX package's.

The linear toy of tests/test_solver.py within 1e-12 of JAX's trajectory
(and near the matrix exponential), and a 6x4 synthetic RHS in f64 over one
10-minute window at h = 0.5 min within 1e-10 scaled, once through the
default route (torch.func.jvp) and once through rhs.linearize.  The
solver reads nothing from the device inside the loop.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

torch.set_num_threads(1)

from shud_tpu.solver.fixed import fixed_bdf1 as jax_fixed  # noqa: E402
from shud_tpu_torch.solver import bdf  # noqa: E402
from shud_tpu_torch.solver.fixed import fixed_bdf1  # noqa: E402
from torch_variants import meshes, random_inputs, scaled_err  # noqa: E402

A = [[-8.0, 1.0], [0.5, -3.0]]


def test_linear_toy_matches_jax():
    import scipy.linalg

    a_j, y0 = jnp.array(A), np.array([1.0, -0.5])
    t_j, y_j = jax_fixed(lambda t, y, p: p @ y, jnp.asarray(y0), 0.0, a_j,
                         1e-3, 2000, 2)
    a_t = torch.tensor(A, dtype=torch.float64)
    syncs = bdf.host_syncs
    t_t, y_t = fixed_bdf1(lambda t, y, p: p @ y, torch.tensor(y0), 0.0, a_t,
                          1e-3, 2000, 2)
    assert bdf.host_syncs == syncs
    assert isinstance(t_t, np.float64)
    assert abs(float(t_t) - float(t_j)) <= 1e-12
    assert np.abs(y_t.numpy() - np.asarray(y_j)).max() <= 1e-12
    exact = scipy.linalg.expm(np.asarray(A) * 2.0) @ y0
    assert np.abs(y_t.numpy() - exact).max() < 1e-3


@pytest.fixture(scope="module")
def window():
    """(torch mesh, torch forcing, y0, close_boundary, JAX's truth) for one
    10-minute storm window at h = 0.5 min on a 6x4 synthetic mesh."""
    from shud_tpu.core import rhs as JR
    from shud_tpu.core.device import to_device
    from shud_tpu.core.state import ForcingSlice as JFS
    from shud_tpu_torch.core.device import to_torch
    from shud_tpu_torch.core.state import ForcingSlice as TFS

    md_j, md_t, cb = meshes("lake", 6, 4)
    fs, y = random_inputs(md_j, seed=5)
    fs["net_prcp"] = fs["net_prcp"] * 10.0  # a storm
    dm_j = to_device(md_j, jnp.float64)
    fs_j = JFS(**{k: jnp.asarray(v) for k, v in fs.items()})
    _, y_j = jax_fixed(lambda t, yy, p: JR.rhs(p[0], p[1], t, yy, cb),
                       jnp.asarray(y), 0.0, (dm_j, fs_j), 0.5, 20)
    dm_t = to_torch(md_t, torch.float64, "cpu")
    fs_t = TFS(**{k: torch.tensor(v) for k, v in fs.items()})
    return dm_t, fs_t, torch.tensor(y), cb, np.asarray(y_j)


@pytest.mark.parametrize("route", ("func_jvp", "linearize"))
def test_synthetic_rhs_matches_jax(window, route):
    from shud_tpu_torch.core import rhs as TR

    dm, fs, y0, cb, y_j = window

    def f(t, yy, p):
        return TR.rhs(p[0], p[1], t, yy, cb)

    def lin(t, yy, p):
        return TR.linearize(p[0], p[1], t, yy, cb)

    syncs = bdf.host_syncs
    t, y = fixed_bdf1(f, y0, 0.0, (dm, fs), 0.5, 20,
                      linearize=lin if route == "linearize" else None)
    assert bdf.host_syncs == syncs
    assert float(t) == 10.0
    assert np.isfinite(y.numpy()).all()
    assert np.abs(y.numpy() - y0.numpy()).max() > 1e-4  # it moved
    assert scaled_err(y_j, y.numpy()) <= 1e-10
