"""The port's adaptive BDF Newton-Krylov solver (solver/bdf.py).

The toy problems of tests/test_solver.py with their bounds, and one
synthetic solver window in f64 against the JAX solver: the same step and
RHS-evaluation counts and a state within 1e-10.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

torch.set_num_threads(1)

from shud_tpu_torch.solver.bdf import (SolverConfig, bdf_init,  # noqa: E402
                                       solve_to)
from torch_variants import meshes, random_inputs  # noqa: E402


def _toy_f(t, y, k):
    return torch.stack([-k * y[0] + y[1], -0.1 * y[1] + 0.05 * torch.sin(y[0])])


def _toy_ref():
    from scipy.integrate import solve_ivp

    return solve_ivp(
        lambda t, y: np.array([-50.0 * y[0] + y[1],
                               -0.1 * y[1] + 0.05 * np.sin(y[0])]),
        (0, 10), [1.0, 0.5], method="BDF", rtol=1e-10, atol=1e-12,
    ).y[:, -1]


def test_toy_stiff_accuracy():
    cfg = SolverConfig(rtol=1e-6, atol=1e-9, h_max=1e9, h_init=1e-4)
    st = bdf_init(0.0, torch.tensor([1.0, 0.5], dtype=torch.float64), cfg)
    st = solve_to(_toy_f, st, 10.0, 50.0, cfg)
    assert np.abs(st.y.numpy() - _toy_ref()).max() < 1e-4
    assert st.nnifails == 0


def test_adaptive_linear_matches_expm():
    import scipy.linalg

    a = torch.tensor([[-8.0, 1.0], [0.5, -3.0]], dtype=torch.float64)
    y0 = torch.tensor([1.0, -0.5], dtype=torch.float64)
    cfg = SolverConfig(rtol=1e-7, atol=1e-10, h_max=1e9, h_init=1e-4)
    st = solve_to(lambda t, y, p: p @ y, bdf_init(0.0, y0, cfg), 2.0, a, cfg)
    exact = scipy.linalg.expm(a.numpy() * 2.0) @ y0.numpy()
    assert np.abs(st.y.numpy() - exact).max() < 1e-5


def test_toy_stiff_accuracy_order3():
    ref = _toy_ref()
    steps = {}
    for mo in (2, 3):
        cfg = SolverConfig(rtol=1e-6, atol=1e-9, h_max=1e9, h_init=1e-4,
                           max_order=mo)
        st = bdf_init(0.0, torch.tensor([1.0, 0.5], dtype=torch.float64), cfg)
        st = solve_to(_toy_f, st, 10.0, 50.0, cfg)
        assert np.abs(st.y.numpy() - ref).max() < 1e-4, mo
        steps[mo] = st.nsteps
    assert steps[3] < steps[2], steps


def _toy_jvp(y, v, k):
    """J(y)·v of _toy_f, by hand, in the order torch.func.jvp takes it."""
    return torch.stack([-k * v[0] + v[1],
                        -0.1 * v[1] + 0.05 * (torch.cos(y[0]) * v[0])])


class _Toy(torch.autograd.Function):
    """_toy_f with a hand tangent; counts its primal evaluations."""

    calls = 0

    @staticmethod
    def forward(y, k):
        _Toy.calls += 1
        return _toy_f(0.0, y, k)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.k = inputs[1]
        ctx.save_for_forward(inputs[0])

    @staticmethod
    def jvp(ctx, ty, _t_k):
        (y,) = ctx.saved_tensors
        return _toy_jvp(y, ty, ctx.k)


def test_linearize_hook_matches_func_jvp_route():
    """A linearize hook that evaluates the primal once and the hand tangent
    per Krylov vector gives the solve of the default route (torch.func.jvp
    of the RHS, which re-runs the primal for every vector) bitwise, with
    the same steps and NFE, and one primal evaluation per Newton
    iteration instead of 1 + krylov_m."""
    from shud_tpu_torch.solver import bdf

    cfg = SolverConfig(rtol=1e-6, atol=1e-9, h_max=1e9, h_init=1e-4)

    def f(t, y, k):
        return _Toy.apply(y, k)

    def lin(t, y, k):
        return f(t, y, k), lambda v: _toy_jvp(y, v, k)

    runs = {}
    for name, kw in (("jvp", {}), ("hook", {"linearize": lin})):
        _Toy.calls, it0 = 0, bdf.newton_iters
        st = bdf_init(0.0, torch.tensor([1.0, 0.5], dtype=torch.float64), cfg)
        st = solve_to(f, st, 10.0, 50.0, cfg, **kw)
        runs[name] = (st, _Toy.calls, bdf.newton_iters - it0)
    (a, calls_a, it_a), (b, calls_b, it_b) = runs["jvp"], runs["hook"]
    assert torch.equal(a.y, b.y)
    assert (a.nsteps, a.nfe, a.nfails) == (b.nsteps, b.nfe, b.nfails)
    assert it_a == it_b and b.nfe == it_b * (1 + cfg.krylov_m) > 0
    assert calls_b == it_b and calls_a == b.nfe
    assert np.abs(b.y.numpy() - _toy_ref()).max() < 1e-4


@pytest.mark.parametrize("max_order", (2, 3))
def test_synthetic_window_matches_jax(max_order):
    from shud_tpu.core import rhs as JR
    from shud_tpu.core.device import to_device
    from shud_tpu.core.state import ForcingSlice as JFS
    from shud_tpu.solver import bdf as JB
    from shud_tpu_torch.core import rhs as TR
    from shud_tpu_torch.core.device import to_torch
    from shud_tpu_torch.core.state import ForcingSlice as TFS

    md_j, md_t, cb = meshes("lake", 6, 4)
    fs, y = random_inputs(md_j, seed=5)
    fs["net_prcp"] = fs["net_prcp"] * 10.0  # a storm: several steps
    kw = dict(rtol=1e-4, atol=1e-4, h_max=10.0, h_init=1e-2,
              max_order=max_order)

    dm_j = to_device(md_j, jnp.float64)
    fs_j = JFS(**{k: jnp.asarray(v) for k, v in fs.items()})
    cfg_j = JB.SolverConfig(**kw)
    st_j = JB.solve_to(lambda t, yy, p: JR.rhs(p[0], p[1], t, yy, cb),
                       JB.bdf_init(0.0, jnp.asarray(y), cfg_j), 10.0,
                       (dm_j, fs_j), cfg_j)

    dm_t = to_torch(md_t, torch.float64, "cpu")
    fs_t = TFS(**{k: torch.tensor(v) for k, v in fs.items()})
    cfg_t = SolverConfig(**kw)
    st_t = solve_to(lambda t, yy, p: TR.rhs(p[0], p[1], t, yy, cb),
                    bdf_init(0.0, torch.tensor(y), cfg_t), 10.0,
                    (dm_t, fs_t), cfg_t)

    assert st_t.nsteps == int(st_j.nsteps) and st_t.nsteps > 3
    assert st_t.nfe == int(st_j.nfe)
    assert st_t.nfails == int(st_j.nfails)
    assert float(st_t.t) == float(st_j.t) == 10.0
    assert np.abs(st_t.y.numpy() - np.asarray(st_j.y)).max() <= 1e-10


@pytest.mark.parametrize("variant", ("plain", "open", "lake", "bc",
                                     "branched"))
def test_edge_linearize_hook_matches_func_jvp_route(variant, monkeypatch):
    """One f64 storm window solved with rhs.linearize as the hook and with
    the default route (torch.func.jvp of rhs for every Krylov vector):
    the same steps and NFE, states within 1e-9, and the edge coefficients
    computed once per Newton iteration (a counter on edge_coeff_plain, the
    coefficient kernel's plain version on the CPU, equals
    bdf.newton_iters)."""
    from shud_tpu_torch.core import edge as E
    from shud_tpu_torch.core import rhs as TR
    from shud_tpu_torch.core.device import to_torch
    from shud_tpu_torch.core.state import ForcingSlice as TFS
    from shud_tpu_torch.solver import bdf
    from torch_variants import with_bc

    md_j, md, cb = meshes("plain" if variant == "bc" else variant, 6, 4)
    if variant == "bc":
        md = with_bc(md)
    fs, y = random_inputs(md_j, seed=5)
    rng = np.random.default_rng(6)
    fs["net_prcp"] = fs["net_prcp"] * 10.0  # a storm: several steps
    fs["fu_sub"] = rng.uniform(0.3, 1.0, md.num_ele)
    if variant == "bc":
        fs["ele_ybc"] = rng.uniform(0.5, 3.0, md.num_ele)
        fs["riv_ybc"] = rng.uniform(0.05, 1.0, md.num_riv)
    dm = to_torch(md, torch.float64, "cpu")
    fs_t = TFS(**{k: torch.tensor(v) for k, v in fs.items()})
    cfg = SolverConfig(rtol=1e-4, atol=1e-4, h_max=10.0, h_init=1e-2)
    calls = []
    plain = E.edge_coeff_plain

    def counted(*a, **k):
        calls.append(1)
        return plain(*a, **k)

    monkeypatch.setattr(E, "edge_coeff_plain", counted)

    def f(t, yy, p):
        return TR.rhs(p[0], p[1], t, yy, cb)

    def lin(t, yy, p):
        return TR.linearize(p[0], p[1], t, yy, cb)

    runs = {}
    for name, kw in (("jvp", {}), ("hook", {"linearize": lin})):
        calls.clear()
        it0 = bdf.newton_iters
        st = solve_to(f, bdf_init(0.0, torch.tensor(y), cfg), 10.0,
                      (dm, fs_t), cfg, **kw)
        runs[name] = (st, len(calls), bdf.newton_iters - it0)
    (a, calls_a, it_a), (b, calls_b, it_b) = runs["jvp"], runs["hook"]
    assert (a.nsteps, a.nfe, a.nfails) == (b.nsteps, b.nfe, b.nfails)
    assert b.nsteps > 3 and float(b.t) == 10.0
    assert np.abs(a.y.numpy() - b.y.numpy()).max() <= 1e-9
    assert calls_a == 0 and calls_b == it_b == it_a > 0


@pytest.mark.parametrize("dtype,bar", ((torch.float64, 1e-14),
                                       (torch.float32, 1e-6)))
@pytest.mark.parametrize("rank", (1, 2))
def test_gmres_invariant_krylov_space(dtype, bar, rank):
    """GMRES(3) on a system whose Krylov space is invariant after *rank*
    vectors (a matrix with *rank* distinct eigenvalues, a right-hand side
    uniform on each eigenspace): what Gram-Schmidt leaves is round-off,
    counted as the breakdown it is, and the solve is exact.  Built on that
    round-off as a direction, the next vector broke the least-squares
    solve (the surface sub-system of the split driver on a uniformly dry
    surface under uniform rain returned 0)."""
    from shud_tpu_torch.solver.bdf import _gmres

    n = 48
    diag = torch.full((n,), 0.99, dtype=dtype)
    if rank == 2:
        diag[n // 2:] = 1.7
    b = torch.full((n,), 4.8e-7, dtype=dtype)
    x = _gmres(lambda v: diag * v, b, 3)
    assert (x - b / diag).abs().max() <= bar * (b / diag).abs().max()
