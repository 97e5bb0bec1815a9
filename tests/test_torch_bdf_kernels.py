"""The solver's step and Newton–Krylov body split at its reductions
(``shud_tpu_torch/solver/kernels.py``): the plain versions of its four CUDA
kernels, which the CPU runs and each kernel is held against on the card.

* Each plain version is bitwise the torch expression of ``solver/bdf.py``
  it replaces (``solver_kernel=False``), in float32 and float64, on inputs
  made with numpy from a seed: the step's plan and first Newton
  iteration (orders 1-3, the history predictor on and off), the
  residual, matvec and Gram-Schmidt updates, the Newton update through
  ``_gmres`` (every m = 1..8 the last column's kernel is instantiated
  for, a zero beta, a breakdown column on an invariant Krylov space), the
  Newton tail and the step end.
* The whole route bitwise the torch pieces, with equal steps, NFE and
  Newton iterations: a toy stiff problem (orders 2 and 3), a 12x8 storm
  window on the mega path's plain hook, one -g window through
  ``SplitGraph``'s pieces run eagerly, and the fixed-step truth.
* Against JAX in float64: ``solve_to`` within 1e-12 scaled, with equal
  steps and NFE; the Newton update against ``_gmres`` for m = 1..8 within
  1e-12 scaled.
* The wide or one-entry form of S2 and S3 (``vec_width``) on fresh
  allocations and views.

The kernels themselves run on the card only (tests/test_torch_kernels.py).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

torch.set_num_threads(1)

from shud_tpu_torch.solver import bdf  # noqa: E402
from shud_tpu_torch.solver import kernels as K  # noqa: E402
from torch_variants import make_project  # noqa: E402

DTYPES = (torch.float32, torch.float64)
N = 37


def _vec(rng, dtype, lo=None, hi=None, scale=1.0, n=N):
    a = (rng.uniform(lo, hi, n) if lo is not None
         else scale * rng.standard_normal(n))
    return torch.as_tensor(a).to(dtype)


def _carry(rng, dtype, order, h=0.73):
    y = _vec(rng, dtype, 0.0, 2.0)
    yp = y + _vec(rng, dtype, scale=1e-3)
    yp2 = yp + _vec(rng, dtype, scale=1e-3)

    def sc(v, dt=dtype):
        return torch.tensor(v, dtype=dt)

    i64 = torch.int64
    return bdf.Carry(t=sc(700.25), h=sc(h), h_prev=sc(0.5), h_prev2=sc(0.31),
                     order=sc(order, i64), nfe=sc(40, i64), nsteps=sc(9, i64),
                     nfails=sc(1, i64), nnifails=sc(0, i64), nni=sc(18, i64),
                     y=y, y_prev=yp, y_prev2=yp2, quad={})


def _equal(a, b, what):
    for f, x in a._asdict().items():
        y = getattr(b, f)
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), (what, f)
        else:
            assert x == y and type(x) is type(y), (what, f, x, y)


def _diag_lin(d):
    def lin(t, y):
        return -d * y + 0.01, lambda v: -d * v
    return lin


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("history,max_order,order", [
    (True, 2, 1), (True, 2, 2), (False, 2, 1), (False, 2, 2),
    (False, 3, 1), (False, 3, 2), (False, 3, 3)])
@pytest.mark.parametrize("tout", (20.0, 0.2))
def test_step_begin_plain_matches_torch_pieces(dtype, history, max_order,
                                               order, tout):
    """S1 and the first Newton iteration (S2, S3, the Newton tail) on the
    plain route: the plan and the iterate bitwise the torch pieces'."""
    rng = np.random.default_rng(order)
    c = _carry(rng, dtype, order)
    cfg = bdf.SolverConfig(max_order=max_order, history_predictor=history)
    d = _vec(rng, dtype, 0.5, 4.0)

    def rhs(t, y):
        return -d * y + 0.01

    t_out = c.t + tout
    lin = _diag_lin(d)
    plan_t, nw_t = bdf.step_begin(rhs, lin, c, t_out, cfg)
    s = K.Scratch(c.y, cfg.krylov_m)
    plan_k, nw_k = bdf.step_begin(rhs, lin, c, t_out, cfg, scratch=s)
    _equal(plan_t, plan_k, "plan")
    _equal(nw_t, nw_k, "first Newton iteration")
    assert int(nw_k.it) == 1
    # a second iteration from the first
    nw_t2 = bdf.newton_iter(lin, plan_t, nw_t.y, nw_t.it, cfg)
    nw_k2 = bdf.newton_iter(lin, plan_k, nw_k.y, nw_k.it, cfg, scratch=s)
    _equal(nw_t2, nw_k2, "second Newton iteration")


@pytest.mark.parametrize("dtype", DTYPES)
def test_krylov_axpy_plain_matches_torch_expressions(dtype):
    rng = np.random.default_rng(1)
    x, y, z = (_vec(rng, dtype) for _ in range(3))
    k = torch.tensor(float(rng.uniform(0.1, 3.0)), dtype=dtype)
    out = torch.empty_like(x)
    K.krylov_axpy(K.RESIDUAL, k, x, y, out, z)
    assert torch.equal(out, -(x - k * y - z))
    K.krylov_axpy(K.MATVEC, k, x, y, out)
    assert torch.equal(out, x - k * y)
    want = -k * x + y
    K.krylov_axpy(K.GRAM_SCHMIDT, k, x, y, y)  # in place, as w
    assert torch.equal(y, want)


def _update(dtype, m, diag, y, fy, c0, k):
    """The Newton update through the plain kernels and through
    ``bdf._gmres``: (kernel route's y + dy, the torch pieces')."""
    s = K.Scratch(y, m)
    out = torch.empty_like(y)

    def jvp(v):
        return diag * v

    K.newton_update(s, jvp, y, fy, c0, k, out, norms=False)
    res = y - k * fy - c0
    ref = y + bdf._gmres(lambda v: v - k * jvp(v), -res, m)
    return out, ref, s


# every Krylov dimension the last column's kernel is instantiated for
KRYLOV_MS = tuple(range(1, K.MAX_KRYLOV + 1))


def _update_inputs(rng, dtype):
    """y, c0, the diagonal of J and fy of a Newton update."""
    y, c0 = _vec(rng, dtype, 0, 2), _vec(rng, dtype, 0, 2)
    return y, c0, _vec(rng, dtype, -3.0, -0.5), _vec(rng, dtype, scale=1e-2)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m", KRYLOV_MS)
def test_newton_update_plain_matches_gmres(dtype, m):
    rng = np.random.default_rng(m)
    y, c0, diag, fy = _update_inputs(rng, dtype)
    out, ref, s = _update(dtype, m, diag, y, fy, c0,
                          torch.tensor(0.37, dtype=dtype))
    assert torch.equal(out, ref)
    assert float(s.beta) > 0 and bool(torch.isfinite(s.ys).all())


@pytest.mark.parametrize("m", KRYLOV_MS)
def test_newton_update_matches_jax_gmres(m):
    """The port's Newton update (the plain S2 and S3 split at the kept
    dot products) within 1e-12 scaled of ``y + shud_tpu.solver.bdf._gmres``
    on the same numpy inputs, float64."""
    from shud_tpu.solver import bdf as JB

    rng = np.random.default_rng(100 + m)
    y, c0, diag, fy = _update_inputs(rng, torch.float64)
    k = 0.37
    s = K.Scratch(y, m)
    out = torch.empty_like(y)
    K.newton_update(s, lambda v: diag * v, y, fy, c0,
                    torch.tensor(k, dtype=torch.float64), out, norms=False)
    yj, c0j, dj, fyj = (jnp.asarray(t.numpy()) for t in (y, c0, diag, fy))
    assert yj.dtype == jnp.float64
    dy = JB._gmres(lambda v: v - k * (dj * v), -(yj - k * fyj - c0j), m)
    ref = np.asarray(yj + dy)
    assert np.abs(out.numpy() - ref).max() <= 1e-12 * np.abs(ref).max()
    dy_port = out.numpy() - y.numpy()
    assert (np.abs(dy_port - np.asarray(dy)).max()
            <= 1e-12 * np.abs(np.asarray(dy)).max() + 1e-15)


@pytest.mark.parametrize("dtype", DTYPES)
def test_vec_width(dtype):
    """S2's and S3's form from n, the dtype and the addresses: 16 bytes of
    entries a thread on fresh allocations, one entry a thread on a view
    one entry in or an n below 16 bytes' worth."""
    wide = 16 // (torch.finfo(dtype).bits // 8)
    n = 37
    a, b = torch.zeros(n, dtype=dtype), torch.zeros(n, dtype=dtype)
    view = torch.zeros(n + 1, dtype=dtype)[1:]
    short = torch.zeros(wide - 1, dtype=dtype)
    assert K.vec_width(dtype, n, (a.data_ptr(), b.data_ptr())) == wide
    assert K.vec_width(dtype, n, (a.data_ptr(), 0)) == wide  # z absent
    assert K.vec_width(dtype, n, (a.data_ptr(), view.data_ptr())) == 1
    assert K.vec_width(dtype, wide - 1, (short.data_ptr(),)) == 1
    assert K.vec_width(dtype, wide, (a.data_ptr(),)) == wide
    # a view whose offset keeps 16-byte alignment takes the wide form
    aligned = torch.zeros(n + wide, dtype=dtype)[wide:]
    assert K.vec_width(dtype, n, (aligned.data_ptr(),)) == wide


@pytest.mark.parametrize("dtype", DTYPES)
def test_newton_update_plain_zero_beta(dtype):
    """A zero residual: beta 0, dy 0 (``where(beta > 0)``)."""
    rng = np.random.default_rng(2)
    y = _vec(rng, dtype, 0, 2)
    k = torch.tensor(0.5, dtype=dtype)
    fy = _vec(rng, dtype, scale=1e-2)
    c0 = y - k * fy
    out, ref, s = _update(dtype, 3, _vec(rng, dtype, -2, -1), y, fy, c0, k)
    assert torch.equal(out, ref) and torch.equal(out, y)
    assert float(s.beta) == 0.0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rank", (1, 2))
def test_newton_update_plain_breakdown(dtype, rank):
    """The input of test_torch_solver.py::test_gmres_invariant_krylov_space:
    a Krylov space invariant after *rank* vectors, whose Gram-Schmidt
    remainder is round-off counted as a breakdown."""
    n = 48
    diag = torch.full((n,), 0.99, dtype=dtype)
    if rank == 2:
        diag[n // 2:] = 1.7
    k = torch.tensor(1.0, dtype=dtype)
    zero = torch.zeros(n, dtype=dtype)
    b = torch.full((n,), 4.8e-7, dtype=dtype)
    # -(y - k·fy - c0) = b with y = 0, fy = 0, c0 = b; the operator
    # v - k·J·v = diag·v with J = (1 - diag)
    s = K.Scratch(zero, 3)
    out = torch.empty_like(zero)
    K.newton_update(s, lambda v: (1 - diag) * v, zero, zero, b, k, out,
                    norms=False)
    ref = bdf._gmres(lambda v: v - k * ((1 - diag) * v), b, 3)
    assert torch.equal(out, zero + ref)
    tol = {torch.float64: 1e-14, torch.float32: 1e-6}[dtype]
    assert (out - b / diag).abs().max() <= tol * (b / diag).abs().max()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dnorm,err,h", [(0.1, 0.37, 0.73), (0.1, 3.7, 0.73),
                                         (0.9, 0.37, 0.73), (0.1, 37.0, 1e-6),
                                         (0.1, 0.0, 0.73)])
def test_step_end_plain_matches_torch_pieces(dtype, dnorm, err, h):
    """S4: the Newton tail's dnorm as ``_wrms``, and the step end (accepted,
    rejected, not converged, at h_min, err 0) bitwise the torch
    ``step_end``: every scalar, counter and state of the carry, and the
    step loop's ``active``."""
    rng = np.random.default_rng(3)
    cfg = bdf.SolverConfig()
    c = _carry(rng, dtype, 2, h=h)
    s = K.Scratch(c.y, cfg.krylov_m)
    s.y.copy_(c.y + _vec(rng, dtype, scale=1e-3))
    s.y_pred.copy_(c.y + _vec(rng, dtype, scale=err * 1e-3))
    s.ewt.copy_(_vec(rng, dtype, 10.0, 1e3))
    s.h.fill_(h)
    s.t_new.copy_(c.t + s.h)
    s.it.fill_(2)
    # the Newton tail: dnorm of a random update
    dy = _vec(rng, dtype, scale=dnorm * 1e-3)
    K.bdf_finish(s, K.NEWTON, cfg, torch.sum((dy * s.ewt) ** 2))
    assert torch.equal(s.dnorm, bdf._wrms(dy, s.ewt)) and int(s.it) == 3
    assert torch.equal(s.more, bdf._wrms(dy, s.ewt) > cfg.newton_tol)
    plan = bdf.StepPlan(s.h.clone(), s.ewt, s.y_pred, s.c0, s.bh, s.t_new)
    nw = bdf.NewtonIter(s.y.clone(), s.dnorm.clone(), s.it.clone(),
                        s.more.clone())
    tout = c.t + 20.0
    nsteps0 = torch.tensor(3)
    ref = bdf.step_end(c, plan, nw, cfg)
    go = torch.ones((), dtype=torch.bool)
    sq = ((s.y - s.y_pred) * s.ewt) ** 2
    c_k = bdf.Carry(**{k: (v.clone() if isinstance(v, torch.Tensor) else v)
                       for k, v in c._asdict().items()})
    K.bdf_finish(s, K.STEP, cfg, torch.sum(sq), c_k, tout, nsteps0, go)
    _equal(ref, c_k, "carry")
    assert torch.equal(go, bdf.active(ref, tout, nsteps0, cfg))


def _toy(t, y, k):
    return torch.stack([-k * y[0] + y[1],
                        -0.1 * y[1] + 0.05 * torch.sin(y[0])])


def _toy_lin(t, y, k):
    c = 0.05 * torch.cos(y[0])
    return _toy(t, y, k), lambda v: torch.stack([-k * v[0] + v[1],
                                                 -0.1 * v[1] + c * v[0]])


def _jax_toy(t, y, k):
    return jnp.stack([-k * y[0] + y[1], -0.1 * y[1] + 0.05 * jnp.sin(y[0])])


def _toy_runs(kw):
    cfg = bdf.SolverConfig(**kw)
    y0 = torch.tensor([1.0, 0.5], dtype=torch.float64)
    runs = {}
    for route in (True, False):
        it0 = bdf.newton_iters
        st = bdf.solve_to(_toy, bdf.bdf_init(0.0, y0, cfg), 1.0, 50.0, cfg,
                          linearize=_toy_lin, solver_kernel=route)
        runs[route] = (st, bdf.newton_iters - it0)
    assert torch.equal(y0, torch.tensor([1.0, 0.5], dtype=torch.float64))
    return runs


TOY = dict(rtol=1e-4, atol=1e-7, h_max=1e9, h_init=1e-4)


@pytest.mark.parametrize("max_order,history", ((2, True), (2, False),
                                               (3, False)))
def test_toy_route_matches_torch_pieces(max_order, history):
    """A stiff toy problem, f64: the kernel route (plain versions) bitwise
    the torch pieces, with equal steps, NFE and Newton iterations, and the
    caller's state left alone."""
    runs = _toy_runs(dict(TOY, max_order=max_order, history_predictor=history))
    (a, ia), (b, ib) = runs[True], runs[False]
    _equal(a, b, "toy")
    assert ia == ib > 0 and a.nsteps > 10


def test_toy_route_matches_jax():
    """The kernel route on the Hermite predictor (history off, order 2)
    within 1e-12 scaled of JAX's solve_to, with its steps and NFE."""
    from shud_tpu.solver import bdf as JB

    kw = dict(TOY, max_order=2, history_predictor=False)
    a = _toy_runs(kw)[True][0]
    cfg_j = JB.SolverConfig(**kw)
    st_j = JB.solve_to(_jax_toy, JB.bdf_init(0.0, jnp.asarray([1.0, 0.5]),
                                             cfg_j), 1.0, 50.0, cfg_j)
    assert (a.nsteps, a.nfe) == (int(st_j.nsteps), int(st_j.nfe))
    ref = np.asarray(st_j.y)
    assert np.abs(a.y.numpy() - ref).max() <= 1e-12 * np.abs(ref).max()


def _storm(pkg, nx, ny, variant="plain"):
    inp = make_project(pkg, variant, nx, ny, 1.0)
    inp.forc.t_min = [t - 720.0 for t in inp.forc.t_min]
    inp.control.day_start = 0.5
    return inp


def test_mega_storm_window_route_matches_torch_pieces():
    """A 12x8 storm window on the mega path's plain hook (float32): the
    kernel route bitwise the torch pieces, with equal steps, NFE and
    Newton iterations."""
    from shud_tpu_torch.driver.fused import FusedSimulation

    runs = {}
    for route in (True, False):
        sim = FusedSimulation.create(
            "synthetic", inp=_storm("torch", 12, 8), float_dtype=torch.float32,
            mega=True, device="cpu", solver_kernel=route)
        it0 = bdf.newton_iters
        sim.advance_interval(20.0)
        runs[route] = (sim.bdf, bdf.newton_iters - it0)
    (a, ia), (b, ib) = runs[True], runs[False]
    _equal(a, b, "mega storm window")
    assert ia == ib > 0 and a.nsteps > 2


def test_split_graph_pieces_route_matches_torch_pieces():
    """One -g window through ``SplitGraph``'s pieces run eagerly
    (``capture=False``), five scratches, bitwise the same program on the
    torch pieces: every sub-state, its scalars and the fetched values."""
    from shud_tpu_torch.driver import uncoupled as TU
    from shud_tpu_torch.driver.simulate import Simulation

    sims, out = {}, {}
    for route in (True, False):
        sim = Simulation.create("synthetic", inp=_storm("torch", 6, 4),
                                device="cpu")
        ne, nr, nl = sim.md.num_ele, sim.md.num_riv, sim.md.num_lake
        y0 = sim.bdf.y.clone()
        y0[:ne] = torch.as_tensor(
            np.random.default_rng(0).uniform(0.0, 1e-3, ne))
        st = TU.init_uncoupled(y0, ne, nr, sim.t, sim.cfg, nl=nl)
        g = TU.SplitGraph(sim.dm, sim.cfg, True, False, capture=False,
                          solver_kernel=route)
        fs, cf = sim.forcing_slice(sim.t + 10.0)
        out[route] = g.sweep(fs, cf, sim.buckets, st, sim.t - 10.0, sim.t)
        sims[route] = g
    (ua, ha), (ub, hb) = out[True], out[False]
    for part in TU.PARTS:
        a, b = getattr(ua, part), getattr(ub, part)
        assert (a is None) == (b is None)
        if a is not None:
            _equal(a, b, part)
    for key in ha:
        for k in ha[key] if isinstance(ha[key], dict) else [None]:
            x = ha[key] if k is None else ha[key][k]
            y = hb[key] if k is None else hb[key][k]
            assert np.array_equal(x, y), (key, k)
    assert ua.surf.nsteps > 1
    assert all(p.scratch is not None
               for p in sims[True].pieces.solvers.values())
    assert all(p.scratch is None for p in sims[False].pieces.solvers.values())


def test_fixed_bdf1_route_matches_torch_pieces():
    """The fixed-step truth's Newton updates (GMRES(5)) through the plain
    kernels bitwise its torch route."""
    from shud_tpu_torch.solver.fixed import fixed_bdf1

    y0 = torch.tensor([1.0, 0.5], dtype=torch.float64)
    a = fixed_bdf1(_toy, y0, 0.0, 50.0, 0.05, 40, linearize=_toy_lin)
    b = fixed_bdf1(_toy, y0, 0.0, 50.0, 0.05, 40, linearize=_toy_lin,
                   solver_kernel=False)
    assert a[0] == b[0] and torch.equal(a[1], b[1])
