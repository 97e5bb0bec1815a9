"""Adaptive implicit multistep solver (the CVODE replacement) on tensors.

The counterpart of ``shud_tpu/solver/bdf.py`` with ``solver/tree.py``
folded in: the state is one flat tensor (in a sharded run, each rank's
share of it, whose dot products and norms ``solve_to(..., group=)`` makes
global).  Same method, same
arithmetic, same NFE accounting:

* variable-step, variable-order BDF(1,2,3) with history carried across
  solver windows; ``SolverConfig.max_order`` picks the cap;
* modified Newton iterations with **exact** Jacobian-vector products,
  the RHS linearized once per iteration (``solve_to``'s ``linearize``
  hook; by default ``torch.func.jvp`` of the RHS);
* matrix-free GMRES(m) for the Newton linear systems (SPGMR equivalent);
* WRMS error control with weights 1/(rtol·|y| + atol), the standard step
  controller, min/max step bounds and exact stop-at-tout.

One step body on device scalars, JAX's ``step_body``: the controller's
scalars (t, h, the two previous steps, order and the counters) are 0-d
tensors on the state's device (``Carry``: the steps in the state's dtype,
the order and the counters int64), and every decision is a
``torch.where``.  The body comes in three pieces (``step_begin``, the
predictor, the BDF coefficients and the first Newton iteration;
``newton_iter``, each later one; ``step_end``, the error test and the
controller), so that ``solver/graph.py`` can capture each once and replay
a whole window, or an output interval of windows, from the card with no
host in the loop (the JAX solver's ``lax.while_loop``).  ``solve_to`` runs
them in a host loop that reads its two conditions (another Newton
iteration, another step) from the device: the CPU's route, and on the
card that of the drivers that do not capture (sharded) and of the eager
forms.  Each piece has two routes: with a ``kernels.Scratch`` (the
``solver_kernel`` route, the default without a *group*) it runs the four
kernels of ``solver/kernels.py`` between the library's dot products and
sums (on the CPU their plain versions), updating the scratch and the carry
in place; without, the torch expressions below (``solver_kernel=False``,
and the sharded driver, whose dot products are rank-ordered sums).  The
two are bitwise equal.  ``host_syncs`` counts its device reads,
``newton_iters`` the Newton iterations, read from the carry.  Within a
window the RHS is autonomous (the driver freezes the forcing slice, as
the reference refreshes forcing only between CVode calls,
``shud.cpp:91-155``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from shud_tpu_torch.solver import kernels
from shud_tpu_torch.solver.kernels import history as _history


class SolverConfig(NamedTuple):
    rtol: float = 1.0e-3
    atol: float = 1.0e-4
    h_init: float = 1.0e-2  # [min] CS.InitStep
    h_min: float = 1.0e-6  # [min] CVodeSetMinStep
    h_max: float = 30.0  # [min] CVodeSetMaxStep
    newton_iters: int = 3
    krylov_m: int = 3  # Krylov dimension (CVODE's SPGMR default is 5)
    newton_tol: float = 0.5  # nonlinear tolerance in WRMS units
    safety: float = 0.9
    eta_max: float = 6.0
    eta_min: float = 0.2
    max_steps: int = 100000  # per-window backstop
    max_order: int = 2  # BDF order cap (1..3)
    history_predictor: bool = True  # predict from state history alone
    # (variable-step Lagrange through y_prev2/y_prev/y — CVODE's Nordsieck
    # extrapolation); requires max_order <= 2, BDF3 keeps Hermite.


class BDFState(NamedTuple):
    """The solver's state between windows, with host scalars: what
    checkpoints, drivers and tests read (``solve_to`` makes a ``Carry`` of
    it on entry and back on exit)."""

    t: np.floating  # host scalar of the state's precision
    y: torch.Tensor
    y_prev: torch.Tensor  # state at t - h_prev
    h: np.floating  # next step size to attempt
    h_prev: np.floating  # last successful step size
    order: int  # current order (1..max_order)
    nfe: int
    nsteps: int
    nfails: int
    nnifails: int
    quad: dict = None  # optional flux-quadrature accumulators (0-d tensors)
    y_prev2: torch.Tensor = None  # state at t - h_prev - h_prev2
    h_prev2: np.floating = None


# device -> host reads made by the solver (each one waits for the device);
# a diagnostic for the cost of a host-driven loop
host_syncs = 0
# Newton iterations run by the solver, each of which linearizes the RHS
# once: added from the device carry at the end of each window
newton_iters = 0


def _read(x: torch.Tensor) -> bool:
    """A device bool on the host: one sync."""
    global host_syncs
    host_syncs += 1
    return bool(x)


def np_dtype(dtype: torch.dtype):
    """The numpy scalar type matching a floating torch dtype."""
    return {torch.float32: np.float32, torch.float64: np.float64}[dtype]


def bdf_init(t0, y0: torch.Tensor, cfg: SolverConfig, quad0=None) -> BDFState:
    dt = np_dtype(y0.dtype)
    return BDFState(
        t=dt(t0), y=y0, y_prev=y0, h=dt(cfg.h_init), h_prev=dt(cfg.h_init),
        order=1, nfe=0, nsteps=0, nfails=0, nnifails=0, quad=quad0,
        y_prev2=y0, h_prev2=dt(cfg.h_init),
    )


# a Gram-Schmidt remainder below this many eps of A·v is a breakdown
_BREAKDOWN = 16.0


def _dot(a, b, group=None):
    """a·b.  With a rank's *group* (``parallel.sharded.StateGroup``: the
    state is this rank's cell and reach blocks, then the replicated lakes)
    the blocks' partial sums are added over the ranks in rank order
    (``comm.psum``), and the lakes count once."""
    if group is None:
        return torch.dot(a, b)
    n = group.n_blocks
    return group.psum(torch.dot(a[:n], b[:n])) + torch.dot(a[n:], b[n:])


def _wrms(x, ewt, group=None):
    """Weighted RMS norm: sqrt(mean((x*ewt)^2)), a 0-d tensor.  With a
    *group* the sum is ``_dot``'s and the mean is over the global padded
    size (the JAX package's ``tsize`` of the sharded state)."""
    if group is None:
        return torch.sqrt(torch.sum((x * ewt) ** 2) / x.numel())
    xe = x * ewt
    return torch.sqrt(_dot(xe, xe, group) / group.size)


def _gmres(matvec, b, m, group=None):
    """Single-cycle matrix-free GMRES(m), modified Gram-Schmidt with
    incremental Givens rotations, x0 = 0.  The scalars stay 0-d tensors on
    the device (no host round trip inside the Krylov loop).

    Breakdown: when the Krylov space is invariant, what Gram-Schmidt leaves
    of A·v is round-off (relative 1e-16 in f64), and a direction built
    from it ruins the least-squares solve (the surface sub-system of the
    split driver on a uniformly dry surface under uniform rain returned
    dy = 0).  Such a remainder (below ``_BREAKDOWN`` eps of A·v) counts
    as zero, as an exactly cancelling one does, so the Krylov solve stops
    there; elsewhere the iteration is the JAX package's, bit for bit."""
    beta = torch.sqrt(_dot(b, b, group))
    safe = torch.where(beta > 0, beta, 1.0)
    vs = [b / safe]
    r_cols = []
    givens = []
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    g = [beta] + [zero] * m
    tol = _BREAKDOWN * torch.finfo(b.dtype).eps
    for j in range(m):
        w = matvec(vs[j])
        w0 = torch.sqrt(_dot(w, w, group))
        hcol = []
        for i in range(j + 1):
            hij = _dot(vs[i], w, group)
            hcol.append(hij)
            w = -hij * vs[i] + w
        wnorm = torch.sqrt(_dot(w, w, group))
        wnorm = torch.where(wnorm > tol * w0, wnorm, 0.0)
        wsafe = torch.where(wnorm > 0, wnorm, 1.0)
        vs.append(w / wsafe)
        # apply previous rotations to this column (i < j, acts on i, i+1)
        for i, (c, s) in enumerate(givens):
            tmp = c * hcol[i] + s * hcol[i + 1]
            hcol[i + 1] = -s * hcol[i] + c * hcol[i + 1]
            hcol[i] = tmp
        # new rotation eliminating wnorm
        denom = torch.sqrt(hcol[j] ** 2 + wnorm**2)
        dsafe = torch.where(denom > 0, denom, 1.0)
        c = torch.where(denom > 0, hcol[j] / dsafe, 1.0)
        s = torch.where(denom > 0, wnorm / dsafe, 0.0)
        givens.append((c, s))
        hcol[j] = c * hcol[j] + s * wnorm
        g[j + 1] = -s * g[j]
        g[j] = c * g[j]
        r_cols.append(hcol)
    # back-substitution R y = g[:m]
    ys = [zero] * m
    for j in range(m - 1, -1, -1):
        acc = g[j]
        for k in range(j + 1, m):
            acc = acc - r_cols[k][j] * ys[k]
        rjj = r_cols[j][j]
        nz = torch.abs(rjj) > 0
        ys[j] = torch.where(nz, acc / torch.where(nz, rjj, 1.0), 0.0)
    x = vs[0] * ys[0]
    for j in range(1, m):
        x = ys[j] * vs[j] + x
    return torch.where(beta > 0, x, 0.0)




# ---------------------------------------------------------------------------
# the step body on device scalars (shud_tpu/solver/bdf.py:234-389)
# ---------------------------------------------------------------------------


class Carry(NamedTuple):
    """JAX's ``BDFState`` inside a window: every field a tensor on the
    state's device, the scalars 0-d (the step sizes in the state's dtype;
    the order and the counters int64, so that no count stops at a float's
    24 bits), ``nni`` the Newton iterations since the carry was made, the
    quadrature a dict of 0-d tensors (empty without one)."""

    t: torch.Tensor
    h: torch.Tensor
    h_prev: torch.Tensor
    h_prev2: torch.Tensor
    order: torch.Tensor
    nfe: torch.Tensor
    nsteps: torch.Tensor
    nfails: torch.Tensor
    nnifails: torch.Tensor
    nni: torch.Tensor
    y: torch.Tensor
    y_prev: torch.Tensor
    y_prev2: torch.Tensor
    quad: dict


STEPS = ("t", "h", "h_prev", "h_prev2")
COUNTS = ("order", "nfe", "nsteps", "nfails", "nnifails", "nni")


def to_carry(state: BDFState) -> Carry:
    """The device carry of *state* (its tensors shared, not copied)."""
    y = state.y

    def full(v, dtype):
        return torch.full((), v, dtype=dtype, device=y.device)

    return Carry(
        **{k: full(float(getattr(state, k)), y.dtype) for k in STEPS},
        **{k: full(int(getattr(state, k)), torch.int64) for k in COUNTS[:-1]},
        nni=full(0, torch.int64), y=y, y_prev=state.y_prev,
        y_prev2=state.y_prev2,
        quad=dict(state.quad) if state.quad is not None else {})


def scalars(c: Carry) -> torch.Tensor:
    """The carry's scalars as one float64 vector (exact for both the
    steps and the counts), in the order STEPS + COUNTS."""
    return torch.stack([getattr(c, k).double() for k in STEPS + COUNTS])


def from_carry(c: Carry, host: np.ndarray, has_quad: bool) -> BDFState:
    """The ``BDFState`` of a carry whose ``scalars`` are *host*."""
    dt = np_dtype(c.y.dtype)
    v = dict(zip(STEPS + COUNTS, host))
    return BDFState(
        t=dt(v["t"]), y=c.y, y_prev=c.y_prev, h=dt(v["h"]),
        h_prev=dt(v["h_prev"]), order=int(v["order"]), nfe=int(v["nfe"]),
        nsteps=int(v["nsteps"]), nfails=int(v["nfails"]),
        nnifails=int(v["nnifails"]),
        quad=dict(c.quad) if has_quad else None, y_prev2=c.y_prev2,
        h_prev2=dt(v["h_prev2"]))


def finish(c: Carry, has_quad: bool) -> BDFState:
    """Back to host scalars with one transfer; the Newton iterations of the
    carry are added to ``newton_iters``."""
    global host_syncs, newton_iters
    host = scalars(c).cpu().numpy()
    host_syncs += 1
    newton_iters += int(host[-1])
    return from_carry(c, host, has_quad)


class StepPlan(NamedTuple):
    """What a step's Newton iterations and its end read."""

    h: torch.Tensor  # the step size taken
    ewt: torch.Tensor  # WRMS weights at the step's start
    y_pred: torch.Tensor
    c0: torch.Tensor  # y = c0 + bh·f(t_new, y)
    bh: torch.Tensor
    t_new: torch.Tensor


class NewtonIter(NamedTuple):
    """A Newton iterate: y, the WRMS norm of its update, the iterations so
    far (int64) and whether another is due (``dnorm > newton_tol``)."""

    y: torch.Tensor
    dnorm: torch.Tensor
    it: torch.Tensor
    more: torch.Tensor


def functions(f, params, linearize=None):
    """``(rhs(t, y), lin(t, y))`` of ``solve_to``'s *f* and hook."""

    def rhs(t, y):
        return f(t, y, params)

    if linearize is None:
        def lin(t, y):
            return rhs(t, y), lambda v: torch.func.jvp(
                lambda yy: rhs(t, yy), (y,), (v,))[1]
    else:
        def lin(t, y):
            return linearize(t, y, params)
    return rhs, lin


def active(c: Carry, tout, nsteps0, cfg: SolverConfig) -> torch.Tensor:
    """JAX's ``step_cond``: t short of *tout* and fewer than ``max_steps``
    steps since *nsteps0* (the per-window backstop)."""
    return (c.t < tout - 1e-9) & (c.nsteps - nsteps0 < cfg.max_steps)


def step_begin(rhs, lin, c: Carry, tout, cfg: SolverConfig, group=None,
               scratch=None):
    """A step up to its first Newton iteration: the step size, the
    predictor, the BDF coefficients and one iteration.  Returns
    ``(StepPlan, NewtonIter)``; with a *scratch* (the kernel route) both
    are views of it."""
    fy0 = None if _history(cfg) else rhs(c.t, c.y)  # Hermite predictors
    if scratch is not None:
        kernels.bdf_begin(scratch, c, tout, cfg, fy0)
        plan = StepPlan(scratch.h, scratch.ewt, scratch.y_pred, scratch.c0,
                        scratch.bh, scratch.t_new)
        return plan, newton_iter(lin, plan, plan.y_pred, scratch.it, cfg,
                                 scratch=scratch)
    h, ewt, y_pred, c0, bh = kernels.predict(c, tout, cfg, fy0)
    plan = StepPlan(h, ewt, y_pred, c0, bh, c.t + h)
    it0 = torch.zeros((), dtype=torch.int64, device=c.y.device)
    return plan, newton_iter(lin, plan, y_pred, it0, cfg, group)


def newton_iter(lin, plan: StepPlan, y, it, cfg: SolverConfig,
                group=None, scratch=None) -> NewtonIter:
    """One Newton-GMRES iteration on y = c0 + bh·f(t_new, y), f linearized
    once at *y* (``lin(t, y) -> (f(t, y), v -> J·v)``).  With a *scratch*
    the kernel route, which leaves the iterate in the scratch (*it* is its
    own)."""
    fy, jvp = lin(plan.t_new, y)
    if scratch is not None:
        s = scratch
        kernels.newton_update(s, jvp, y, fy, plan.c0, plan.bh, s.y)
        kernels.bdf_finish(s, kernels.NEWTON, cfg, torch.sum(s.sq[0]))
        return NewtonIter(s.y, s.dnorm, s.it, s.more)
    # residual: y - bh*f(y) - c0
    res = y - plan.bh * fy - plan.c0

    def matvec(v):
        return v - plan.bh * jvp(v)

    dy = _gmres(matvec, -res, cfg.krylov_m, group)
    dnorm = _wrms(dy, plan.ewt, group)
    return NewtonIter(y + dy, dnorm, it + 1, dnorm > cfg.newton_tol)


def step_end(c: Carry, plan: StepPlan, nw: NewtonIter, cfg: SolverConfig,
             quad_fn=None, params=None, group=None, scratch=None,
             tout=None, nsteps0=None, go=None) -> Carry:
    """The error test and the step controller: the carry after the step,
    every decision a select.  With a *scratch* (the kernel route) the
    carry's tensors are updated in place, and with *go* (a 0-d bool) the
    step loop's condition ``active(c, tout, nsteps0, cfg)`` after the
    step is written there too."""
    h = plan.h
    quad = c.quad
    rates = None
    if quad_fn is not None:
        # midpoint rule: one rate evaluation a step, added when accepted
        y_mid = 0.5 * (c.y + nw.y)
        rates = quad_fn(c.t + 0.5 * h, y_mid, params)
    if scratch is not None:
        kernels.bdf_finish(scratch, kernels.STEP, cfg,
                           torch.sum(scratch.sq[1]), c, tout, nsteps0, go)
        if rates is not None:
            quad = {k: q + torch.where(scratch.accept, h * rates[k], 0.0)
                    for k, q in c.quad.items()}
        return c._replace(quad=quad)
    conv = nw.dnorm <= cfg.newton_tol
    # predictor-corrector difference estimates the LTE at this order
    err = _wrms(nw.y - plan.y_pred, plan.ewt, group) * 0.5
    accept, h_next, new_order = kernels.control(c.order, h, conv, err, cfg)
    if rates is not None:
        quad = {k: q + torch.where(accept, h * rates[k], 0.0)
                for k, q in c.quad.items()}

    nfe_n = nw.it * (1 + cfg.krylov_m) + (0 if _history(cfg) else 1)
    return Carry(
        t=torch.where(accept, plan.t_new, c.t), h=h_next,
        h_prev=torch.where(accept, h, c.h_prev),
        h_prev2=torch.where(accept, c.h_prev, c.h_prev2),
        order=new_order, nfe=c.nfe + nfe_n, nsteps=c.nsteps + 1,
        nfails=c.nfails + (conv & ~accept), nnifails=c.nnifails + ~conv,
        nni=c.nni + nw.it,
        y=torch.where(accept, nw.y, c.y),
        y_prev=torch.where(accept, c.y, c.y_prev),
        y_prev2=torch.where(accept, c.y_prev, c.y_prev2), quad=quad)


def _step(rhs, lin, c: Carry, tout, nsteps0, params, cfg, quad_fn, group,
          scratch, go) -> Carry:
    """One step, its Newton loop on the host: JAX's one unconditional
    iteration, then more while ``dnorm > newton_tol`` (read from the
    device), up to ``newton_iters``."""
    plan, nw = step_begin(rhs, lin, c, tout, cfg, group, scratch)
    for _ in range(1, cfg.newton_iters):
        if not _read(nw.more):
            break
        nw = newton_iter(lin, plan, nw.y, nw.it, cfg, group, scratch)
    return step_end(c, plan, nw, cfg, quad_fn, params, group, scratch, tout,
                    nsteps0, go)


def solve_to(f, state: BDFState, tout, params, cfg: SolverConfig,
             quad_fn=None, linearize=None, group=None,
             solver_kernel: bool = True) -> BDFState:
    """Advance the ODE to ``tout`` — one ``CVode(CV_NORMAL)`` equivalent.
    ``f(t, y, params)`` returns dy/dt.

    ``quad_fn(t, y, params) -> dict of 0-d rates``: optional flux
    quadrature accumulated as ``quad += h * quad_fn(t_mid, y_mid)`` on each
    accepted step (the reference's ``SHUD_WB_DIAG_QUAD``).

    ``linearize(t, y, params) -> (f(t, y, params), v -> J(y)·v)``: what
    each Newton iteration calls once, as the JAX solver calls
    ``jax.linearize``.  By default f once and ``torch.func.jvp`` of f for
    each vector (which runs f's primal again); a hook with a hand tangent
    (``core/mega.linearize_mega``) runs the primal once an iteration.

    *group*: a rank's share of a sharded state (``parallel.sharded``); the
    dot products and norms are then global (``_dot``), so every rank takes
    the same steps, Newton iterations and NFE.

    *solver_kernel* (without a *group*): the step body through the kernels
    of ``solver/kernels.py`` (their plain versions on the CPU), on a
    scratch made for this call and a copy of the state; False, the torch
    pieces.  The two are bitwise equal.

    The step loop and the Newton loop run on the host, each condition read
    from the device (``_read``); ``solver/graph.WindowGraph`` replays the
    same body from a captured CUDA graph instead."""
    rhs, lin = functions(f, params, linearize)
    c = to_carry(state)
    tout = torch.full((), float(tout), dtype=c.t.dtype, device=c.t.device)
    nsteps0 = c.nsteps.clone()
    go = active(c, tout, nsteps0, cfg)
    scratch = None
    if solver_kernel and group is None:
        # the kernels update the carry in place: its own copies of the
        # state (which may be one tensor three times)
        scratch = kernels.Scratch(c.y, cfg.krylov_m)
        c = c._replace(y=c.y.clone(), y_prev=c.y_prev.clone(),
                       y_prev2=c.y_prev2.clone())
    while _read(go):
        c = _step(rhs, lin, c, tout, nsteps0, params, cfg, quad_fn, group,
                  scratch, go if scratch is not None else None)
        if scratch is None:
            go = active(c, tout, nsteps0, cfg)
    return finish(c, state.quad is not None)
