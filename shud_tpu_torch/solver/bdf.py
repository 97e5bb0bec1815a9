"""Adaptive implicit multistep solver (the CVODE replacement) on tensors.

The counterpart of ``shud_tpu/solver/bdf.py`` with ``solver/tree.py``
folded in (one chip: the state is one flat tensor).  Same method, same
arithmetic, same NFE accounting:

* variable-step, variable-order BDF(1,2,3) with history carried across
  solver windows; ``SolverConfig.max_order`` picks the cap;
* modified Newton iterations with **exact** Jacobian-vector products,
  the RHS linearized once per iteration (``solve_to``'s ``linearize``
  hook; by default ``torch.func.jvp`` of the RHS);
* matrix-free GMRES(m) for the Newton linear systems (SPGMR equivalent);
* WRMS error control with weights 1/(rtol·|y| + atol), the standard step
  controller, min/max step bounds and exact stop-at-tout.

JAX runs a whole window inside one ``lax.while_loop`` on the device.  Here
the loop runs on the host: the step controller's scalars (t, h, order,
counters) are host numbers of the state's precision (numpy float32 or
float64, so the controller rounds as the JAX one does), and each Newton
iteration and each step fetch one scalar from the device
(``host_syncs`` counts them).  Within a window the RHS is autonomous (the
driver freezes the forcing slice, as the reference refreshes forcing only
between CVode calls, ``shud.cpp:91-155``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


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


# device -> host scalar fetches made by the solver (each one waits for the
# device); a diagnostic for the cost of the host-driven loop
host_syncs = 0
# Newton iterations run by the solver, each of which linearizes the RHS once
newton_iters = 0


def _fetch(x: torch.Tensor, dt):
    global host_syncs
    host_syncs += 1
    return dt(x.item())


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


def _dot(a, b):
    return torch.dot(a, b)


def _wrms(x, ewt):
    """Weighted RMS norm: sqrt(mean((x*ewt)^2)), a 0-d tensor."""
    return torch.sqrt(torch.sum((x * ewt) ** 2) / x.numel())


def _gmres(matvec, b, m):
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
    beta = torch.sqrt(_dot(b, b))
    safe = torch.where(beta > 0, beta, 1.0)
    vs = [b / safe]
    r_cols = []
    givens = []
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    g = [beta] + [zero] * m
    tol = _BREAKDOWN * torch.finfo(b.dtype).eps
    for j in range(m):
        w = matvec(vs[j])
        w0 = torch.sqrt(_dot(w, w))
        hcol = []
        for i in range(j + 1):
            hij = _dot(vs[i], w)
            hcol.append(hij)
            w = -hij * vs[i] + w
        wnorm = torch.sqrt(_dot(w, w))
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


def _newton(linearize, t_new, y_guess, c0, bh, ewt, cfg: SolverConfig):
    """Solve y = c0 + bh·f(t_new, y) by Newton-GMRES with exact JVPs:
    each iteration linearizes f once at its iterate (``linearize(t, y) ->
    (f(t, y), v -> J·v)``).  Returns (y, converged, nfe_used)."""
    global newton_iters
    dt = np_dtype(y_guess.dtype)
    bh_f = float(bh)
    y = y_guess
    it = 0
    nfe = 0
    while True:
        y_lin = y
        fy, jvp = linearize(t_new, y_lin)
        # residual: y - bh*f(y) - c0
        res = y_lin - bh_f * fy - c0

        def matvec(v, jvp=jvp):
            return v - bh_f * jvp(v)

        dy = _gmres(matvec, -res, cfg.krylov_m)
        dnorm = _fetch(_wrms(dy, ewt), dt)
        y = y_lin + dy
        it += 1
        newton_iters += 1
        nfe += 1 + cfg.krylov_m
        if not (it < cfg.newton_iters and dnorm > cfg.newton_tol):
            break
    return y, bool(dnorm <= cfg.newton_tol), nfe


def solve_to(f, state: BDFState, tout, params, cfg: SolverConfig,
             quad_fn=None, linearize=None) -> BDFState:
    """Advance the ODE to ``tout`` — one ``CVode(CV_NORMAL)`` equivalent.
    ``f(t, y, params)`` returns dy/dt.

    ``quad_fn(t, y, params) -> dict of 0-d rates``: optional flux
    quadrature accumulated as ``quad += h * quad_fn(t_mid, y_mid)`` on each
    accepted step (the reference's ``SHUD_WB_DIAG_QUAD``).

    ``linearize(t, y, params) -> (f(t, y, params), v -> J(y)·v)``: what
    each Newton iteration calls once, as the JAX solver calls
    ``jax.linearize``.  By default f once and ``torch.func.jvp`` of f for
    each vector (which runs f's primal again); a hook with a hand tangent
    (``core/mega.linearize_mega``) runs the primal once an iteration."""
    dt = np_dtype(state.y.dtype)
    tout = dt(tout)

    def rhs(t, y):
        return f(t, y, params)

    if linearize is None:
        def lin(t, y):
            return rhs(t, y), lambda v: torch.func.jvp(
                lambda yy: rhs(t, yy), (y,), (v,))[1]
    else:
        def lin(t, y):
            return linearize(t, y, params)

    nsteps0 = state.nsteps
    s = state
    while s.t < tout - 1e-9 and s.nsteps - nsteps0 < cfg.max_steps:
        s = _step(rhs, lin, s, tout, params, cfg, quad_fn, dt)
    return s


def _step(rhs, lin, s: BDFState, tout, params, cfg, quad_fn, dt):
    ewt = 1.0 / (cfg.rtol * torch.abs(s.y) + cfg.atol)
    h = np.minimum(np.minimum(s.h, dt(cfg.h_max)), tout - s.t)
    h = np.maximum(h, dt(cfg.h_min))
    tau = s.h_prev
    tau2 = s.h_prev2
    use2 = s.order >= 2
    use3 = s.order >= 3
    use_hist = cfg.history_predictor and cfg.max_order < 3

    fy0 = None
    if use_hist:
        # state-history predictors (no RHS evaluation):
        #  order 1: constant; order 2: quadratic Lagrange through
        #  (t-tau-tau2, y_prev2), (t-tau, y_prev), (t, y) extrapolated to t+h
        if use2:
            e0h = float(h + tau + tau2)
            e1h = float(h + tau)
            d01 = (s.y_prev - s.y_prev2) / float(tau2)
            d12 = (s.y - s.y_prev) / float(tau)
            d2 = (d12 - d01) / float(tau + tau2)
            y_pred = s.y_prev2 + d01 * e0h + d2 * e0h * e1h
        else:
            y_pred = s.y
    else:
        fy0 = rhs(s.t, s.y)  # slope at the current point (predictors)
        # order 1: forward Euler; order 2: quadratic Hermite through
        # (y_prev, y, fy0); order 3: cubic Hermite (below)
        hf, tauf = float(h), float(tau)
        if use2:
            a_coef = (s.y_prev - s.y + fy0 * tauf) / float(tau * tau)
            y_pred = s.y + fy0 * hf + a_coef * hf * hf
        else:
            y_pred = hf * fy0 + s.y
    if cfg.max_order >= 3 and use3:
        # Hermite divided differences, nodes [t-tau-tau2, t-tau, t, t]
        w01 = float(dt(1.0) / tau2)
        w12 = float(dt(1.0) / tau)
        w02 = float(dt(1.0) / (tau + tau2))
        e0 = float(h + tau + tau2)
        e1 = float(h + tau)
        d01 = (s.y_prev - s.y_prev2) * w01
        d12 = (s.y - s.y_prev) * w12
        d2_012 = (d12 - d01) * w02
        d2_122 = (fy0 - d12) * w12
        d3 = (d2_122 - d2_012) * w02
        y_pred = (s.y_prev2 + d01 * e0 + d2_012 * e0 * e1
                  + d3 * e0 * e1 * float(h))

    # variable-step BDF coefficients
    r = h / tau
    a1_2 = (1 + r) ** 2 / (1 + 2 * r)
    a2_2 = -(r**2) / (1 + 2 * r)
    b_2 = (1 + r) / (1 + 2 * r)
    if use2:
        c0 = float(a1_2) * s.y + float(a2_2) * s.y_prev
        bh = b_2 * h
    else:
        c0 = s.y
        bh = dt(1.0) * h
    if cfg.max_order >= 3 and use3:
        # variable-step BDF3 via the Lagrange-derivative form
        s1 = h + tau
        s2 = h + tau + tau2
        g0 = dt(1.0) / h + dt(1.0) / s1 + dt(1.0) / s2
        g1 = -(s1 * s2) / (h * tau * (tau + tau2))
        g2 = (h * s2) / (s1 * tau * tau2)
        g3 = -(h * s1) / (s2 * (tau + tau2) * tau2)
        c0 = (-((float(g1) * s.y + float(g2) * s.y_prev)
                + float(g3) * s.y_prev2)) / float(g0)
        bh = dt(1.0) / g0

    t_new = s.t + h
    y_new, conv, nfe_n = _newton(lin, t_new, y_pred, c0, bh, ewt, cfg)

    # predictor-corrector difference estimates the LTE at this order
    err = _fetch(_wrms(y_new - y_pred, ewt) * 0.5, dt)
    accept = conv and err <= 1.0
    at_hmin = h <= cfg.h_min * (1 + 1e-9)
    accept = accept or (at_hmin and conv)

    order_p1 = dt(s.order + 1)
    eta_raw = dt(cfg.safety) * (dt(1.0) / np.maximum(err, dt(1e-10))) ** (
        dt(1.0) / order_p1)
    h_acc = h * np.clip(eta_raw, dt(cfg.eta_min), dt(cfg.eta_max))
    h_rej = (h * np.clip(eta_raw, dt(0.1), dt(0.5))) if conv else h * dt(0.25)
    h_next = h_acc if accept else np.maximum(h_rej, dt(cfg.h_min))

    if accept:
        new_order = min(s.order + 1, cfg.max_order)
    else:
        new_order = s.order if conv else 1

    new_quad = s.quad
    if quad_fn is not None and accept:
        # midpoint rule: one rate evaluation per accepted step
        y_mid = 0.5 * (s.y + y_new)
        rates = quad_fn(s.t + dt(0.5) * h, y_mid, params)
        hf = float(h)
        new_quad = {k: s.quad[k] + hf * rates[k] for k in s.quad}

    return BDFState(
        t=t_new if accept else s.t,
        y=y_new if accept else s.y,
        y_prev=s.y if accept else s.y_prev,
        h=dt(h_next),
        h_prev=h if accept else s.h_prev,
        order=new_order,
        nfe=s.nfe + nfe_n + (0 if use_hist else 1),
        nsteps=s.nsteps + 1,
        nfails=s.nfails + int(conv and not accept),
        nnifails=s.nnifails + int(not conv),
        quad=new_quad,
        y_prev2=s.y_prev if accept else s.y_prev2,
        h_prev2=s.h_prev if accept else s.h_prev2,
    )

