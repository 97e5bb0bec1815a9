"""Fixed-step implicit BDF1 integrator (verification mode).

The counterpart of ``shud_tpu/solver/fixed.py``.  The production path is
the adaptive solver in ``bdf.py``; this fixed-step variant manufactures
*truth* trajectories: with h small the Newton iteration contracts strongly
even at the physics' switching surfaces, where tight-tolerance adaptive
control is infeasible in any integrator.  The adaptive paths (f64 and the
f32 kernel paths) are held against it.

Newton runs a fixed number of iterations (no early exit), each with exact
J·v and GMRES(5), so the trajectory does not depend on a convergence
test, and no step reads the device: the loop runs ``n_steps`` steps
without a host sync.
"""

from __future__ import annotations

import torch

from shud_tpu_torch.solver import kernels
from shud_tpu_torch.solver.bdf import _gmres, np_dtype

KRYLOV_M = 5


def fixed_bdf1(f, y0: torch.Tensor, t0, params, h: float, n_steps: int,
               newton_iters: int = 3, linearize=None,
               solver_kernel: bool = True):
    """Integrate *n_steps* of backward Euler with step *h* from (t0, y0).

    ``f(t, y, params)`` returns dy/dt.  ``linearize(t, y, params) ->
    (f(t, y, params), v -> J(y)·v)`` is ``solve_to``'s hook
    (``rhs.linearize``, ``mega.linearize_mega``); without it each Newton
    iteration evaluates f once and takes ``torch.func.jvp`` of f for each
    Krylov vector.  *solver_kernel*: each Newton update through the
    solver kernels (``kernels.newton_update``; their plain versions on the
    CPU), bitwise the torch route's (False).  Returns (t_end, y_end),
    t_end a host scalar of the state's precision."""
    dt = np_dtype(y0.dtype)

    if linearize is None:
        def lin(t, y):
            return f(t, y, params), lambda v: torch.func.jvp(
                lambda yy: f(t, yy, params), (y,), (v,))[1]
    else:
        def lin(t, y):
            return linearize(t, y, params)

    s = kernels.Scratch(y0, KRYLOV_M) if solver_kernel else None
    # h on the device in the state's dtype: a product with it rounds as
    # the product with the host scalar does
    k = torch.full((), h, dtype=y0.dtype, device=y0.device)
    t = dt(t0)
    y = y0
    for _ in range(n_steps):
        t_new = t + dt(h)
        yk = h * f(t_new, y, params) + y
        for _ in range(newton_iters):
            fy, jvp = lin(t_new, yk)
            if s is not None:
                y_next = torch.empty_like(yk)
                kernels.newton_update(s, jvp, yk, fy, y, k, y_next,
                                      norms=False)
                yk = y_next
                continue
            res = yk - h * fy - y

            def matvec(v, jvp=jvp):
                return v - h * jvp(v)

            yk = yk + _gmres(matvec, -res, KRYLOV_M)
        t, y = t_new, yk
    return t, y
