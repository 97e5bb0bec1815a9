"""A plain adaptive BDF solver for the reference, in float64.

Variable-step BDF of order 1 and 2 with a state-history predictor, the
local error estimated from the predictor-corrector difference, and each
implicit step solved by Newton's method with a matrix-free GMRES whose
Jacobian-vector products are finite differences of the right-hand side.
The step sizes and every decision live on the host: the reference is
clear before it is fast.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass
class BDF:
    """The solver's state between calls of ``advance``."""

    t: float
    y: torch.Tensor
    rtol: float
    atol: float
    h: float  # next step size to try [min]
    h_max: float
    h_min: float = 1e-6
    newton_iters: int = 3
    newton_tol: float = 0.5  # on the update's WRMS norm
    krylov_m: int = 3
    order: int = 1
    y_prev: torch.Tensor = None  # state at t - tau
    y_prev2: torch.Tensor = None  # state at t - tau - tau2
    tau: float = 0.0
    tau2: float = 0.0
    nfe: int = 0
    nsteps: int = 0

    def wrms(self, x: torch.Tensor, ewt: torch.Tensor) -> float:
        return float(torch.sqrt(torch.mean((x * ewt) ** 2)))

    def advance(self, f, tout: float) -> None:
        """Step ``y' = f(t, y)`` up to *tout*."""
        while self.t < tout - 1e-9:
            self._step(f, tout)

    def _step(self, f, tout: float) -> None:
        while True:
            h = max(min(self.h, self.h_max, tout - self.t), self.h_min)
            ewt = 1.0 / (self.rtol * torch.abs(self.y) + self.atol)
            two = self.order == 2
            if two:
                # quadratic through (t-tau-tau2, y_prev2), (t-tau, y_prev),
                # (t, y), extrapolated to t+h
                d01 = (self.y_prev - self.y_prev2) / self.tau2
                d12 = (self.y - self.y_prev) / self.tau
                d2 = (d12 - d01) / (self.tau + self.tau2)
                e0, e1 = h + self.tau + self.tau2, h + self.tau
                y_pred = self.y_prev2 + d01 * e0 + d2 * e0 * e1
                r = h / self.tau
                c0 = (((1 + r) ** 2 * self.y - r * r * self.y_prev)
                      / (1 + 2 * r))
                bh = h * (1 + r) / (1 + 2 * r)
            else:
                y_pred = self.y
                c0, bh = self.y, h
            t_new = self.t + h
            y, conv = self._newton(f, t_new, y_pred, c0, bh, ewt)
            err = 0.5 * self.wrms(y - y_pred, ewt) if conv else math.inf
            self.nsteps += 1
            if conv and (err <= 1.0 or h <= self.h_min * (1 + 1e-9)):
                eta = 0.9 * max(err, 1e-10) ** (-1.0 / (self.order + 1))
                self.y_prev2, self.y_prev, self.y = self.y_prev, self.y, y
                self.tau2, self.tau = self.tau, h
                self.t = t_new
                self.h = h * min(max(eta, 0.2), 6.0)
                self.order = 2 if self.y_prev2 is not None else 1
                return
            if conv:
                eta = 0.9 * err ** (-1.0 / (self.order + 1))
                self.h = max(h * min(max(eta, 0.1), 0.5), self.h_min)
            else:
                self.h = max(h * 0.25, self.h_min)
                self.order = 1
            if h <= self.h_min * (1 + 1e-9) and not conv:
                raise RuntimeError(f"the reference's Newton iteration "
                                   f"failed at the smallest step, t={self.t}")

    def _newton(self, f, t, y, c0, bh, ewt):
        """Solve ``y = c0 + bh f(t, y)`` from *y*: (y, converged)."""
        for _ in range(self.newton_iters):
            fy = f(t, y)
            self.nfe += 1
            res = y - bh * fy - c0

            def matvec(v):
                nv = self.wrms(v, ewt)
                if nv == 0.0:
                    return v
                sig = 1e-3 / nv
                self.nfe += 1
                return v - bh * (f(t, y + sig * v) - fy) / sig

            dy = gmres(matvec, -res, self.krylov_m)
            y = y + dy
            if self.wrms(dy, ewt) <= self.newton_tol:
                return y, True
        return y, False


def gmres(matvec, b: torch.Tensor, m: int) -> torch.Tensor:
    """One cycle of GMRES(m) from x0 = 0: modified Gram-Schmidt on the
    device, the small least-squares problem by Givens rotations on the
    host in Python floats (no LAPACK call, whose rounding may vary with
    the buffers' alignment)."""
    beta = float(torch.linalg.vector_norm(b))
    if beta == 0.0:
        return torch.zeros_like(b)
    vs = [b / beta]
    cols, rot = [], []
    g = [beta]
    for j in range(m):
        w = matvec(vs[j])
        h = []
        for i in range(j + 1):
            hij = torch.dot(vs[i], w)
            h.append(float(hij))
            w = w - hij * vs[i]
        wn = float(torch.linalg.vector_norm(w))
        for i, (c, s) in enumerate(rot):
            h[i], h[i + 1] = c * h[i] + s * h[i + 1], -s * h[i] + c * h[i + 1]
        d = math.hypot(h[j], wn)
        c, s = (h[j] / d, wn / d) if d > 0 else (1.0, 0.0)
        rot.append((c, s))
        h[j] = c * h[j] + s * wn
        g.append(-s * g[j])
        g[j] = c * g[j]
        cols.append(h)
        if wn <= 1e-14 * beta:
            break
        vs.append(w / wn)
    k = len(cols)
    ys = [0.0] * k
    for j in range(k - 1, -1, -1):
        acc = g[j] - sum(cols[i][j] * ys[i] for i in range(j + 1, k))
        ys[j] = acc / cols[j][j] if cols[j][j] != 0.0 else 0.0
    x = vs[0] * ys[0]
    for j in range(1, k):
        x = x + ys[j] * vs[j]
    return x
