"""The solver's step and Newton–Krylov body as four CUDA kernels
(``csrc/bdf.cu``), with their plain PyTorch versions.

JAX runs the adaptive solver's body (``shud_tpu/solver/bdf.py:237-389``
``step_body``, ``:168-203`` ``_newton``, ``:112-165`` ``_gmres``) inside
``lax.while_loop``, where XLA fuses the work between the dot products into
a few kernels.  Here the body is split at its reductions: every dot
product and WRMS sum stays the library call it is in ``solver/bdf.py``
(``torch.dot``, ``torch.sum``), and everything between two of them is one
kernel that redoes the torch expression op by op, in the same order and
with the same roundings (``csrc/bdf.cu`` lists the traps):

* ``bdf_begin`` (S1): the step size, the WRMS weights, the predictor and
  the BDF coefficients; every branch (history predictor on and off, orders
  1-3);
* ``krylov_axpy`` (S2): the residual ``-(y - bh·f - c0)``, the matvec's
  ``v - bh·J·v`` and a Gram-Schmidt update ``-h_ij·v_i + w``;
* ``krylov_column`` (S3): ``v0 = b / beta``, ``v_{j+1} = w / |w|`` with
  the breakdown test, and after the last column the Givens rotations, the
  back-substitution, ``x = sum ys_j·v_j``, ``y + dy`` and the terms of the
  Newton and error norms;
* ``bdf_finish`` (S4): the Newton tail (``dnorm``, ``it + 1``, another
  iteration?) and the step end (error test, controller, counters, the
  selects of y, y_prev and y_prev2, and the step loop's ``active``).

S2 and S3 take 16 bytes of entries a thread (4 in float32, 2 in
float64), or one entry a thread where an address is not 16-byte aligned
or the state is shorter (``vec_width``); ``form_counts`` counts each
launch's form.

Kept as library calls, the reductions sum in cuBLAS's and PyTorch's own
order, so a trajectory on the kernels stays bitwise the torch pieces'
(``solver_kernel=False``), as the float32 gates at the storm's
infiltration switch need.  A ``dot`` result stays the fresh 0-d tensor
``torch.dot`` returns and its address goes to the next kernel:
``torch.dot(..., out=)`` would add a device copy per product.

Each wrapper runs its plain version when its tensors lie on the CPU and
launches its kernel on CUDA tensors (a failed build or launch raises;
nothing falls back), on torch's current stream; the kernels allocate
nothing.  A solver's buffers are one ``Scratch``, made once by its owner
(``solver/graph.SolverPieces``, or ``bdf.solve_to`` for an eager solve),
so a captured graph keeps their addresses.  The plain versions (``*_plain``)
are the same four functions in torch, split at the same reductions: what
the CPU runs, and what each kernel is held against on the card.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from shud_tpu_torch.core.cuda_build import load_library
from shud_tpu_torch.core.edge import on_cpu
from shud_tpu_torch.core.launches import LaunchCounts

_counts = LaunchCounts(("bdf_begin", "krylov_axpy", "krylov_column",
                        "bdf_finish"))
# launches of each kernel by its wrapper since the last reset; the kernels'
# own device counts (device_launch_counts()) also count a captured launch's
# replays
launch_counts = _counts.host
device_launch_counts = _counts.device
# the form each launch of S2 and S3 by its wrapper took (vec_width):
# "wide", 16 bytes of entries a thread, or "one", one entry a thread
form_counts = {k: {"wide": 0, "one": 0}
               for k in ("krylov_axpy", "krylov_column")}


def reset_launch_counts() -> None:
    _counts.reset()
    for forms in form_counts.values():
        for k in forms:
            forms[k] = 0


# the largest Krylov dimension the kernels take (csrc/bdf.cu kMaxM)
MAX_KRYLOV = 8
# krylov_axpy: -(x - k·y - z), x - k·y, -k·x + y
RESIDUAL, MATVEC, GRAM_SCHMIDT = 0, 1, 2
# krylov_column: v0 = b / beta, v_{j+1} = w / |w|, the last column's solve
FIRST, COLUMN, LAST = 0, 1, 2
# bdf_finish: the Newton tail, the step end
NEWTON, STEP = 0, 1
# a Gram-Schmidt remainder below this many eps of A·v is a breakdown
BREAKDOWN = 16.0
# Scratch.scal: the step size, bh, t_new, the Newton update's norm, beta,
# then ys from this offset (csrc/bdf.cu kH ... kYs)
_YS = 5


def history(cfg) -> bool:
    """Whether the step predicts from the state history alone: the history
    predictor needs max_order <= 2 (no y_prev3 in the carry); BDF3 runs
    keep Hermite."""
    return cfg.history_predictor and cfg.max_order < 3


def over(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """A state over a 0-d step size, rounded as PyTorch divides a tensor
    by a host scalar on its device: the product with the reciprocal on
    CUDA, the quotient on the CPU (JAX's arithmetic there).  The step
    sizes were host scalars before they were device tensors, and either
    rounding, moved by an ulp, moves a storm's float32 trajectory at the
    infiltration switch past the bars that hold the paths together
    (``chip_smoke.py`` phases 8 and 17, ``tests/test_torch_mega.py``)."""
    return x * (1.0 / s) if x.is_cuda else x / s


class Scratch:
    """One solver's buffers on the state's device, for state *y*'s shape
    and dtype and Krylov dimension *m*: the step's plan (``ewt``,
    ``y_pred``, ``c0`` and the 0-d ``h``, ``bh``, ``t_new``), the Newton
    iterate (``y``, ``dnorm``, ``it``, ``more``), GMRES's ``w`` and ``vs``,
    the norms' terms ``sq`` and the step's ``accept``.  Each vector is an
    allocation of its own, aligned as a fresh tensor is, so the reductions
    over it take the path (and the summation order) they take over the
    torch pieces' fresh tensors."""

    def __init__(self, y: torch.Tensor, m: int):
        if y.dtype not in (torch.float32, torch.float64):
            raise ValueError(f"the solver kernels take float32 or float64 "
                             f"states, got {y.dtype}")
        if not 1 <= m <= MAX_KRYLOV:
            raise ValueError(f"krylov_m {m} outside 1..{MAX_KRYLOV}")
        n, dev = y.numel(), y.device
        self.n, self.m, self.dtype, self.device = n, m, y.dtype, dev

        def vec():
            return torch.zeros(n, dtype=y.dtype, device=dev)

        self.ewt, self.y_pred, self.c0, self.y, self.w = (
            vec() for _ in range(5))
        self.vs = [vec() for _ in range(m)]
        self.sq = (vec(), vec())  # (dy·ewt)², ((y_new - y_pred)·ewt)²
        self.scal = torch.zeros(_YS + m, dtype=y.dtype, device=dev)
        self.h, self.bh, self.t_new, self.dnorm, self.beta = (
            self.scal[k] for k in range(_YS))
        self.ys = self.scal[_YS:]
        self.it = torch.zeros((), dtype=torch.int64, device=dev)
        self.more = torch.zeros((), dtype=torch.bool, device=dev)
        self.accept = torch.zeros((), dtype=torch.bool, device=dev)
        self.tol = BREAKDOWN * torch.finfo(y.dtype).eps


# ---------------------------------------------------------------------------
# the torch arithmetic (the torch pieces of solver/bdf.py share it)
# ---------------------------------------------------------------------------


def predict(c, tout, cfg, fy0=None):
    """A step's size, WRMS weights, predictor and BDF coefficients
    (``step_body``'s prelude, ``shud_tpu/solver/bdf.py:238-335``) from the
    carry *c*: ``(h, ewt, y_pred, c0, bh)``.  *fy0*: f at the current
    point, which the Hermite predictors need (None with the history
    predictor)."""
    ewt = 1.0 / (cfg.rtol * torch.abs(c.y) + cfg.atol)
    h = torch.minimum(torch.clamp(c.h, max=cfg.h_max), tout - c.t)
    h = torch.clamp(h, min=cfg.h_min)
    tau, tau2 = c.h_prev, c.h_prev2
    use2, use3 = c.order >= 2, c.order >= 3
    if history(cfg):
        # state-history predictors (no RHS evaluation): order 1 constant,
        # order 2 the quadratic Lagrange through (t-tau-tau2, y_prev2),
        # (t-tau, y_prev), (t, y) extrapolated to t+h
        e0h = h + tau + tau2
        e1h = h + tau
        d01 = over(c.y_prev - c.y_prev2, tau2)
        d12 = over(c.y - c.y_prev, tau)
        d2 = over(d12 - d01, tau + tau2)
        y_pred = torch.where(use2, c.y_prev2 + d01 * e0h + d2 * e0h * e1h,
                             c.y)
    else:
        # order 1: forward Euler; order 2: quadratic Hermite through
        # (y_prev, y, fy0); order 3: cubic Hermite (below)
        a_coef = over(c.y_prev - c.y + fy0 * tau, tau * tau)
        y_pred = torch.where(use2, c.y + fy0 * h + a_coef * h * h,
                             h * fy0 + c.y)
    if cfg.max_order >= 3:
        # Hermite divided differences, nodes [t-tau-tau2, t-tau, t, t]
        w01, w12, w02 = 1.0 / tau2, 1.0 / tau, 1.0 / (tau + tau2)
        e0 = h + tau + tau2
        e1 = h + tau
        d01 = (c.y_prev - c.y_prev2) * w01
        d12 = (c.y - c.y_prev) * w12
        d2_012 = (d12 - d01) * w02
        d2_122 = (fy0 - d12) * w12
        d3 = (d2_122 - d2_012) * w02
        y_pred = torch.where(
            use3, c.y_prev2 + d01 * e0 + d2_012 * e0 * e1 + d3 * e0 * e1 * h,
            y_pred)

    # variable-step BDF coefficients
    r = h / tau
    a1_2 = (1 + r) ** 2 / (1 + 2 * r)
    a2_2 = -(r**2) / (1 + 2 * r)
    b_2 = (1 + r) / (1 + 2 * r)
    c0 = torch.where(use2, a1_2 * c.y + a2_2 * c.y_prev, c.y)
    bh = torch.where(use2, b_2, 1.0) * h
    if cfg.max_order >= 3:
        # variable-step BDF3 via the Lagrange-derivative form
        s1 = h + tau
        s2 = h + tau + tau2
        g0 = 1.0 / h + 1.0 / s1 + 1.0 / s2
        g1 = -(s1 * s2) / (h * tau * (tau + tau2))
        g2 = (h * s2) / (s1 * tau * tau2)
        g3 = -(h * s1) / (s2 * (tau + tau2) * tau2)
        c0 = torch.where(
            use3, over(-(g1 * c.y + g2 * c.y_prev + g3 * c.y_prev2), g0),
            c0)
        bh = torch.where(use3, 1.0 / g0, bh)
    return h, ewt, y_pred, c0, bh


def control(order, h, conv, err, cfg):
    """The error test and the step controller (``step_body``'s tail,
    ``shud_tpu/solver/bdf.py:341-355``): ``(accept, h_next, new_order)``.

    The power in float64, rounded once to the state's dtype: the host's
    powf (numpy's, XLA's on the CPU) is correctly rounded almost always,
    CUDA's is not (up to 2 ulp), and an ulp in a step size moves a storm's
    float32 trajectory at the infiltration switch."""
    accept = conv & (err <= 1.0)
    at_hmin = h <= cfg.h_min * (1 + 1e-9)
    accept = accept | (at_hmin & conv)
    order_p1 = (order + 1).to(err.dtype)
    eta_raw = cfg.safety * ((1.0 / torch.clamp(err, min=1e-10)).double()
                            ** (1.0 / order_p1).double()).to(err.dtype)
    h_acc = h * torch.clamp(eta_raw, cfg.eta_min, cfg.eta_max)
    h_rej = torch.where(conv, h * torch.clamp(eta_raw, 0.1, 0.5), h * 0.25)
    h_next = torch.where(accept, h_acc, torch.clamp(h_rej, min=cfg.h_min))
    new_order = torch.where(accept, torch.clamp(order + 1, max=cfg.max_order),
                            torch.where(conv, order, 1))
    return accept, h_next, new_order


def least_squares(dots, m: int, tol: float):
    """GMRES's scalar chain from one Newton iteration's dot products
    (``dots``: b·b, then for each column j: w·w, v_0·w ... v_j·w, and w·w
    after Gram-Schmidt): the Givens rotations of every column, then the
    back-substitution R ys = g.  Returns ``(beta, ys)``; ``bdf._gmres``'s
    arithmetic, scalar for scalar."""
    beta = torch.sqrt(dots[0])
    zero = torch.zeros_like(beta)
    g = [beta] + [zero] * m
    r_cols, givens, off = [], [], 1
    for j in range(m):
        hcol = list(dots[off + 1:off + j + 2])
        wnorm = column_norm(dots, j, tol)
        off += j + 3
        for i, (c, s) in enumerate(givens):
            tmp = c * hcol[i] + s * hcol[i + 1]
            hcol[i + 1] = -s * hcol[i] + c * hcol[i + 1]
            hcol[i] = tmp
        denom = torch.sqrt(hcol[j] ** 2 + wnorm**2)
        dsafe = torch.where(denom > 0, denom, 1.0)
        c = torch.where(denom > 0, hcol[j] / dsafe, 1.0)
        s = torch.where(denom > 0, wnorm / dsafe, 0.0)
        givens.append((c, s))
        hcol[j] = c * hcol[j] + s * wnorm
        g[j + 1] = -s * g[j]
        g[j] = c * g[j]
        r_cols.append(hcol)
    ys = [zero] * m
    for j in range(m - 1, -1, -1):
        acc = g[j]
        for k in range(j + 1, m):
            acc = acc - r_cols[k][j] * ys[k]
        rjj = r_cols[j][j]
        nz = torch.abs(rjj) > 0
        ys[j] = torch.where(nz, acc / torch.where(nz, rjj, 1.0), 0.0)
    return beta, ys


def column_norm(dots, j: int, tol: float) -> torch.Tensor:
    """|w| after Gram-Schmidt in column *j*, 0 below *tol* x |A·v_j| (a
    breakdown: what Gram-Schmidt left is round-off)."""
    off = 1 + j * (j + 5) // 2
    w0 = torch.sqrt(dots[off])
    wnorm = torch.sqrt(dots[off + j + 2])
    return torch.where(wnorm > tol * w0, wnorm, 0.0)


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------


def bdf_begin_plain(s: Scratch, c, tout, cfg, fy0=None) -> None:
    h, ewt, y_pred, c0, bh = predict(c, tout, cfg, fy0)
    s.ewt.copy_(ewt)
    s.y_pred.copy_(y_pred)
    s.c0.copy_(c0)
    s.h.copy_(h)
    s.bh.copy_(bh)
    s.t_new.copy_(c.t + h)
    s.it.zero_()


def krylov_axpy_plain(mode: int, k, x, y, out, z=None) -> None:
    if mode == RESIDUAL:
        r = -(x - k * y - z)
    elif mode == MATVEC:
        r = x - k * y
    else:
        r = -k * x + y
    out.copy_(r)


def krylov_column_plain(s: Scratch, mode: int, j: int, dots, y=None,
                        y_out=None, norms: bool = True) -> None:
    if mode == FIRST:
        beta = torch.sqrt(dots[0])
        s.vs[0].copy_(s.w / torch.where(beta > 0, beta, 1.0))
        return
    if mode == COLUMN:
        wnorm = column_norm(dots, j, s.tol)
        s.vs[j + 1].copy_(s.w / torch.where(wnorm > 0, wnorm, 1.0))
        return
    beta, ys = least_squares(dots, s.m, s.tol)
    s.beta.copy_(beta)
    s.ys.copy_(torch.stack(ys))
    x = s.vs[0] * ys[0]
    for i in range(1, s.m):
        x = ys[i] * s.vs[i] + x
    dy = torch.where(beta > 0, x, 0.0)
    y_new = y + dy
    if norms:
        s.sq[0].copy_((dy * s.ewt) ** 2)
        s.sq[1].copy_(((y_new - s.y_pred) * s.ewt) ** 2)
    y_out.copy_(y_new)


def bdf_finish_plain(s: Scratch, mode: int, cfg, total, c=None, tout=None,
                     nsteps0=None, active=None) -> None:
    if mode == NEWTON:
        dnorm = torch.sqrt(total / s.n)
        s.dnorm.copy_(dnorm)
        s.it.add_(1)
        s.more.copy_(dnorm > cfg.newton_tol)
        return
    conv = s.dnorm <= cfg.newton_tol
    err = torch.sqrt(total / s.n) * 0.5
    h = s.h
    accept, h_next, new_order = control(c.order, h, conv, err, cfg)
    nfe_n = s.it * (1 + cfg.krylov_m) + (0 if history(cfg) else 1)
    t = torch.where(accept, s.t_new, c.t)
    y = torch.where(accept, s.y, c.y)
    y_prev = torch.where(accept, c.y, c.y_prev)
    y_prev2 = torch.where(accept, c.y_prev, c.y_prev2)
    h_prev = torch.where(accept, h, c.h_prev)
    h_prev2 = torch.where(accept, c.h_prev, c.h_prev2)
    for dst, src in ((c.t, t), (c.h, h_next), (c.h_prev, h_prev),
                     (c.h_prev2, h_prev2), (c.order, new_order),
                     (c.y, y), (c.y_prev, y_prev), (c.y_prev2, y_prev2)):
        dst.copy_(src)
    c.nfe.add_(nfe_n)
    c.nsteps.add_(1)
    c.nfails.add_(conv & ~accept)
    c.nnifails.add_(~conv)
    c.nni.add_(s.it)
    s.accept.copy_(accept)
    if active is not None:
        active.copy_((c.t < tout - 1e-9)
                     & (c.nsteps - nsteps0 < cfg.max_steps))


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


def _ptrs(*items) -> "ctypes.Array":
    """A ctypes array of addresses: a tensor's data, 0 for None, an int
    as it is (a device counter's)."""
    return (ctypes.c_void_p * len(items))(*[
        0 if t is None else t if isinstance(t, int) else t.data_ptr()
        for t in items])


def _checked(what: str, n: int, dtype, *tensors) -> list:
    """The data addresses of *tensors* (0 for None), each checked:
    contiguous, *dtype*, [n]."""
    out = []
    for t in tensors:
        if t is None:
            out.append(0)
            continue
        if t.dtype != dtype or t.shape != (n,) or not t.is_contiguous():
            raise ValueError(f"{what}: a {t.dtype} tensor of shape "
                             f"{tuple(t.shape)}, want contiguous {dtype} "
                             f"[{n}]")
        out.append(t.data_ptr())
    return out


def vec_width(dtype, n: int, addresses) -> int:
    """The entries a thread of S2 and S3 takes (``csrc/bdf.cu``): 16
    bytes of them, 4 in float32 and 2 in float64, when *n* holds that many
    and every address is 16-byte aligned (0, a vector not passed, counts
    as aligned); else 1, the same kernels one entry a thread."""
    wide = 4 if dtype == torch.float32 else 2
    if n < wide or any(a % 16 for a in addresses):
        return 1
    return wide


def _raise_if(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _stream(index: int) -> int:
    """torch's current stream on CUDA device *index*, read on every call
    (a graph's capture runs on a stream of its own)."""
    return torch._C._cuda_getCurrentRawStream(index)


def _counted(name: str, vec: int) -> None:
    launch_counts[name] += 1
    form_counts[name]["wide" if vec > 1 else "one"] += 1


def bdf_begin(s: Scratch, c, tout, cfg, fy0=None) -> None:
    """S1: the step's plan from the carry *c* into *s*: ``ewt``,
    ``y_pred``, ``c0``, ``h``, ``bh``, ``t_new``, and ``it`` zeroed."""
    if on_cpu(c.y, s.ewt, what="solver kernels"):
        return bdf_begin_plain(s, c, tout, cfg, fy0)
    if (fy0 is None) != history(cfg):
        raise ValueError("bdf_begin: fy0 is needed exactly without the "
                         "history predictor")
    _checked("bdf_begin", s.n, s.dtype, c.y, c.y_prev, c.y_prev2, fy0)
    dev = s.device.index
    ptrs = _ptrs(c.y, c.y_prev, c.y_prev2, fy0, c.t, c.h, c.h_prev,
                 c.h_prev2, tout, c.order, s.ewt, s.y_pred, s.c0, s.scal,
                 s.it, _counts.pointer("bdf_begin", dev))
    params = (ctypes.c_double * 4)(cfg.rtol, cfg.atol, cfg.h_max, cfg.h_min)
    iparams = (ctypes.c_longlong * 3)(s.n, cfg.max_order, history(cfg))
    _raise_if(load_library().shud_bdf_begin(
        s.dtype == torch.float64, ptrs, params, iparams, _stream(dev)),
        "bdf_begin")
    launch_counts["bdf_begin"] += 1


def krylov_axpy(mode: int, k, x, y, out, z=None) -> None:
    """S2: ``out = -(x - k·y - z)`` (RESIDUAL), ``x - k·y`` (MATVEC) or
    ``-k·x + y`` (GRAM_SCHMIDT, *out* may be *y*), *k* a 0-d tensor."""
    if on_cpu(x, y, out, k, what="solver kernels"):
        return krylov_axpy_plain(mode, k, x, y, out, z)
    n, dtype = out.numel(), out.dtype
    px, py, pz, po = _checked("krylov_axpy", n, dtype, x, y, z, out)
    vec = vec_width(dtype, n, (px, py, pz, po))
    dev = out.get_device()
    _raise_if(load_library().shud_krylov_axpy(
        dtype == torch.float64, mode, vec, px, py, pz, k.data_ptr(), po,
        _counts.pointer("krylov_axpy", dev), n, _stream(dev)),
        "krylov_axpy")
    _counted("krylov_axpy", vec)


def krylov_column(s: Scratch, mode: int, j: int, dots, y=None, y_out=None,
                  norms: bool = True) -> None:
    """S3 on *s*: FIRST, ``vs[0] = w / beta``; COLUMN (j < m - 1),
    ``vs[j + 1] = w / |w|`` (0 below the breakdown bar: w as it is); LAST,
    the least-squares solve of all m columns (beta and ys into *s*), then
    ``y_out = y + dy`` and, with *norms*, the terms of the Newton update's
    and the error's WRMS norms into ``s.sq``.  *dots*: the iteration's dot
    products so far (``least_squares``)."""
    if on_cpu(s.w, *dots, what="solver kernels"):
        return krylov_column_plain(s, mode, j, dots, y, y_out, norms)
    n, dtype, dev = s.n, s.dtype, s.device.index
    f64 = dtype == torch.float64
    count = _counts.pointer("krylov_column", dev)
    if mode != LAST:
        if mode == FIRST:
            out, wn, w0 = s.vs[0], dots[0], None
        else:
            off = 1 + j * (j + 5) // 2
            out, wn, w0 = s.vs[j + 1], dots[off + j + 2], dots[off]
        pw, po = _checked("krylov_column", n, dtype, s.w, out)
        vec = vec_width(dtype, n, (pw, po))
        _raise_if(load_library().shud_krylov_column_scale(
            f64, vec, pw, po, wn.data_ptr(),
            None if w0 is None else w0.data_ptr(), s.tol, count, n,
            _stream(dev)), "krylov_column")
        _counted("krylov_column", vec)
        return
    nd = 1 + s.m * (s.m + 5) // 2
    if len(dots) < nd:
        raise ValueError(f"krylov_column: {len(dots)} dot products, the "
                         f"last column of m = {s.m} reads {nd}")
    sq = s.sq if norms else (None, None)
    p = _checked("krylov_column", n, dtype, *s.vs, y, s.ewt, s.y_pred,
                 y_out, *sq)
    vec = vec_width(dtype, n, p)
    ptrs = _ptrs(*p[:s.m], *[None] * (MAX_KRYLOV - s.m), *p[s.m:], s.scal,
                 count)
    _raise_if(load_library().shud_krylov_column_last(
        f64, s.m, vec, _ptrs(*dots[:nd]), ptrs, s.tol, n, _stream(dev)),
        "krylov_column")
    _counted("krylov_column", vec)


def bdf_finish(s: Scratch, mode: int, cfg, total, c=None, tout=None,
               nsteps0=None, active=None) -> None:
    """S4 on *s*, *total* the sum of the norm's terms: NEWTON, ``dnorm``,
    ``it + 1`` and ``more``; STEP, the error test and the controller on
    the carry *c* in place (its scalars, counters, y, y_prev, y_prev2),
    ``accept``, and with *active* (a 0-d bool) whether the step loop goes
    on towards *tout* (``bdf.active``, *nsteps0* the window's first step
    count)."""
    if on_cpu(s.y, total, what="solver kernels"):
        return bdf_finish_plain(s, mode, cfg, total, c, tout, nsteps0,
                                active)
    step = mode == STEP
    if step:
        _checked("bdf_finish", s.n, s.dtype, c.y, c.y_prev, c.y_prev2)
    cs = ((c.y, c.y_prev, c.y_prev2, s.y, c.t, c.h, c.h_prev, c.h_prev2,
           c.order, c.nfe, c.nsteps, c.nfails, c.nnifails, c.nni)
          if step else (None,) * 14)
    dev = s.device.index
    ptrs = _ptrs(total, s.scal, s.it, s.more, s.accept, *cs, tout, nsteps0,
                 active, _counts.pointer("bdf_finish", dev))
    # sum / n divides by a host integer: the product with its reciprocal,
    # which PyTorch computes on the host in the state's type
    dt = np.float64 if s.dtype == torch.float64 else np.float32
    params = (ctypes.c_double * 9)(
        float(dt(1.0) / dt(s.n)), cfg.newton_tol, cfg.h_min * (1 + 1e-9),
        cfg.h_min, cfg.safety, cfg.eta_min, cfg.eta_max, 1e-10, 1e-9)
    iparams = (ctypes.c_longlong * 5)(s.n, cfg.max_steps, cfg.max_order,
                                      cfg.krylov_m, history(cfg))
    _raise_if(load_library().shud_bdf_finish(
        s.dtype == torch.float64, mode, ptrs, params, iparams,
        _stream(dev)), "bdf_finish")
    launch_counts["bdf_finish"] += 1


# ---------------------------------------------------------------------------
# the Newton update through the four
# ---------------------------------------------------------------------------


def newton_update(s: Scratch, jvp, y, fy, c0, k, y_out,
                  norms: bool = True, plain: bool = False) -> list:
    """``y_out = y + dy``, dy from single-cycle GMRES(m) on
    ``(I - k·J)·dy = -(y - k·fy - c0)`` (``bdf.newton_iter``'s update with
    ``bdf._gmres``), J·v = ``jvp(v)``; with *norms* the terms of the
    update's and the error's WRMS norms into ``s.sq``.  *plain*: the plain
    versions on any device (what the kernels are held against).  Returns
    the dot products (the reductions between the kernels)."""
    axpy, column = ((krylov_axpy_plain, krylov_column_plain) if plain
                    else (krylov_axpy, krylov_column))
    w, vs, m = s.w, s.vs, s.m
    axpy(RESIDUAL, k, y, fy, w, c0)
    dots = [torch.dot(w, w)]
    column(s, FIRST, 0, dots)
    for j in range(m):
        axpy(MATVEC, k, vs[j], jvp(vs[j]), w)
        dots.append(torch.dot(w, w))
        for i in range(j + 1):
            dots.append(torch.dot(vs[i], w))
            axpy(GRAM_SCHMIDT, dots[-1], vs[i], w, w)
        dots.append(torch.dot(w, w))
        if j < m - 1:
            column(s, COLUMN, j, dots)
    column(s, LAST, m - 1, dots, y, y_out, norms)
    return dots
