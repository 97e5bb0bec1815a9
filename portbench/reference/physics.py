# A frozen copy of shud_tpu_torch/core/physics.py,
# its imports rewritten to this package; the tangent helpers left out.
"""Pure elementwise physics on tensors, mirroring the reference flux laws.

The counterpart of ``shud_tpu/core/physics.py``: every function is the same
branch-for-branch vectorisation of the reference equation library
(``src/Equations/Equations.cpp``, ``src/classes/Element.cpp``,
``src/Equations/Flux_RiverElement.cpp``, ``src/ModelData/MD_RiverFlux.cpp``),
with the ``where`` chains in the same order.

Tangent conventions follow JAX's, so ``torch.func.jvp`` of the port equals
``jax.jvp`` of the reference at switching points as well:

* ``maximum``/``minimum`` against a constant use ``torch.maximum`` /
  ``torch.minimum`` (0.5 at a tie, like ``jnp.maximum``); ``clamp`` and
  ``relu`` would give 1 or 0 there;
* ``absolute`` is ``where(x >= 0, x, -x)``: tangent +1 at 0, like
  ``jnp.abs`` (``torch.abs`` gives 0);
* ``cbrt`` (torch has none) is a ``pow`` seed plus one Newton polish.

The ``*_lin`` functions give the same laws' partial derivatives as plain
tensors (the factors ``rhs.linearize`` saves once per Newton iteration):
each returns one coefficient per state-dependent argument, so that the
tangent is their sum of products with the arguments' tangents, under the
same conventions (``d_max``/``d_min`` 0.5 at a tie, ``d_abs`` +1 at 0, a
``where`` selects, a mask carries no tangent).
"""

from __future__ import annotations

import torch

from portbench.reference.config import EPSILON, GRAV, ZERO

__all__ = [
    "absolute",
    "cbrt",
    "clip",
    "maximum",
    "minimum",
    "pow23",
    "mean_harmonic",
    "manning_equation",
    "avg_y_sf",
    "avg_y_gw",
    "eff_kh",
    "sat_k_fun",
    "sat2psi",
    "weir_flow_jtoi",
    "weir_flow_jtoi_local",
    "flux_r2e_gw",
    "fun_da_to_dy",
    "d_max",
    "d_min",
    "d_abs",
    "pow23_lin",
    "sat_k_fun_lin",
    "manning_equation_lin",
    "weir_flow_jtoi_lin",
    "weir_flow_jtoi_local_lin",
    "flux_r2e_gw_lin",
    "fun_da_to_dy_lin",
]


# Tiny positive floor used to keep sqrt/cbrt JVP-safe at exactly-zero
# arguments (d sqrt(x)/dx -> inf at 0 poisons Newton's exact JVPs).  The
# floors are value-neutral at f64 (relative value error < 1e-15).
_TINY = 1.0e-30

_CONSTS: dict = {}


def _const(v: float, like: torch.Tensor) -> torch.Tensor:
    """A cached 0-d constant on *like*'s device and dtype (one allocation per
    value, so the hot path launches no fill kernel per call)."""
    key = (v, like.dtype, like.device)
    c = _CONSTS.get(key)
    if c is None:
        c = torch.full((), v, dtype=like.dtype, device=like.device)
        _CONSTS[key] = c
    return c


def maximum(x: torch.Tensor, v: float) -> torch.Tensor:
    return torch.maximum(x, _const(v, x))


def minimum(x: torch.Tensor, v: float) -> torch.Tensor:
    return torch.minimum(x, _const(v, x))


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: min(max(x, lo), hi) with JAX's tie tangents."""
    return minimum(maximum(x, lo), hi)


def absolute(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0.0, x, -x)


def cbrt(x: torch.Tensor) -> torch.Tensor:
    """Real cube root for x >= 0 (0 at 0)."""
    pos = x > 0.0
    xs = torch.where(pos, x, 1.0)
    t = torch.pow(xs, 1.0 / 3.0)
    t = (2.0 * t + xs / (t * t)) * (1.0 / 3.0)
    return torch.where(pos, t, 0.0)


def pow23(x):
    t = cbrt(maximum(x, _TINY))
    return t * t


def mean_harmonic(k1, k2, d1, d2):
    return (k1 * k2) * (d1 + d2) / (d1 * k2 + d2 * k1)


def manning_equation(area, rough, r, s):
    """Signed-slope Manning (Equations.hpp:54-63). Q in m^3/min."""
    q_pos = torch.sqrt(maximum(absolute(s), _TINY)) * area * pow23(r) / rough
    return torch.where(s > 0, q_pos, -q_pos)


def avg_y_sf(z1, y1, z2, y2, threshold):
    """Upwinded surface depth (Equations.cpp:8-50)."""
    h1 = z1 + y1
    h2 = z2 + y2
    up1 = torch.where(y1 > threshold, y1, 0.0)
    up2 = torch.where(y2 > threshold, y2, 0.0)
    return torch.where(h1 > h2, up1, up2)


def avg_y_gw(y1, y2):
    """Arithmetic mean saturated thickness (Equations.cpp:52-69)."""
    return 0.5 * (maximum(y1, 0.0) + maximum(y2, 0.0))


def eff_kh(ygw, aq_depth, mac_d, k_mac, af, k_mx):
    """Effective horizontal conductivity (Equations.cpp:116-134)."""
    below_mac = (mac_d <= ZERO) | (ygw < aq_depth - mac_d)
    full = (k_mac * mac_d * af + k_mx * (aq_depth - mac_d * af)) / aq_depth
    part_num = k_mac * (ygw - (aq_depth - mac_d)) * af + k_mx * (
        aq_depth - mac_d + (ygw - (aq_depth - mac_d)) * (1.0 - af)
    )
    # guard ygw==0 division; branch is unused there
    part = part_num / torch.where(ygw == 0.0, 1.0, ygw)
    return torch.where(below_mac, k_mx, torch.where(ygw > aq_depth, full, part))


def sat_k_fun(satn, n):
    """van Genuchten relative conductivity (Equations.cpp:136-141)."""
    temp = -1.0 + (1.0 - satn ** (n / (n - 1.0))) ** ((n - 1.0) / n)
    return torch.sqrt(satn) * temp * temp


def sat2psi(satn, alpha, n):
    """van Genuchten pressure head (Equations.hpp:31-33)."""
    return -((satn ** (n / (1.0 - n)) - 1.0) ** (1.0 / n)) / alpha


def weir_flow_jtoi(zi, yi, zj, yj, zbank, cwr, width, threshold):
    """Broad-crested weir flow, positive j->i (MD_RiverFlux.cpp:65-98)."""
    hi = yi + zi
    hj = yj + zj
    dh = hj - hi
    y0 = hi - zbank

    # dh > 0 branch (j -> i, positive)
    y_pos = torch.where(hi > zbank, dh, y0)
    q_pos = torch.where(
        (y0 > 0.0) & (yj > threshold),
        cwr * torch.sqrt(2.0 * GRAV * maximum(y_pos, _TINY)) * width
        * y_pos * 60.0,
        0.0,
    )
    # dh <= 0 branch (i -> j, negative)
    y_neg = torch.where(hj > zbank, -dh, y0)
    q_neg = torch.where(
        (y0 > 0.0) & (yi > threshold),
        -cwr * torch.sqrt(2.0 * GRAV * maximum(y_neg, _TINY)) * width
        * y_neg * 60.0,
        0.0,
    )
    return torch.where(dh > 0.0, q_pos, q_neg)


def weir_flow_jtoi_local(y0, yj, yi, cwr, width, threshold):
    """``weir_flow_jtoi`` in local-datum form for the reduced-precision
    path: ``y0 = yi + (zi - zbank)`` precomputed in f64, ``yj`` measured
    above the bank (``zj == zbank``)."""
    dh = yj - y0
    y_pos = torch.where(y0 > 0.0, dh, y0)
    q_pos = torch.where(
        (y0 > 0.0) & (yj > threshold),
        cwr * torch.sqrt(2.0 * GRAV * maximum(y_pos, _TINY)) * width
        * y_pos * 60.0,
        0.0,
    )
    y_neg = torch.where(yj > 0.0, -dh, y0)
    q_neg = torch.where(
        (y0 > 0.0) & (yi > threshold),
        -cwr * torch.sqrt(2.0 * GRAV * maximum(y_neg, _TINY)) * width
        * y_neg * 60.0,
        0.0,
    )
    return torch.where(dh > 0.0, q_pos, q_neg)


def flux_r2e_gw(yr, zr, ye, ze, k_ele, k_riv, length, d_riv):
    """River-bed Darcy exchange, positive river->element
    (Flux_RiverElement.cpp:11-55)."""
    k = 0.5 * (k_ele + k_riv)  # meanArithmetic(. , ., 1, 1)
    he = ye + ze
    hr = yr + zr
    dh = hr - he
    g = dh / d_riv

    a_r2e = torch.where(he > zr, (yr + (he - zr)) * 0.5 * length, yr * length)
    q_r2e = torch.where(yr < EPSILON, 0.0, a_r2e * k * g)

    a_e2r = (yr + (he - zr)) * 0.5 * length
    q_e2r = torch.where(ye > ZERO, a_e2r * k * g, 0.0)

    q = torch.where(dh > ZERO, q_r2e, torch.where(dh < -ZERO, q_e2r, 0.0))
    return torch.where((k_ele < ZERO) | (k_riv < ZERO), 0.0, q)


def fun_da_to_dy(da, w_top, s):
    """Cross-section area change -> stage change via the bank-slope
    quadratic (functions.hpp:117-155), in the citardauq form
    ``2·da / (w + sqrt(w² + 4s·da))``."""
    s_abs = absolute(s)
    cc = w_top * w_top + 4.0 * s_abs * da
    denom = w_top + torch.sqrt(maximum(cc, _TINY))
    quad = torch.where(
        cc < ZERO,
        -w_top / (2.0 * s_abs),
        2.0 * da / torch.where(denom <= 0.0, 1.0, denom),
    )
    EPS_SLOPE = 0.05e-6
    dy = torch.where(s_abs < EPS_SLOPE, da / w_top, quad)
    return torch.where(da == 0.0, 0.0, dy)


# ---------------------------------------------------------------------------
# partial derivatives (the factors of rhs.linearize)
# ---------------------------------------------------------------------------


