"""The lateral edge-flux stencil: plain versions, CUDA kernels, tangent.

The counterpart of ``shud_tpu/core/pallas_edge.py``.  Per edge of the
3-edge cell stencil it computes the diffusive-wave surface discharge
(Manning, upwinded depth, MAXYSURF and depression cutoffs), the Darcy
subsurface discharge (0.02 m cutoffs) and, with open boundaries, the
kinematic free-drainage boundary laws (``fun_Ele_surface``/``fun_Ele_sub``,
MD_ElementFlux.cpp:35-156).  Lake-bank edges come out as 0; the caller
merges that branch by mask (``rhs.edge_fluxes``).

Three functions, each with a plain PyTorch version and a CUDA kernel
(``csrc/edge_flux.cu``):

* ``edge_flux``: primal ``(q_surf, q_sub)``, each ``[Ne,3]``;
* ``edge_coeff``: primal plus six per-edge linearisation coefficients
  ``S_i, S_j, G1, G2, K_i, K_j`` with
  ``tq_surf = S_i t_sf_i + S_j t_sf_j`` and
  ``tq_sub = G1 t_gw_i + G2 t_gw_j + K_i t_kh_i + K_j t_kh_j``;
* ``edge_apply``: that multiply-add for one tangent (one J·v).

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
calls the library directly on torch's current stream, as every kernel of
the port is launched.  The solver's linearization (``rhs.linearize``,
once per Newton iteration) calls ``edge_coeff`` in its primal and
``edge_apply`` once per Krylov vector, as JAX's ``custom_jvp`` does; that
hand linearization is the port's one J·v.  The tangent follows JAX's
conventions (0.5 at ``maximum`` ties, select at ``where``), so it equals
``jax.jvp`` of the reference's XLA path.  No kernel runs inside a
``torch.func`` transform, and a kernel call that autograd would record
raises: ``kernels_may_run`` keeps that rule for every kernel family.

Beside them, the launches of the two kernels of ``csrc/edge_tangent.cu``
(``tangent_cell``, ``tangent_reach``): the rest of ``rhs.linearize``'s
tangent factors on the kernel path.  Their plain version is
``rhs._tangent_factors``, which runs on every other route.  And the two
of ``csrc/edge_rhs.cu`` (``rhs_cell``, ``rhs_assemble``): the rest of the
primal RHS around the edge kernel on a lake-free mesh, whose plain
version is ``rhs._rhs_plain``.  These four wrappers take CUDA tensors
only.
"""

from __future__ import annotations

import ctypes

import torch

from shud_tpu_torch.config import MAXYSURF
from shud_tpu_torch.core.cuda_build import load_library
from shud_tpu_torch.core.launches import LaunchCounts
from shud_tpu_torch.core.physics import (
    _TINY, absolute, cbrt, maximum, minimum, pow23)

_counts = LaunchCounts(("edge_flux", "edge_coeff", "edge_apply",
                        "tangent_cell", "tangent_reach", "rhs_cell",
                        "rhs_assemble"))
# launches of each CUDA kernel by its wrapper since the last
# reset_launch_counts(); device_launch_counts() gives the kernels' own
# count, which also counts the runs of a captured launch
launch_counts = _counts.host
device_launch_counts = _counts.device


def reset_launch_counts() -> None:
    _counts.reset()


# ---------------------------------------------------------------------------
# plain versions (pallas_edge.py:283-382 flux laws, :580-661 coefficients)
# ---------------------------------------------------------------------------


def _cell_fields(sf, gw, kh, et):
    """Own-cell columns [Ne,1] and gathered neighbour fields [Ne,3]."""
    nb = et.nb
    return (sf[:, None], gw[:, None], kh[:, None],
            sf[nb], gw[nb], kh[nb], et.dep[:, None], et.rough[:, None])


def _flux_surface_int(isf, nsf, dzs, dist, B, ravg, dep3):
    dh = (isf - nsf) + dzs
    up1 = torch.where(isf > dep3, isf, 0.0)
    up2 = torch.where(nsf > dep3, nsf, 0.0)
    w = torch.where(dh > 0.0, up1, up2)
    ymean = minimum(w, MAXYSURF)
    s = dh / dist
    sqrt_s = torch.sqrt(maximum(absolute(s), _TINY))
    p23 = pow23(ymean)
    q_pos = sqrt_s * (ymean * B) * p23 / ravg
    q = torch.where(s > 0, q_pos, -q_pos)
    q = torch.where((s > 0) & (isf <= 0.0), 0.0, q)
    q = torch.where((s < 0) & (nsf <= 0.0), 0.0, q)
    q = torch.where(ymean <= 0.0, 0.0, q)
    return q, (dh, w, ymean, s, sqrt_s, p23)


def _flux_surface_bnd(isf, d2e, B, rcell, dep3):
    sb = isf / d2e * 0.5
    isf5 = cbrt(isf * isf * isf * isf * isf)
    qb = torch.sqrt(maximum(sb, 0.0)) * isf5 * B / rcell
    q = torch.where((isf > dep3) & (sb > 0.0), qb, 0.0)
    return q, (sb, isf5)


def _flux_sub_int(gw3, ngw, kh3, nkh, dzb, dist, B):
    dh_s = (gw3 - ngw) + dzb
    ymean_s = 0.5 * (maximum(gw3, 0.0) + maximum(ngw, 0.0))
    grad_s = dh_s / dist
    kmean = 0.5 * (kh3 + nkh)
    q = kmean * grad_s * ymean_s * B
    cut = ((dh_s > 0.0) & (gw3 <= 0.02)) | ((dh_s < 0.0) & (ngw <= 0.02))
    q = torch.where(cut, 0.0, q)
    return q, (dh_s, ymean_s, grad_s, kmean, cut)


def _flux_sub_bnd(gw3, kh3, d2e, dep3):
    grad_b = gw3 / d2e * 0.5
    act = (gw3 > dep3 * 10.0) & (grad_b > 0.0)
    return torch.where(act, kh3 * grad_b, 0.0), (grad_b, act)


def _mask_max0(x):
    """d/dx of ``maximum(x, 0.0)`` as a multiplier (0.5 at ties)."""
    return torch.where(x > 0.0, 1.0, torch.where(x == 0.0, 0.5, 0.0))


def edge_flux_plain(sf, gw, kh, et, close_boundary: bool):
    """Plain version of the primal kernel: ``(q_surf, q_sub)`` [Ne,3]."""
    sf3, gw3, kh3, nsf_raw, ngw, nkh, dep3, rcell = _cell_fields(sf, gw, kh, et)
    isf = maximum(sf3, 0.0)
    nsf = maximum(nsf_raw, 0.0)
    m_int = et.m_int.bool()
    q_int, _ = _flux_surface_int(isf, nsf, et.dzs, et.dist, et.edge,
                                 et.avg_rough, dep3)
    q_sub_int, _ = _flux_sub_int(gw3, ngw, kh3, nkh, et.dzb, et.dist, et.edge)
    if close_boundary:
        return (torch.where(m_int, q_int, 0.0),
                torch.where(m_int, q_sub_int, 0.0))
    m_bnd = et.m_bnd.bool()
    q_bnd, _ = _flux_surface_bnd(isf, et.d2e, et.edge, rcell, dep3)
    q_sub_bnd, _ = _flux_sub_bnd(gw3, kh3, et.d2e, dep3)
    return (torch.where(m_int, q_int, torch.where(m_bnd, q_bnd, 0.0)),
            torch.where(m_int, q_sub_int, torch.where(m_bnd, q_sub_bnd, 0.0)))


def edge_coeff_plain(sf, gw, kh, et, close_boundary: bool):
    """Plain version of the coefficient kernel:
    ``(q_surf, q_sub, S_i, S_j, G1, G2, K_i, K_j)``, each [Ne,3]."""
    sf3, gw3, kh3, nsf_raw, ngw, nkh, dep3, rcell = _cell_fields(sf, gw, kh, et)
    B, dist = et.edge, et.dist
    isf = maximum(sf3, 0.0)
    m_i = _mask_max0(sf3)  # d isf / d sf_i
    nsf = maximum(nsf_raw, 0.0)
    m_j = _mask_max0(nsf_raw)  # d nsf / d sf_j
    m_int = et.m_int.bool()

    # surface interior: the zero-selects of the flux law gate the tangent
    q_int, (dh, w, ymean, s, sqrt_s, p23) = _flux_surface_int(
        isf, nsf, et.dzs, dist, B, et.avg_rough, dep3)
    cross = ymean * B
    gate = torch.where((s > 0) & (isf <= 0.0), 0.0, 1.0)
    gate = torch.where((s < 0) & (nsf <= 0.0), 0.0, gate)
    gate = torch.where(ymean <= 0.0, 0.0, gate)
    sgn_q = torch.where(s > 0, 1.0, -1.0)
    sgn_s = torch.where(s >= 0.0, 1.0, -1.0)
    # a: coefficient of t_dh (through sqrt_s); b: of t_w (through ymean)
    a = torch.where(absolute(s) > _TINY,
                    sgn_s / (2.0 * sqrt_s * dist) * cross * p23 / et.avg_rough,
                    0.0)
    c_p = torch.where(ymean > _TINY,
                      (2.0 / 3.0) / cbrt(maximum(ymean, _TINY)), 0.0)
    m_ym = torch.where(w < MAXYSURF, 1.0, torch.where(w == MAXYSURF, 0.5, 0.0))
    b = sqrt_s * (B * p23 + cross * c_p) / et.avg_rough * m_ym
    u_i = torch.where(dh > 0.0, torch.where(isf > dep3, 1.0, 0.0), 0.0)
    u_j = torch.where(dh > 0.0, 0.0, torch.where(nsf > dep3, 1.0, 0.0))
    gs = gate * sgn_q
    s_i = gs * (a + b * u_i) * m_i
    s_j = gs * (-a + b * u_j) * m_j

    # subsurface interior
    q_sub_int, (dh_s, ymean_s, grad_s, kmean, cut) = _flux_sub_int(
        gw3, ngw, kh3, nkh, et.dzb, dist, B)
    live = torch.where(cut, 0.0, 1.0)
    km_ym_d = kmean * ymean_s / dist
    half_kg = 0.5 * kmean * grad_s
    g1 = live * B * (km_ym_d + half_kg * _mask_max0(gw3))
    g2 = live * B * (-km_ym_d + half_kg * _mask_max0(ngw))
    k_sym = live * B * 0.5 * grad_s * ymean_s

    def sel(v_int, v_bnd=None):
        if v_bnd is None:
            return torch.where(m_int, v_int, 0.0)
        return torch.where(m_int, v_int, torch.where(m_bnd, v_bnd, 0.0))

    if close_boundary:
        return (sel(q_int), sel(q_sub_int), sel(s_i), sel(s_j), sel(g1),
                sel(g2), sel(k_sym), sel(k_sym))

    # open-boundary branches (kinematic drainage)
    m_bnd = et.m_bnd.bool()
    d2e = et.d2e
    q_bnd, (sb, isf5) = _flux_surface_bnd(isf, d2e, B, rcell, dep3)
    act_s = (isf > dep3) & (sb > 0.0)
    sqrt_sb = torch.sqrt(maximum(sb, 0.0))
    c_sqrt_sb = torch.where(sb > 0.0, 0.5 / (d2e * 2.0 * sqrt_sb), 0.0)
    u4 = isf * isf * isf * isf
    c_isf5 = torch.where(isf > 0.0, 5.0 * u4 / (3.0 * isf5 * isf5), 0.0)
    s_b = torch.where(act_s, (c_sqrt_sb * isf5 + sqrt_sb * c_isf5) * B / rcell,
                      0.0) * m_i
    q_sub_bnd, (grad_b, act_b) = _flux_sub_bnd(gw3, kh3, d2e, dep3)
    g1_bnd = torch.where(act_b, kh3 * 0.5 / d2e, 0.0)
    k_i_bnd = torch.where(act_b, grad_b, 0.0)
    return (sel(q_int, q_bnd), sel(q_sub_int, q_sub_bnd), sel(s_i, s_b),
            sel(s_j), sel(g1, g1_bnd), sel(g2), sel(k_sym, k_i_bnd),
            sel(k_sym))


def edge_apply_plain(coeffs, tsf, tgw, tkh, et):
    """Plain version of the apply kernel: ``(tq_surf, tq_sub)`` [Ne,3]."""
    si, sj, g1, g2, ki, kj = coeffs
    nb = et.nb
    tqs = si * tsf[:, None] + sj * tsf[nb]
    tqb = (g1 * tgw[:, None] + g2 * tgw[nb]
           + ki * tkh[:, None] + kj * tkh[nb])
    return tqs, tqb


# ---------------------------------------------------------------------------
# CUDA build and launch
# ---------------------------------------------------------------------------

def on_cpu(*tensors, what: str = "edge kernels") -> bool:
    """True for CPU tensors (the plain versions run), False for CUDA ones
    (the kernel launches); anything else is refused."""
    if all(t.is_cuda for t in tensors):
        return False
    if all(t.is_cpu for t in tensors):
        return True
    devs = {t.device.type for t in tensors}
    raise ValueError(f"{what} take CPU or CUDA tensors, got {devs}")


def kernels_may_run(*tensors) -> bool:
    """The one rule between the CUDA kernels and torch's transforms: False
    inside a ``torch.func`` transform, where no kernel runs (the edge path
    takes its plain RHS there, whose derivative the transform takes; the
    mega path refuses); raises where autograd would record a call on
    *tensors*, since the kernels have no reverse-mode derivative.  J·v is
    the hand linearization's (``rhs.linearize``, ``mega.linearize_mega``)."""
    if torch._C._are_functorch_transforms_active():
        return False
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("the CUDA kernels have no reverse-mode "
                           "derivative; reverse mode is not supported")
    return True


def _check(et, fields):
    """Validate what the kernels read: one CUDA device, float32, [Ne] and
    [Ne,3] shapes, contiguous."""
    ne = et.dep.shape[0]
    dev = et.dep.device
    for name, t in list(fields) + list(et._asdict().items()):
        if name == "nb":
            continue
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, tables on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
        want = {"nabr": torch.int32, "m_int": torch.uint8,
                "m_bnd": torch.uint8}.get(name, torch.float32)
        if t.dtype != want:
            raise ValueError(f"{name} is {t.dtype}, the kernel takes {want}")
        shape = (ne,) if t.dim() == 1 else (ne, 3)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")


def _ptrs(*tensors):
    return [t.data_ptr() for t in tensors]


def _raise_if(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _table_list(et):
    return [et.nabr, et.edge, et.dist, et.avg_rough, et.dzs, et.dzb, et.d2e,
            et.m_int, et.m_bnd, et.dep, et.rough]


def _launch(name, ins, n_out, et, *args):
    """One call of the edge kernel *name* on torch's current stream: the
    addresses of *ins* and of *n_out* new ``[Ne,3]`` outputs, its launch
    counter, then *args*."""
    dev = et.edge.device
    outs = tuple(torch.empty_like(et.edge) for _ in range(n_out))
    err = getattr(load_library(), f"shud_{name}")(
        *_ptrs(*ins, *outs), _counts.pointer(name, dev), *args,
        torch._C._cuda_getCurrentRawStream(dev.index))
    _raise_if(err, name)
    launch_counts[name] += 1
    return outs


def edge_flux(sf, gw, kh, et, close_boundary: bool):
    """Primal edge fluxes ``(q_surf, q_sub)`` [Ne,3]."""
    if on_cpu(sf, gw, kh, et.dep):
        return edge_flux_plain(sf, gw, kh, et, close_boundary)
    _check(et, [("sf", sf), ("gw", gw), ("kh", kh)])
    return _launch("edge_flux", [sf, gw, kh, *_table_list(et)], 2, et,
                   sf.shape[0], int(close_boundary))


def edge_coeff(sf, gw, kh, et, close_boundary: bool):
    """Primal fluxes plus the six coefficient arrays, eight [Ne,3]."""
    if on_cpu(sf, gw, kh, et.dep):
        return edge_coeff_plain(sf, gw, kh, et, close_boundary)
    _check(et, [("sf", sf), ("gw", gw), ("kh", kh)])
    return _launch("edge_coeff", [sf, gw, kh, *_table_list(et)], 8, et,
                   sf.shape[0], int(close_boundary))


def edge_apply(coeffs, tsf, tgw, tkh, et):
    """J·v through the coefficients: ``(tq_surf, tq_sub)`` [Ne,3]."""
    if on_cpu(tsf, tgw, tkh, et.dep):
        return edge_apply_plain(coeffs, tsf, tgw, tkh, et)
    names = ("s_i", "s_j", "g1", "g2", "k_i", "k_j")
    _check(et, [("tsf", tsf), ("tgw", tgw), ("tkh", tkh)]
           + list(zip(names, coeffs)))
    return _launch("edge_apply", [tsf, tgw, tkh, et.nabr, *coeffs], 2, et,
                   tsf.shape[0])


def _check_fields(fields, dtype, device):
    """Validate what a tangent or RHS kernel reads: ``(name, tensor,
    shape)`` triples (a length for a 1-D shape), each of *dtype*, of that
    shape, contiguous, on *device*."""
    for name, t, n in fields:
        want = n if isinstance(n, tuple) else (n,)
        if t.device != device:
            raise ValueError(f"{name} on {t.device}, the kernel's inputs on "
                             f"{device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} is {t.dtype}, the kernel takes {dtype}")
        if tuple(t.shape) != want:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want "
                             f"{want}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def _kernel_args(name, floats, flags):
    """Validate *floats* (float32) and *flags* (int64) on the first's CUDA
    device; returns ``(device, their addresses as a pointer array)``."""
    dev = floats[0][1].device
    if dev.type != "cuda":
        raise ValueError(f"{name} takes CUDA tensors, got {dev}")
    _check_fields(floats, torch.float32, dev)
    _check_fields(flags, torch.int64, dev)
    ptrs = [t.data_ptr() for _, t, _ in floats + flags]
    return dev, (ctypes.c_void_p * len(ptrs))(*ptrs)


def tangent_cell(floats, flags, lake: bool) -> torch.Tensor:
    """The cell kernel: ``[16, ne]`` factors (``rhs._TANGENT_CELL_OUT``)
    from *floats* (``rhs._TANGENT_CELL_FIELDS``, float32 ``[ne]``) and
    *flags* (``i_bc``, ``i_lake``, int64 ``[ne]``); lake cells' factors 0
    when *lake*."""
    ne = floats[0][1].shape[0]
    dev, ptrs = _kernel_args("tangent_cell", [(k, t, ne) for k, t in floats],
                             [(k, t, ne) for k, t in flags])
    # N_CELL_OUT rows
    out = torch.empty((16, ne), dtype=torch.float32, device=dev)
    err = load_library().shud_tangent_cell(
        ptrs, out.data_ptr(), _counts.pointer("tangent_cell", dev), ne,
        int(lake), torch._C._cuda_getCurrentRawStream(dev.index))
    _raise_if(err, "tangent_cell")
    launch_counts["tangent_cell"] += 1
    return out


def tangent_reach(floats, flags, ns: int, nr: int):
    """The reach kernel: ``([11, ...] factors, dn)``, the six segment rows
    ``[ns]`` then the five reach rows ``[nr]`` (``rhs._TANGENT_SEG_OUT``,
    ``rhs._TANGENT_RIV_OUT``) in one float32 buffer, and the downstream
    index ``[nr]`` (int64).  *floats* and *flags*: ``(name, tensor,
    length)`` in ``rhs._TANGENT_REACH_FIELDS`` order."""
    dev, ptrs = _kernel_args("tangent_reach", floats, flags)
    out = torch.empty(6 * ns + 5 * nr, dtype=torch.float32, device=dev)
    dn = torch.empty(nr, dtype=torch.int64, device=dev)
    err = load_library().shud_tangent_reach(
        ptrs, out.data_ptr(), dn.data_ptr(),
        _counts.pointer("tangent_reach", dev), ns, nr,
        torch._C._cuda_getCurrentRawStream(dev.index))
    _raise_if(err, "tangent_reach")
    launch_counts["tangent_reach"] += 1
    return out, dn


def rhs_cell(floats, flags) -> torch.Tensor:
    """The RHS's cell kernel: ``[17, ne]`` rows (``rhs._RHS_CELL_OUT``)
    from *floats* (``rhs._RHS_CELL_FIELDS``, float32 ``[ne]``) and
    *flags* (``i_bc``, int64 ``[ne]``), each ``(name, tensor)``."""
    ne = floats[0][1].shape[0]
    dev, ptrs = _kernel_args("rhs_cell", [(k, t, ne) for k, t in floats],
                             [(k, t, ne) for k, t in flags])
    # N_CELL_OUT rows
    out = torch.empty((17, ne), dtype=torch.float32, device=dev)
    err = load_library().shud_rhs_cell(
        ptrs, out.data_ptr(), _counts.pointer("rhs_cell", dev), ne,
        torch._C._cuda_getCurrentRawStream(dev.index))
    _raise_if(err, "rhs_cell")
    launch_counts["rhs_cell"] += 1
    return out


def rhs_assemble(floats, flags, ne: int, ns: int, nr: int, given=None,
                 pre: bool = False):
    """The RHS's assembly kernel: ``(dy [3 ne + nr], q_esub [ne, 3],
    rows)``, the rows the cell sums ``[4, ne]``, the segments' ``[4, ns]``
    and the reaches' ``[13, nr]`` (``rhs._RHS_CELL_SUMS``,
    ``_RHS_SEG_OUT``, ``_RHS_RIV_OUT``) in one float32 buffer.  *floats*
    (float32) and *flags* (int64, the gather lists last): ``(name, tensor,
    shape)`` in ``rhs._RHS_ASSEMBLE_FIELDS`` and ``_RHS_ASSEMBLE_FLAGS``
    order.

    *given*: ``rhs._RHS_GIVEN``'s sums, each ``None`` or torch's float32
    sum to take in the kernel's place; a gather list whose order the
    kernel does not keep (``sum_in_order``) has to have its sums given.
    *pre*: the launch before such sums, writing only the segments' rows
    and the reaches' first eight (``dy`` and ``q_esub`` are ``None``)."""
    lists = flags[-3:]
    given = [None] * 5 if given is None else list(given)
    # rhs._RHS_GIVEN: seg_to_ele's two sums, seg_to_riv's two, riv_to_down's
    owners = (0, 0, 1, 1, 2)
    if len(given) != 5:
        raise ValueError(f"rhs_assemble takes 5 given sums, got {len(given)}")
    for o, (name, t, _) in enumerate(lists):
        mine = [given[g] is None for g in range(5) if owners[g] == o]
        if len(set(mine)) > 1:
            raise ValueError(f"rhs_assemble: {name}'s sums given in part")
        if mine[0] and not pre and not sum_in_order(t):
            raise ValueError(
                f"rhs_assemble cannot keep torch's order of {name}'s sum "
                f"({tuple(t.shape)}); give its sums")
    dev, ptrs = _kernel_args("rhs_assemble", floats, flags)
    _check_fields([(f"given[{g}]", t, ne if owners[g] == 0 else nr)
                   for g, t in enumerate(given) if t is not None],
                  torch.float32, dev)
    shapes = [t.shape for _, t, _ in lists]
    dims = (ctypes.c_int * 10)(ne, ns, nr, *(k for _, k in shapes),
                               *(sum_threads(k, n) for n, k in shapes),
                               int(pre))
    sums = (ctypes.c_void_p * 5)(*(None if t is None else t.data_ptr()
                                   for t in given))
    dy = q_esub = None
    if not pre:
        dy = torch.empty(3 * ne + nr, dtype=torch.float32, device=dev)
        q_esub = torch.empty((ne, 3), dtype=torch.float32, device=dev)
    rows = torch.empty(4 * ne + 4 * ns + 13 * nr, dtype=torch.float32,
                       device=dev)
    err = load_library().shud_rhs_assemble(
        ptrs, dims, sums, None if pre else dy.data_ptr(),
        None if pre else q_esub.data_ptr(), rows.data_ptr(),
        _counts.pointer("rhs_assemble", dev),
        torch._C._cuda_getCurrentRawStream(dev.index))
    _raise_if(err, "rhs_assemble")
    launch_counts["rhs_assemble"] += 1
    return dy, q_esub, rows


# torch's CUDA sum over a row that the RHS kernels keep bit for bit: at
# most SUM_WIDTH_MAX elements (from 128 its reduce kernel loads four
# neighbours at a time, another order), so over at most 64 threads a row
# (sum_threads; csrc/edge_rhs.cu's kMaxSumThreads, the depth of its tree)
SUM_WIDTH_MAX = 127


def sum_threads(k: int, n: int) -> int:
    """Threads a row of torch's CUDA sum over the last dimension of a
    contiguous float32 ``[n, k]`` tensor, ``k <= SUM_WIDTH_MAX`` (its
    reduce kernel's launch configuration: at most 512 threads a block, up
    to a warp across a row, more where few rows leave the block room)."""
    def last_pow2(x):
        return 512 if x >= 512 else 1 << (max(x, 1).bit_length() - 1)

    d0, d1 = last_pow2(k), last_pow2(n)
    height = min(d1, 512 // min(d0, 32))
    return min(d0, 512 // height)


def sum_in_order(lst: torch.Tensor) -> bool:
    """The RHS kernels keep the order of torch's sum over each row of the
    gather list *lst* (``[n, k]``); where not, torch sums it
    (``rhs._rhs_assemble``)."""
    return lst.shape[1] <= SUM_WIDTH_MAX
