"""The whole right-hand side in one kernel call: RHS, exact tangent, diagnostics.

The counterpart of ``shud_tpu/core/pallas_mega.py``.  For a watershed of at
most 32,768 cells (the JAX package's eligibility rule, kept so that both
packages send the same meshes down this path) one call computes the whole
RHS dataflow: BC overlay -> pointwise cell physics (update, ET,
infiltration, recharge) -> 3-edge stencil with lake banks -> segment
stencil -> river chain -> fixed-width reductions -> lake bucket ->
assembly.  Three functions, each with a plain PyTorch version and a CUDA
kernel (``csrc/mega.cu``):

* ``mega_rhs``: dY/dt of the flat state ``[3Ne + Nr + Nl]``;
* ``mega_jvp``: its hand-derived tangent J·v (recomputing the primal, as
  ``_mega_kernel_jvp`` does);
* ``mega_diag``: the driver's per-window diagnostic fields
  (``DIAG_CELL``/``DIAG_RIV``/``DIAG_LAKE``), flat.

The tables are flat and per entity (``[Ne]``, ``[Ne,3]``, ``[Ns]``,
``[Nr]``, fixed-width lists ``[n,K]``), not the TPU's ``(rows,128)``
blocks, so the solver carries the plain flat state and no layout
conversion happens anywhere.  Reductions sum each fixed-width list in
ascending order (``0 + g0 + g1 ...``), padded slots (index == the number
of sources) contribute nothing.

Tangent conventions are the megakernel's hand tangent, not autodiff:
``_dmin``/``_dmax`` give 0.5 at ties, ``_dabs`` gives 0 at 0 (the eager
path's ``absolute`` gives 1 there).

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises.  Each is one cooperative launch of the
fused kernel (``csrc/mega.cu``), whose grid ``launch_plan`` sizes; there
is no fallback.  The tables are checked once (``MegaTables.to``), a
forcing once (``pack_forcing``), and a call checks only its states, then
calls the library directly with pointers and scratch cached on the
tables.

The solver linearizes once per Newton iteration (``linearize_mega``, its
``linearize`` hook): one RHS call, then one tangent call per Krylov
vector, as ``jax.linearize`` with the custom JVP rule gives the JAX
solver.  That is the path's one J·v: ``rhs_mega`` refuses a call inside a
``torch.func`` transform, on every device, since autodiff of the plain
version would not give the hand tangent (``_dabs``).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from shud_tpu_torch import trace
from shud_tpu_torch.config import EPSILON, GRAV, MAXYSURF, ZERO
from shud_tpu_torch.core.device import _fixed_width_lists
from shud_tpu_torch.core.cuda_build import load_library
from shud_tpu_torch.core.edge import (
    _flux_sub_bnd, _flux_sub_int, _flux_surface_int, kernels_may_run, on_cpu)
from shud_tpu_torch.core.launches import LaunchCounts
from shud_tpu_torch.core.physics import cbrt

_TINY = 1.0e-30
MAX_CELLS = 32768
MAX_LAKES = 64

_counts = LaunchCounts(("mega_rhs", "mega_jvp", "mega_diag"))
# launches of each CUDA kernel by its wrapper since the last
# reset_launch_counts(); device_launch_counts() gives the kernels' own
# count, which also counts the runs of a captured launch
launch_counts = _counts.host
device_launch_counts = _counts.device


def reset_launch_counts() -> None:
    _counts.reset()


# ---------------------------------------------------------------------------
# tables (field orders are mirrored by the enums of csrc/mega.cu)
# ---------------------------------------------------------------------------

CELL_F = (
    "area", "sy", "aq_depth", "inf_d", "inf_ksat_v", "ksat_v", "ksat_h",
    "mac_ksat_v", "mac_ksat_h", "mac_d", "h_area_f", "geo_v_area_f",
    "theta_s", "theta_r", "theta_fc", "beta", "veg_frac", "imp_af",
    "wetland_level", "rootreach_level", "depression", "rough",
)
CELL_I = ("ibc_pos", "ibc_neg", "iss_pos", "iss_neg", "is_lake")
# lk_dzl/lk_dzb: f64-precomputed lake-bank datums (mesh.edge_lake_dzl/dzb)
EDGE_F = ("B", "dist", "ravg", "dzs", "dzb", "d2e", "lk_dzl", "lk_dzb")
EDGE_I = ("nbq", "m_int", "m_bnd", "m_lake", "lk_id")
SEG_F = ("length", "cwr", "dep_e", "zr_loc", "neg_depth", "ksat_riv",
         "bed_thick")
SEG_I = ("se", "sr")
RIV_F = ("bank_slope", "bottom_width", "length", "bed_slope", "dist2down",
         "avg_rough", "depth", "depth_dn", "s_mean")
RIV_I = ("has_down", "dn", "crit_out", "to_lake", "lake_id", "bc_pos")
FORC_CELL = ("net_prcp", "pot_evap", "pot_tran", "e_ic", "lai",
             "fu_surf", "fu_sub", "ele_ybc", "ele_qbc", "ele_qss")
FORC_RIV = ("riv_ybc", "riv_qbc")

# diagnostics of mega_diag, matching rhs.rhs_full's diag entries
DIAG_CELL = ("q_rech", "q_sub_tot", "q_surf_tot", "q_e2r_sub", "q_e2r_surf",
             "q_infil", "q_exfil", "es", "eu", "eg", "tu", "tg", "e_ic")
DIAG_RIV = ("q_riv_up", "q_riv_down", "q_riv_sub", "q_riv_surf")
DIAG_LAKE = ("lake_area", "q_lake_evap", "q_lake_prcp", "q_lake_rivin",
             "q_lake_surf", "q_lake_sub")


@dataclasses.dataclass
class MegaTables:
    """Static mesh tables of the mega path, flat per entity, on one device."""

    ne: int
    nr: int
    ns: int
    nl: int
    cell_f: torch.Tensor  # [len(CELL_F), Ne] f32
    cell_i: torch.Tensor  # [len(CELL_I), Ne] i32
    edge_f: torch.Tensor  # [len(EDGE_F), Ne, 3] f32
    edge_i: torch.Tensor  # [len(EDGE_I), Ne, 3] i32
    seg_f: torch.Tensor  # [len(SEG_F), Ns] f32
    seg_i: torch.Tensor  # [len(SEG_I), Ns] i32
    riv_f: torch.Tensor  # [len(RIV_F), Nr] f32
    riv_i: torch.Tensor  # [len(RIV_I), Nr] i32
    seg_to_ele: torch.Tensor  # [Ne, kc] i32, pad Ns
    seg_to_riv: torch.Tensor  # [Nr, kr] i32, pad Ns
    riv_up: torch.Tensor  # [Nr, kup] i32 upstream reaches, pad Nr
    cell_to_lake: torch.Tensor  # [Nl, K] i32, pad Ne
    edge_to_lake: torch.Tensor  # [Nl, K] i32 flat edge e*3+j, pad 3Ne
    riv_to_lake: torch.Tensor  # [Nl, K] i32, pad Nr
    lake_zmin: torch.Tensor  # [Nl] f32
    bathy_y: torch.Tensor  # [Nl, Kb] f32 stage grid
    bathy_a: torch.Tensor  # [Nl, Kb] f32 top areas
    lake_w: torch.Tensor  # [Nl] f32: 1 / number of the lake's cells

    def to(self, device) -> "MegaTables":
        """The tables on *device*, checked once here for what the kernels
        read (type and shape of every table), so no call checks them."""
        kw = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            kw[f.name] = (v.to(device).contiguous()
                          if isinstance(v, torch.Tensor) else v)
        out = MegaTables(**kw)
        _check_tables(out)
        return out


class MegaForcing(NamedTuple):
    """One window's forcing, packed for the mega path (``pack_forcing``)."""

    fcell: torch.Tensor  # [len(FORC_CELL), Ne]
    friv: torch.Tensor  # [len(FORC_RIV), Nr]
    segfu: torch.Tensor  # [Ns] fu_sub at each segment's cell
    flake: torch.Tensor  # [2, Nl] per-lake mean precip, potential evap


def build_mega_tables(md, max_cells: int = MAX_CELLS) -> "MegaTables | None":
    """Tables of the mega path as CPU tensors, or None exactly when
    ``pallas_mega.build_mega_blocks`` returns None (``:232-242``): more
    than *max_cells* cells, no reach or no segment, more than 64 lakes."""
    if (md.num_ele > max_cells or md.num_riv == 0 or md.num_seg == 0
            or md.num_lake > MAX_LAKES):
        return None
    ne, nr, ns, nl = md.num_ele, md.num_riv, md.num_seg, md.num_lake

    def f32(rows):
        return torch.as_tensor(np.stack([np.asarray(r, np.float64)
                                         for r in rows]).astype(np.float32))

    def i32(rows):
        return torch.as_tensor(np.stack([np.asarray(r) for r in rows])
                               .astype(np.int32))

    nabr = np.asarray(md.nabr)
    has_nabr = nabr >= 0
    lakenb = np.asarray(md.lakenabr)
    has_lake_e = lakenb >= 0
    i_bc, i_ss = np.asarray(md.i_bc), np.asarray(md.i_ss)
    i_lake = np.asarray(md.i_lake)
    se, sr = np.asarray(md.seg_ele), np.asarray(md.seg_riv)
    down = np.asarray(md.riv_down)
    has_down = down >= 0
    dn = np.where(has_down, down, 0)
    bs = np.asarray(md.riv_bed_slope)
    depth = np.asarray(md.riv_depth)
    riv_to_lake = np.asarray(md.riv_to_lake)
    to_lake = riv_to_lake >= 0

    kw = dict(
        ne=ne, nr=nr, ns=ns, nl=nl,
        cell_f=f32([getattr(md, n) for n in CELL_F]),
        cell_i=i32([i_bc > 0, i_bc < 0, i_ss > 0, i_ss < 0, i_lake > 0]),
        edge_f=f32([
            md.edge, np.where(has_nabr, md.dist2nabor, 1.0),
            np.maximum(md.avg_rough, 1e-20), md.edge_dz_surf,
            md.edge_dz_bottom, np.maximum(md.dist2edge, 1e-20),
            md.edge_lake_dzl, md.edge_lake_dzb]),
        edge_i=i32([np.where(has_nabr, nabr, 0), has_nabr, ~has_nabr,
                    has_lake_e, np.where(has_lake_e, lakenb, 0)]),
        seg_f=f32([
            md.seg_length, md.seg_cwr, np.asarray(md.depression)[se],
            np.asarray(md.aq_depth)[se] - depth[sr], -depth[sr],
            np.asarray(md.riv_ksat_h)[sr],
            np.maximum(np.asarray(md.riv_bed_thick)[sr], 1e-20)]),
        seg_i=i32([se, sr]),
        riv_f=f32([
            md.riv_bank_slope, md.riv_bottom_width, md.riv_length, bs,
            np.maximum(md.riv_dist2down, 1e-20),
            np.maximum(md.riv_avg_rough, 1e-20), depth, depth[dn],
            0.5 * (bs + bs[dn])]),
        riv_i=i32([has_down, dn, np.asarray(md.riv_outlet_code) == -4,
                   to_lake, np.where(to_lake, riv_to_lake, 0),
                   np.asarray(md.riv_bc) > 0]),
        seg_to_ele=torch.as_tensor(_fixed_width_lists(se, ne, ns)),
        seg_to_riv=torch.as_tensor(_fixed_width_lists(sr, nr, ns)),
        riv_up=torch.as_tensor(_fixed_width_lists(
            np.where(has_down, dn, -1), nr, nr)),
    )
    if nl > 0:
        cells = _fixed_width_lists(np.where(i_lake > 0, i_lake - 1, -1),
                                   nl, ne)
        ncell = np.array([(i_lake == li + 1).sum() for li in range(nl)])
        kw.update(
            cell_to_lake=torch.as_tensor(cells),
            edge_to_lake=torch.as_tensor(
                _fixed_width_lists(lakenb.ravel(), nl, 3 * ne)),
            riv_to_lake=torch.as_tensor(
                _fixed_width_lists(riv_to_lake, nl, nr)),
            lake_zmin=torch.as_tensor(
                np.asarray(md.lake_zmin)[:nl].astype(np.float32)),
            bathy_y=torch.as_tensor(
                np.asarray(md.lake_bathy_y)[:nl].astype(np.float32)),
            bathy_a=torch.as_tensor(
                np.asarray(md.lake_bathy_a)[:nl].astype(np.float32)),
            lake_w=torch.as_tensor(
                (1.0 / np.maximum(ncell, 1)).astype(np.float32)),
        )
    else:
        empty_i = torch.zeros((0, 1), dtype=torch.int32)
        kw.update(cell_to_lake=empty_i, edge_to_lake=empty_i,
                  riv_to_lake=empty_i,
                  lake_zmin=torch.zeros(0), bathy_y=torch.zeros((0, 1)),
                  bathy_a=torch.zeros((0, 1)), lake_w=torch.zeros(0))
    t = MegaTables(**{k: (v.contiguous() if isinstance(v, torch.Tensor)
                          else v) for k, v in kw.items()})
    dims = _kernel_dims(t)
    counts = [("lakes", nl), ("lake_cells", int((i_lake > 0).sum())),
              ("kel", dims[7]), ("krl", dims[8]), ("kup", dims[6])]
    if nl > 0:  # the gather rounds of one stage C: the widest lake list
        counts.append(("stage_c_rounds",
                       -(-max(dims[7], dims[8]) // STAGE_C_CHUNK)))
    for name, value in counts:
        trace.count(f"shud.mega.{name}", value)
    return t


def _rows(n: int, min_rows: int = 8) -> int:
    r = -(-n // 128)
    return max(min_rows, ((r + 7) // 8) * 8)


def tpu_block_rows(ne: int, nr: int, nl: int):
    """Row counts (cells, reaches, lakes) of the TPU's blocked state
    ``[3cb + rb + lb, 128]`` (``pallas_mega.build_mega_blocks``)."""
    rb = _rows(nr if nr < _rows(nr) * 128 else nr + 1)
    if nr >= rb * 128:
        rb += 8
    return _rows(ne), rb, (_rows(nl) if nl > 0 else 0)


def unblock_tpu_state(z: np.ndarray, ne: int, nr: int, nl: int):
    """The flat state of a blocked TPU state (``pallas_mega.z_to_y``), or
    None when *z* does not have the blocked shape of this mesh."""
    cb, rb, lb = tpu_block_rows(ne, nr, nl)
    if z.shape != (3 * cb + rb + lb, 128):
        return None
    parts = [z[0:cb].reshape(-1)[:ne], z[cb:2 * cb].reshape(-1)[:ne],
             z[2 * cb:3 * cb].reshape(-1)[:ne],
             z[3 * cb:3 * cb + rb].reshape(-1)[:nr]]
    if lb > 0:
        parts.append(z[3 * cb + rb:].reshape(-1)[:nl])
    return np.concatenate(parts)


def _list_sum(values: torch.Tensor, lists: torch.Tensor, sign: float = 1.0):
    """Sum (or with ``sign=-1`` subtract) each fixed-width row of *lists*
    in ascending order from 0; padded slots (== len(values)) add 0."""
    padded = torch.cat([values, values.new_zeros(1)])
    g = padded[lists.long()]
    acc = values.new_zeros(lists.shape[0])
    for k in range(lists.shape[1]):
        acc = acc + g[:, k] if sign > 0 else acc - g[:, k]
    return acc


def pack_forcing(tables: MegaTables, fs) -> MegaForcing:
    """The counterpart of ``forcing_to_blocks`` (``pallas_mega.py:484``):
    the ten cell fields, the two river fields, ``fu_sub`` at each
    segment's cell and the per-lake mean P and E, checked here once for
    what the kernels read."""
    dev = tables.cell_f.device
    f32 = torch.float32

    def cast(v):
        return v.to(device=dev, dtype=f32)

    fcell = torch.stack([cast(getattr(fs, n)) for n in FORC_CELL])
    friv = torch.stack([cast(getattr(fs, n)) for n in FORC_RIV])
    segfu = cast(fs.fu_sub)[tables.seg_i[0].long()]
    if tables.nl > 0:
        w = tables.lake_w[:, None]
        flake = torch.stack([
            _weighted_list_sum(cast(fs.prcp), tables.cell_to_lake, w),
            _weighted_list_sum(cast(fs.pot_evap), tables.cell_to_lake, w)])
    else:
        flake = fcell.new_zeros((2, 0))
    forcing = MegaForcing(fcell.contiguous(), friv.contiguous(),
                          segfu.contiguous(), flake.contiguous())
    _check_forcing(tables, forcing)
    return forcing


def _weighted_list_sum(values, lists, w):
    """``sum_k w * values[lists[:, k]]``: one gather, one product, one
    row sum, whatever the lists' width (a lake's cells, thousands on a
    deployment's mesh), in the sum's own order as JAX's matrix product
    (``forcing_to_blocks``) and ``core/rhs.py``'s ``gather_sum`` have
    theirs."""
    padded = torch.cat([values, values.new_zeros(1)])
    return (padded[lists.long()] * w).sum(dim=1)


# ---------------------------------------------------------------------------
# plain versions: _mega_core (pallas_mega.py:909-1438) stage by stage
# ---------------------------------------------------------------------------

_W = torch.where


def _powp(x, p):
    """x**p for x > 0 as exp(p log x), as the megakernel evaluates it."""
    return torch.exp(p * torch.log(x))


def _cbrt_pos(x):
    return cbrt(torch.clamp(x, min=_TINY))


def _pow23(x):
    t = _cbrt_pos(x)
    return t * t


def _flux_surface_bnd(isf, d2e, B, rcell, dep3):
    """Kinematic boundary law with pallas_edge's floored cube root (the
    edge module's ``cbrt`` gives 0 at 0, which the tangent divides by)."""
    sb = isf / d2e * 0.5
    isf5 = _cbrt_pos(isf * isf * isf * isf * isf)
    qb = torch.sqrt(torch.clamp(sb, min=0.0)) * isf5 * B / rcell
    return _W((isf > dep3) & (sb > 0.0), qb, 0.0), (sb, isf5)


def _dmax0(x, tx):
    """Tangent of ``maximum(x, 0)`` (0.5 at the tie)."""
    return _W(x > 0.0, tx, _W(x == 0.0, 0.5 * tx, 0.0))


def _dmin(a, b, ta, tb):
    """Tangent of ``minimum(a, b)`` (0.5/0.5 at exact ties)."""
    return _W(a < b, ta, _W(a == b, 0.5 * (ta + tb), tb))


def _dmax(a, b, ta, tb):
    return _W(a > b, ta, _W(a == b, 0.5 * (ta + tb), tb))


def _dabs(x, tx):
    """Tangent of ``abs`` (sign(0) = 0)."""
    return torch.sign(x) * tx


def _update_element(c, us, gw):
    aqd, mac_d, af = c["aq_depth"], c["mac_d"], c["geo_v_area_f"]
    k_mx, k_mac = c["ksat_h"], c["mac_ksat_h"]
    below = (mac_d <= ZERO) | (gw < aqd - mac_d)
    full = (k_mac * mac_d * af + k_mx * (aqd - mac_d * af)) / aqd
    part_num = k_mac * (gw - (aqd - mac_d)) * af + k_mx * (
        aqd - mac_d + (gw - (aqd - mac_d)) * (1.0 - af))
    part = part_num / _W(gw == 0.0, 1.0, gw)
    effkh = _W(below, k_mx, _W(gw > aqd, full, part))

    deficit_raw = aqd - gw
    kmax = c["inf_ksat_v"] * (1.0 - c["h_area_f"]) \
        + c["mac_ksat_v"] * c["h_area_f"]
    saturated = deficit_raw <= 0.0
    deficit = torch.clamp(deficit_raw, min=0.0)
    theta_raw = us / _W(saturated, 1.0, deficit) * c["theta_s"]
    theta = _W(saturated, c["theta_s"], theta_raw)
    satn = _W(saturated, 1.0,
              (theta - c["theta_r"]) / (c["theta_s"] - c["theta_r"]))
    hi = satn > 0.99
    lo = satn <= ZERO
    satn_mid = torch.clamp(satn, 1e-12, 1.0 - 1e-12)
    n = c["beta"]
    p1 = n / (n - 1.0)
    p2 = (n - 1.0) / n
    inner = _powp(satn_mid, p1)
    temp = -1.0 + _powp(torch.clamp(1.0 - inner, min=_TINY), p2)
    sat_kr_mid = torch.sqrt(satn_mid) * temp * temp
    return dict(
        effkh=effkh, deficit=deficit, kmax=kmax,
        satn=_W(hi, 1.0, _W(lo, 0.0, satn)),
        sat_kr=_W(hi, 1.0, _W(lo, 0.0, sat_kr_mid)),
        theta=_W(hi, c["theta_s"], _W(lo, c["theta_r"], theta)),
        _res=(below, saturated, deficit_raw, satn, hi, lo, satn_mid, inner,
              temp, part))


def _update_element_t(c, us, gw, t_us, t_gw, cu):
    (below, saturated, deficit_raw, satn_pre, hi, lo, satn_mid, inner, temp,
     part) = cu["_res"]
    aqd, af = c["aq_depth"], c["geo_v_area_f"]
    k_mac, k_mx = c["mac_ksat_h"], c["ksat_h"]
    gw_safe = _W(gw == 0.0, 1.0, gw)
    part_num = part * gw_safe
    t_part_num = (k_mac * af + k_mx * (1.0 - af)) * t_gw
    t_part = _W(gw == 0.0, 0.0,
                (t_part_num * gw_safe - part_num * t_gw) / (gw_safe * gw_safe))
    t_effkh = _W(below, 0.0, _W(gw > aqd, 0.0, t_part))

    t_deficit = _dmax0(deficit_raw, -t_gw)
    den = _W(saturated, 1.0, torch.clamp(deficit_raw, min=0.0))
    t_theta = _W(saturated, 0.0,
                 (t_us * den - us * t_deficit) / (den * den) * c["theta_s"])
    t_satn = _W(saturated, 0.0, t_theta / (c["theta_s"] - c["theta_r"]))
    # clip's tangent passes only inside the range, as jnp.clip's does
    in_rng = (satn_pre >= 1e-12) & (satn_pre <= 1.0 - 1e-12)
    t_satn_mid = _W(in_rng, t_satn, 0.0)
    n = c["beta"]
    p1 = n / (n - 1.0)
    p2 = (n - 1.0) / n
    t_inner = p1 * inner / satn_mid * t_satn_mid
    omi = torch.clamp(1.0 - inner, min=_TINY)
    t_omi = _W(1.0 - inner > _TINY, -t_inner, 0.0)
    t_temp = p2 * _powp(omi, p2) / omi * t_omi
    t_skr_mid = (0.5 / torch.sqrt(satn_mid)) * t_satn_mid * temp * temp \
        + torch.sqrt(satn_mid) * 2.0 * temp * t_temp
    hl = hi | lo
    return dict(effkh=t_effkh, deficit=t_deficit,
                satn=_W(hl, 0.0, t_satn), sat_kr=_W(hl, 0.0, t_skr_mid),
                theta=_W(hl, 0.0, t_theta), kmax=torch.zeros_like(t_gw))


def _et_flux(c, f, sf, us, gw, satn):
    va = c["veg_frac"]
    vb = 1.0 - va
    pj = 1.0 - c["imp_af"]
    fc = c["theta_s"] * 0.75
    beta_s_raw = (satn * (c["theta_s"] - c["theta_r"]) - c["theta_r"]) / (
        fc - c["theta_r"])
    beta_s = torch.clamp(beta_s_raw, 0.0, 1.0)
    ibeta = 0.5 * (1.0 - torch.cos(3.1415926 * beta_s))

    pe = f["pot_evap"]
    sf0 = torch.clamp(sf, min=0.0)
    es = torch.minimum(sf0, pe) * vb
    rem = pe - es
    some_left = es < pe
    gw_high = gw > c["wetland_level"]
    gw0 = torch.clamp(gw, min=0.0)
    us0 = torch.clamp(us, min=0.0)
    eg = _W(some_left & gw_high, torch.minimum(gw0, rem) * pj * vb, 0.0)
    eu = _W(some_left & ~gw_high,
            torch.minimum(us0, ibeta * rem) * pj * vb, 0.0)
    has_veg = f["lai"] > ZERO
    ic_dom = f["e_ic"] >= f["pot_tran"]
    root_deep = gw > c["rootreach_level"]
    ptr = f["pot_tran"] - f["e_ic"]
    tg = _W(has_veg & ~ic_dom & root_deep,
            torch.minimum(gw0, ptr) * pj * va, 0.0)
    tu = _W(has_veg & ~ic_dom & ~root_deep,
            torch.minimum(us0, ibeta * ptr) * pj * va, 0.0)
    return dict(es=es, eu=eu, eg=eg, tu=tu, tg=tg,
                _res=(beta_s_raw, beta_s, ibeta, sf0, rem, some_left,
                      gw_high, gw0, us0, has_veg, ic_dom, root_deep, ptr, pe))


def _et_flux_t(c, sf, us, gw, t_sf, t_us, t_gw, t_satn, et):
    (beta_s_raw, beta_s, ibeta, sf0, rem, some_left, gw_high, gw0, us0,
     has_veg, ic_dom, root_deep, ptr, pe) = et["_res"]
    va = c["veg_frac"]
    vb = 1.0 - va
    pj = 1.0 - c["imp_af"]
    fc = c["theta_s"] * 0.75
    t_beta_raw = t_satn * (c["theta_s"] - c["theta_r"]) / (fc - c["theta_r"])
    t_beta = _W((beta_s_raw >= 0.0) & (beta_s_raw <= 1.0), t_beta_raw, 0.0)
    t_ibeta = 0.5 * torch.sin(3.1415926 * beta_s) * 3.1415926 * t_beta
    zero = torch.zeros_like(t_sf)
    t_sf0, t_gw0, t_us0 = _dmax0(sf, t_sf), _dmax0(gw, t_gw), _dmax0(us, t_us)
    t_es = _dmin(sf0, pe, t_sf0, zero) * vb
    t_rem = -t_es
    t_eg = _W(some_left & gw_high, _dmin(gw0, rem, t_gw0, t_rem) * pj * vb,
              0.0)
    t_ib_rem = t_ibeta * rem + ibeta * t_rem
    t_eu = _W(some_left & ~gw_high,
              _dmin(us0, ibeta * rem, t_us0, t_ib_rem) * pj * vb, 0.0)
    act = has_veg & ~ic_dom
    t_tg = _W(act & root_deep, _dmin(gw0, ptr, t_gw0, zero) * pj * va, 0.0)
    t_tu = _W(act & ~root_deep,
              _dmin(us0, ibeta * ptr, t_us0, t_ibeta * ptr) * pj * va, 0.0)
    return dict(es=t_es, eu=t_eu, eg=t_eg, tu=t_tu, tg=t_tg)


def _infiltration(c, cu, sf, us, gw, net_prcp):
    aqd = c["aq_depth"]
    av = sf + net_prcp
    gw_at_surface = (gw + us > aqd) | (cu["deficit"] < us)
    qex = torch.abs(gw + us - aqd) / aqd * cu["kmax"]
    grad = 1.0 + av / c["inf_d"]
    heavy = av > cu["kmax"]
    medium = av > c["inf_ksat_v"]
    ikv, haf, mkv = c["inf_ksat_v"], c["h_area_f"], c["mac_ksat_v"]
    effk = _W(heavy, ikv * (1.0 - haf) + haf * mkv * cu["satn"],
              _W(medium,
                 cu["sat_kr"] * ikv * (1.0 - haf) + haf * mkv * cu["satn"],
                 cu["sat_kr"] * ikv * (1.0 - haf)))
    ge = torch.clamp(grad * effk, min=0.0)
    qi = torch.minimum(av, ge)
    act = (av > 0.0) & (cu["deficit"] > c["inf_d"])
    qi = _W(gw_at_surface, 0.0, _W(act, qi, 0.0))
    qex = _W(gw_at_surface, qex, 0.0)
    return qi, qex, (av, gw_at_surface, grad, heavy, medium, effk, ge, act)


def _infiltration_t(c, cu, tcu, us, gw, t_sf, t_us, t_gw, res):
    av, gw_at_surface, grad, heavy, medium, effk, ge, act = res
    aqd = c["aq_depth"]
    t_av = t_sf
    t_qex = _dabs(gw + us - aqd, t_gw + t_us) / aqd * cu["kmax"] \
        + torch.abs(gw + us - aqd) / aqd * tcu["kmax"]
    t_grad = t_av / c["inf_d"]
    ikv, haf, mkv = c["inf_ksat_v"], c["h_area_f"], c["mac_ksat_v"]
    t_effk = _W(heavy, haf * mkv * tcu["satn"],
                _W(medium,
                   tcu["sat_kr"] * ikv * (1.0 - haf) + haf * mkv * tcu["satn"],
                   tcu["sat_kr"] * ikv * (1.0 - haf)))
    t_ge = _dmax0(grad * effk, t_grad * effk + grad * t_effk)
    t_qi = _W(gw_at_surface, 0.0, _W(act, _dmin(av, ge, t_av, t_ge), 0.0))
    return t_qi, _W(gw_at_surface, t_qex, 0.0)


def _recharge(c, cu, us, gw):
    skip = (gw > c["aq_depth"] - c["inf_d"]) & (us < cu["deficit"])
    g_act = (cu["theta"] > c["theta_r"]) & (us > EPSILON)
    grad = _W(g_act, torch.clamp((cu["theta"] - c["theta_r"])
                                 / (c["theta_fc"] - c["theta_r"]), min=0.0),
              0.0)
    ku = c["inf_ksat_v"] * cu["sat_kr"]
    denom = cu["deficit"] * c["ksat_v"] + gw * ku
    ke = ku * c["ksat_v"] * (cu["deficit"] + gw) / _W(denom == 0.0, 1.0, denom)
    ke = _W(denom == 0.0, 0.0, ke)
    zerok = (c["inf_ksat_v"] <= 0.0) | (c["ksat_v"] <= 0.0)
    qr = _W(skip, 0.0, _W(zerok, 0.0, grad * ke))
    return qr, (skip, g_act, grad, ku, denom, ke, zerok)


def _recharge_t(c, cu, tcu, gw, t_gw, res):
    skip, g_act, grad, ku, denom, ke, zerok = res
    gr_raw = (cu["theta"] - c["theta_r"]) / (c["theta_fc"] - c["theta_r"])
    t_grad = _W(g_act, _dmax0(gr_raw, tcu["theta"]
                              / (c["theta_fc"] - c["theta_r"])), 0.0)
    t_ku = c["inf_ksat_v"] * tcu["sat_kr"]
    t_denom = tcu["deficit"] * c["ksat_v"] + t_gw * ku + gw * t_ku
    den_s = _W(denom == 0.0, 1.0, denom)
    num = ku * c["ksat_v"] * (cu["deficit"] + gw)
    t_num = (t_ku * (cu["deficit"] + gw)
             + ku * (tcu["deficit"] + t_gw)) * c["ksat_v"]
    t_ke = _W(denom == 0.0, 0.0,
              (t_num * den_s - num * t_denom) / (den_s * den_s))
    return _W(skip, 0.0, _W(zerok, 0.0, t_grad * ke + grad * t_ke))


def _weir_local(seg_isf, rstage, dep_e, zj, cwr, width):
    hi = seg_isf
    hj = rstage + zj
    dh = hj - hi
    y0 = hi
    y_pos = _W(hi > 0.0, dh, y0)
    c_pos = (y0 > 0.0) & (rstage > dep_e)
    sq_pos = torch.sqrt(2.0 * GRAV * torch.clamp(y_pos, min=_TINY))
    q_pos = _W(c_pos, cwr * sq_pos * width * y_pos * 60.0, 0.0)
    y_neg = _W(hj > 0.0, -dh, y0)
    c_neg = (y0 > 0.0) & (seg_isf > dep_e)
    sq_neg = torch.sqrt(2.0 * GRAV * torch.clamp(y_neg, min=_TINY))
    q_neg = _W(c_neg, -cwr * sq_neg * width * y_neg * 60.0, 0.0)
    q = _W(dh > 0.0, q_pos, q_neg)
    return q, (hi, hj, dh, y_pos, c_pos, sq_pos, y_neg, c_neg, sq_neg)


def _weir_local_t(t_isf, t_rstage, cwr, width, res):
    hi, hj, dh, y_pos, c_pos, sq_pos, y_neg, c_neg, sq_neg = res
    t_dh = t_rstage - t_isf
    t_ypos = _W(hi > 0.0, t_dh, t_isf)
    t_sqpos = _W(y_pos > _TINY, 2.0 * GRAV * t_ypos / (2.0 * sq_pos), 0.0)
    t_qpos = _W(c_pos, cwr * (t_sqpos * y_pos + sq_pos * t_ypos) * width
                * 60.0, 0.0)
    t_yneg = _W(hj > 0.0, -t_dh, t_isf)
    t_sqneg = _W(y_neg > _TINY, 2.0 * GRAV * t_yneg / (2.0 * sq_neg), 0.0)
    t_qneg = _W(c_neg, -cwr * (t_sqneg * y_neg + sq_neg * t_yneg) * width
                * 60.0, 0.0)
    return _W(dh > 0.0, t_qpos, t_qneg)


def _r2e_local(rstage, zr_loc, gw_e, kh_e, k_riv, length, d_riv):
    k = 0.5 * (kh_e + k_riv)
    he = gw_e
    hr = rstage + zr_loc
    dh = hr - he
    g = dh / d_riv
    a_r2e = _W(he > zr_loc, (rstage + (he - zr_loc)) * 0.5 * length,
               rstage * length)
    q_r2e = _W(rstage < EPSILON, 0.0, a_r2e * k * g)
    a_e2r = (rstage + (he - zr_loc)) * 0.5 * length
    q_e2r = _W(gw_e > ZERO, a_e2r * k * g, 0.0)
    q = _W(dh > ZERO, q_r2e, _W(dh < -ZERO, q_e2r, 0.0))
    zerok = (kh_e < ZERO) | (k_riv < ZERO)
    return _W(zerok, 0.0, q), (k, he, dh, g, a_r2e, a_e2r, zerok)


def _r2e_local_t(rstage, zr_loc, gw_e, t_rstage, t_gw_e, t_kh_e, length,
                 d_riv, res):
    k, he, dh, g, a_r2e, a_e2r, zerok = res
    t_k = 0.5 * t_kh_e
    t_dh = t_rstage - t_gw_e
    t_g = t_dh / d_riv
    t_ar2e = _W(he > zr_loc, (t_rstage + t_gw_e) * 0.5 * length,
                t_rstage * length)
    t_qr2e = _W(rstage < EPSILON, 0.0,
                t_ar2e * k * g + a_r2e * (t_k * g + k * t_g))
    t_ae2r = (t_rstage + t_gw_e) * 0.5 * length
    t_qe2r = _W(gw_e > ZERO, t_ae2r * k * g + a_e2r * (t_k * g + k * t_g),
                0.0)
    t_q = _W(dh > ZERO, t_qr2e, _W(dh < -ZERO, t_qe2r, 0.0))
    return _W(zerok, 0.0, t_q)


def _manning(area, rough, r, s):
    q_pos = torch.sqrt(torch.clamp(torch.abs(s), min=_TINY)) * area \
        * _pow23(r) / rough
    return _W(s > 0, q_pos, -q_pos)


def _manning_t(area, rough, r, s, t_area, t_r, t_s):
    abs_s = torch.abs(s)
    sq = torch.sqrt(torch.clamp(abs_s, min=_TINY))
    t_sq = _W(abs_s > _TINY, _dabs(s, t_s) / (2.0 * sq), 0.0)
    p23 = _pow23(r)
    t_p23 = _W(r > _TINY, (2.0 / 3.0) * t_r / _cbrt_pos(r), 0.0)
    t_qpos = (t_sq * area * p23 + sq * t_area * p23 + sq * area * t_p23) \
        / rough
    return _W(s > 0, t_qpos, -t_qpos)


_EPS_SLOPE = 0.05e-6


def _da_to_dy(da, w_top, s):
    """Citardauq form 2·da/(w + sqrt(w² + 4s·da))."""
    s_abs = torch.abs(s)
    cc = w_top * w_top + 4.0 * s_abs * da
    sq = torch.sqrt(torch.clamp(cc, min=_TINY))
    denom = w_top + sq
    den_s = _W(denom <= 0.0, 1.0, denom)
    quad = _W(cc < ZERO, -w_top / (2.0 * s_abs), 2.0 * da / den_s)
    dy = _W(s_abs < _EPS_SLOPE, da / w_top, quad)
    return _W(da == 0.0, 0.0, dy), (s_abs, cc, sq, den_s)


def _da_to_dy_t(da, w_top, t_da, t_wtop, res):
    s_abs, cc, sq, den_s = res
    t_cc = 2.0 * w_top * t_wtop + 4.0 * s_abs * t_da
    t_sq = _W(cc > _TINY, t_cc / (2.0 * sq), 0.0)
    t_den = t_wtop + t_sq
    t_quad = _W(cc < ZERO, -t_wtop / (2.0 * s_abs),
                (2.0 * t_da * den_s - 2.0 * da * t_den) / (den_s * den_s))
    t_dy = _W(s_abs < _EPS_SLOPE,
              (t_da * w_top - da * t_wtop) / (w_top * w_top), t_quad)
    return _W(da == 0.0, 0.0, t_dy)


def _flux_surface_int_t(isf, nsf, t_isf, t_nsf, res, dist, B, ravg, dep3):
    dh, w, ymean, s, sqrt_s, p23 = res
    t_dh = t_isf - t_nsf
    t_w = _W(dh > 0.0, _W(isf > dep3, t_isf, 0.0), _W(nsf > dep3, t_nsf, 0.0))
    t_ym = _W(w < MAXYSURF, t_w, _W(w == MAXYSURF, 0.5 * t_w, 0.0))
    t_s = t_dh / dist
    t_abs_s = _W(s >= 0.0, t_s, -t_s)
    t_sqrt_s = _W(torch.abs(s) > _TINY, t_abs_s / (2.0 * sqrt_s), 0.0)
    t_p23 = _W(ymean > _TINY, (2.0 / 3.0) * t_ym / _cbrt_pos(ymean), 0.0)
    cross = ymean * B
    t_qpos = (t_sqrt_s * cross * p23
              + sqrt_s * (t_ym * B * p23 + cross * t_p23)) / ravg
    t_q = _W(s > 0, t_qpos, -t_qpos)
    t_q = _W((s > 0) & (isf <= 0.0), 0.0, t_q)
    t_q = _W((s < 0) & (nsf <= 0.0), 0.0, t_q)
    return _W(ymean <= 0.0, 0.0, t_q)


def _flux_surface_bnd_t(isf, t_isf, res, d2e, B, rcell, dep3):
    sb, isf5 = res
    t_sb = t_isf / d2e * 0.5
    sqrt_sb = torch.sqrt(torch.clamp(sb, min=0.0))
    t_sqrt_sb = _W(sb > 0.0, t_sb / (2.0 * sqrt_sb), 0.0)
    u4 = isf * isf * isf * isf
    t_isf5 = _W(isf > 0.0, 5.0 * u4 * t_isf / (3.0 * isf5 * isf5), 0.0)
    t_qb = (t_sqrt_sb * isf5 + sqrt_sb * t_isf5) * B / rcell
    return _W((isf > dep3) & (sb > 0.0), t_qb, 0.0)


def _flux_sub_int_t(gw3, ngw, t_gw3, t_ngw, t_kh3, t_nkh, res, dist, B):
    dh_s, ymean_s, grad_s, kmean, cut = res
    t_ym = 0.5 * (_dmax0(gw3, t_gw3) + _dmax0(ngw, t_ngw))
    t_grad = (t_gw3 - t_ngw) / dist
    t_km = 0.5 * (t_kh3 + t_nkh)
    t_q = (t_km * grad_s * ymean_s + kmean * t_grad * ymean_s
           + kmean * grad_s * t_ym) * B
    return _W(cut, 0.0, t_q)


def _flux_sub_bnd_t(kh3, t_gw3, t_kh3, res, d2e):
    grad_b, act = res
    return _W(act, t_kh3 * grad_b + kh3 * (t_gw3 / d2e * 0.5), 0.0)


def _lake_bank(isf, gw3, kh3, nkh, lake_e, B, dist, dzl, dzb):
    """Weir and Darcy laws of the lake-bank edges against the lake stage
    (pallas_mega.py:1078-1099)."""
    lake_nsf = torch.clamp(lake_e, min=0.0)
    hi0 = lake_nsf + dzl
    dh_w = isf - hi0
    y_pos = _W(hi0 > 0.0, dh_w, hi0)
    sq_pos = torch.sqrt(2.0 * GRAV * torch.clamp(y_pos, min=_TINY))
    c_pos = (hi0 > 0.0) & (isf > 0.01)
    q_pos = _W(c_pos, 0.6 * sq_pos * B * y_pos * 60.0, 0.0)
    y_neg = _W(isf > 0.0, -dh_w, hi0)
    sq_neg = torch.sqrt(2.0 * GRAV * torch.clamp(y_neg, min=_TINY))
    c_neg = (hi0 > 0.0) & (lake_nsf > 0.01)
    q_neg = _W(c_neg, -0.6 * sq_neg * B * y_neg * 60.0, 0.0)
    q_surf = _W(dh_w > 0.0, q_pos, q_neg)

    dh_lk = (gw3 - lake_e) + dzb
    ymean_lk = 0.5 * (torch.clamp(gw3, min=0.0)
                      + torch.clamp(lake_e, min=0.0))
    kmean_lk = 0.5 * (kh3 + nkh)
    q_sub = kmean_lk * (dh_lk / dist) * ymean_lk * B
    cut = ((dh_lk > 0.0) & (gw3 <= 0.02)) | ((dh_lk < 0.0) & (lake_e <= 0.02))
    q_sub = _W(cut, 0.0, q_sub)
    return q_surf, q_sub, (hi0, dh_w, y_pos, sq_pos, c_pos, y_neg, sq_neg,
                           c_neg, dh_lk, ymean_lk, kmean_lk, cut)


def _lake_bank_t(isf, gw3, lake_e, t_isf, t_gw3, t_kh3, t_nkh, t_lake_e, B,
                 dist, res):
    (hi0, dh_w, y_pos, sq_pos, c_pos, y_neg, sq_neg, c_neg, dh_lk, ymean_lk,
     kmean_lk, cut) = res
    t_hi0 = _dmax0(lake_e, t_lake_e)
    t_dh_w = t_isf - t_hi0
    t_y_pos = _W(hi0 > 0.0, t_dh_w, t_hi0)
    t_sq_pos = _W(y_pos > _TINY, 2.0 * GRAV * t_y_pos / (2.0 * sq_pos), 0.0)
    t_q_pos = _W(c_pos, 0.6 * (t_sq_pos * y_pos + sq_pos * t_y_pos) * B
                 * 60.0, 0.0)
    t_y_neg = _W(isf > 0.0, -t_dh_w, t_hi0)
    t_sq_neg = _W(y_neg > _TINY, 2.0 * GRAV * t_y_neg / (2.0 * sq_neg), 0.0)
    t_q_neg = _W(c_neg, -0.6 * (t_sq_neg * y_neg + sq_neg * t_y_neg) * B
                 * 60.0, 0.0)
    t_surf = _W(dh_w > 0.0, t_q_pos, t_q_neg)
    t_dh_lk = t_gw3 - t_lake_e
    t_ymean = 0.5 * (_dmax0(gw3, t_gw3) + _dmax0(lake_e, t_lake_e))
    t_kmean = 0.5 * (t_kh3 + t_nkh)
    t_sub = (t_kmean * (dh_lk / dist) * ymean_lk
             + kmean_lk * (t_dh_lk / dist) * ymean_lk
             + kmean_lk * (dh_lk / dist) * t_ymean) * B
    return t_surf, _W(cut, 0.0, t_sub)


def _toparea(stg, zmin, by, ba, t_stg=None):
    """Bathymetry stage -> top area, the sequential scan with a ``done``
    flag (pallas_mega.py:1294-1319), vectorised over lakes; with *t_stg*
    also its tangent."""
    yq = stg + zmin
    ta = ba[:, 0]
    done = yq <= by[:, 0]
    t_ta = torch.zeros_like(stg) if t_stg is not None else None
    for i in range(1, by.shape[1]):
        yi, yim, ai = by[:, i], by[:, i - 1], ba[:, i]
        below = yq < yi
        eq = yi == yq
        denom = _W(eq, 1.0, yi - yq)
        u = ai - ta
        v = (yq - yim) / denom
        new_ta = _W(below, u * v + ta, ai)
        if t_stg is not None:
            t_denom = _W(eq, 0.0, -t_stg)
            t_v = (t_stg * denom - (yq - yim) * t_denom) / (denom * denom)
            t_new = _W(below, -t_ta * v + u * t_v + t_ta, 0.0)
            t_ta = _W(done, t_ta, t_new)
        ta = _W(done, ta, new_ta)
        done = done | below
    return ta, t_ta


def _mega_core(T: MegaTables, F: MegaForcing, y, close_boundary: bool,
               ty=None, want_diag=False):
    """The RHS dataflow on flat tensors.  With *ty* returns the tangent
    (recomputing the primal); with *want_diag* the diagnostics, flat in
    the order DIAG_CELL, DIAG_RIV, DIAG_LAKE; else dY."""
    ne, nr, nl = T.ne, T.nr, T.nl
    c = {n: T.cell_f[i] for i, n in enumerate(CELL_F)}
    ci = {n: T.cell_i[i] > 0 for i, n in enumerate(CELL_I)}
    f = {n: F.fcell[i] for i, n in enumerate(FORC_CELL)}
    ef = {n: T.edge_f[i] for i, n in enumerate(EDGE_F)}
    ei = {n: T.edge_i[i] for i, n in enumerate(EDGE_I)}
    sfl = {n: T.seg_f[i] for i, n in enumerate(SEG_F)}
    rf = {n: T.riv_f[i] for i, n in enumerate(RIV_F)}
    ri = {n: T.riv_i[i] for i, n in enumerate(RIV_I)}
    with_t = ty is not None

    def split(v):
        return (v[:ne], v[ne:2 * ne], v[2 * ne:3 * ne],
                v[3 * ne:3 * ne + nr], v[3 * ne + nr:3 * ne + nr + nl])

    sf_raw, us, gw_raw, rv_raw, stg = split(y)
    if with_t:
        t_sf, t_us, t_gw_raw, t_rv, t_stg = split(ty)
    is_lake = ci["is_lake"]

    # BC overlay (MD_update.cpp:102-189)
    gw = _W(ci["ibc_pos"], f["ele_ybc"], gw_raw)
    riv_bcpos = ri["bc_pos"] > 0
    rstage = _W(riv_bcpos, F.friv[0], rv_raw)
    if with_t:
        t_gw = _W(ci["ibc_pos"], 0.0, t_gw_raw)
        t_rst = _W(riv_bcpos, 0.0, t_rv)

    # river trapezoid geometry (River.cpp:49-62)
    bs, bw = rf["bank_slope"], rf["bottom_width"]
    topw_raw = rstage * bs * 2.0 + bw
    r_topw = torch.clamp(topw_raw, min=0.0)
    csa_raw = rstage * (bw + rstage * bs)
    r_csa = torch.clamp(csa_raw, min=0.0)
    per_raw = 2.0 * torch.abs(rstage) * torch.sqrt(1.0 + bs * bs) + bw
    r_per = torch.clamp(per_raw, min=0.0)
    if with_t:
        t_topw = _dmax0(topw_raw, t_rst * bs * 2.0)
        t_csa = _dmax0(csa_raw, t_rst * (bw + 2.0 * rstage * bs))
        t_per = _dmax0(per_raw, 2.0 * _dabs(rstage, t_rst)
                       * torch.sqrt(1.0 + bs * bs))

    # pointwise cell physics
    cu = _update_element(c, us, gw)
    if nl > 0:
        cu["effkh"] = _W(is_lake, c["ksat_h"], cu["effkh"])
    et = _et_flux(c, f, sf_raw, us, gw, cu["satn"])
    qi0, qex0, res_inf = _infiltration(c, cu, sf_raw, us, gw, f["net_prcp"])
    q_infil = qi0 * f["fu_surf"]
    q_exfil = qex0 * f["fu_surf"]
    qr0, res_rech = _recharge(c, cu, us, gw)
    q_rech = qr0 * f["fu_sub"]
    if nl > 0:
        q_infil = _W(is_lake, 0.0, q_infil)
        q_exfil = _W(is_lake, 0.0, q_exfil)
        q_rech = _W(is_lake, 0.0, q_rech)
    if with_t:
        tcu = _update_element_t(c, us, gw, t_us, t_gw, cu)
        if nl > 0:
            tcu["effkh"] = _W(is_lake, 0.0, tcu["effkh"])
        tet = _et_flux_t(c, sf_raw, us, gw, t_sf, t_us, t_gw, tcu["satn"], et)
        t_qi0, t_qex0 = _infiltration_t(c, cu, tcu, us, gw, t_sf, t_us, t_gw,
                                        res_inf)
        t_qinf = t_qi0 * f["fu_surf"]
        t_qexf = t_qex0 * f["fu_surf"]
        t_qrech = _recharge_t(c, cu, tcu, gw, t_gw, res_rech) * f["fu_sub"]
        if nl > 0:
            t_qinf = _W(is_lake, 0.0, t_qinf)
            t_qexf = _W(is_lake, 0.0, t_qexf)
            t_qrech = _W(is_lake, 0.0, t_qrech)

    # 3-edge lateral stencil (MD_ElementFlux.cpp:35-156), [Ne,3]
    nbq = ei["nbq"].long()
    m_int, m_bnd = ei["m_int"] > 0, ei["m_bnd"] > 0
    B, dist, ravg = ef["B"], ef["dist"], ef["ravg"]
    d2e = ef["d2e"]
    dep3 = c["depression"][:, None]
    rcell3 = c["rough"][:, None]
    isf = torch.clamp(sf_raw, min=0.0)[:, None]
    gw3 = gw[:, None]
    kh3 = cu["effkh"][:, None]
    nsf_raw, ngw, nkh = sf_raw[nbq], gw[nbq], cu["effkh"][nbq]
    nsf = torch.clamp(nsf_raw, min=0.0)
    if with_t:
        t_isf = _dmax0(sf_raw, t_sf)[:, None]
        t_gw3 = t_gw[:, None]
        t_kh3 = tcu["effkh"][:, None]
        t_nsf = _dmax0(nsf_raw, t_sf[nbq])
        t_ngw, t_nkh = t_gw[nbq], tcu["effkh"][nbq]

    q_int, res_si = _flux_surface_int(isf, nsf, ef["dzs"], dist, B, ravg,
                                      dep3)
    q_sub_int, res_bi = _flux_sub_int(gw3, ngw, kh3, nkh, ef["dzb"], dist, B)
    if close_boundary:
        q_esurf = _W(m_int, q_int, 0.0)
        q_esub0 = _W(m_int, q_sub_int, 0.0)
    else:
        q_bnd, res_sb = _flux_surface_bnd(isf, d2e, B, rcell3, dep3)
        q_sub_bnd, res_bb = _flux_sub_bnd(gw3, kh3, d2e, dep3)
        q_esurf = _W(m_int, q_int, _W(m_bnd, q_bnd, 0.0))
        q_esub0 = _W(m_int, q_sub_int, _W(m_bnd, q_sub_bnd, 0.0))
    if with_t:
        tq_int = _flux_surface_int_t(isf, nsf, t_isf, t_nsf, res_si, dist, B,
                                     ravg, dep3)
        tq_sub_int = _flux_sub_int_t(gw3, ngw, t_gw3, t_ngw, t_kh3, t_nkh,
                                     res_bi, dist, B)
        if close_boundary:
            t_qesurf = _W(m_int, tq_int, 0.0)
            t_qesub0 = _W(m_int, tq_sub_int, 0.0)
        else:
            tq_bnd = _flux_surface_bnd_t(isf, t_isf, res_sb, d2e, B, rcell3,
                                         dep3)
            tq_sub_bnd = _flux_sub_bnd_t(kh3, t_gw3, t_kh3, res_bb, d2e)
            t_qesurf = _W(m_int, tq_int, _W(m_bnd, tq_bnd, 0.0))
            t_qesub0 = _W(m_int, tq_sub_int, _W(m_bnd, tq_sub_bnd, 0.0))

    # lake-bank branch (MD_ElementFlux.cpp:46-53,122)
    if nl > 0:
        m_lake = ei["m_lake"] > 0
        lk_id = ei["lk_id"].long()
        lake_e = stg[lk_id]
        q_surf_lk, q_sub_lk, res_lk = _lake_bank(
            isf, gw3, kh3, nkh, lake_e, B, dist, ef["lk_dzl"], ef["lk_dzb"])
        q_esurf = _W(m_lake, q_surf_lk, q_esurf)
        q_esub0 = _W(m_lake, q_sub_lk, q_esub0)
        # per-lake bank totals use the UNSCALED sub flux
        q_lk_surf_e = _W(m_lake, q_surf_lk, 0.0)
        q_lk_sub_e = _W(m_lake, q_sub_lk, 0.0)
        if with_t:
            t_surf_lk, t_sub_lk = _lake_bank_t(
                isf, gw3, lake_e, t_isf, t_gw3, t_kh3, t_nkh, t_stg[lk_id],
                B, dist, res_lk)
            t_qesurf = _W(m_lake, t_surf_lk, t_qesurf)
            t_qesub0 = _W(m_lake, t_sub_lk, t_qesub0)
            t_lk_surf_e = _W(m_lake, t_surf_lk, 0.0)
            t_lk_sub_e = _W(m_lake, t_sub_lk, 0.0)

    fu_sub3 = f["fu_sub"][:, None]
    q_esub = q_esub0 * fu_sub3
    if with_t:
        t_qesub = t_qesub0 * fu_sub3

    def slot_sum(v):
        return v[:, 0] + v[:, 1] + v[:, 2]

    # segment stencil (MD_RiverFlux.cpp:65-126)
    se, sr = T.seg_i[0].long(), T.seg_i[1].long()
    a_cell = sf_raw - q_infil + q_exfil
    sfe_raw, gwe, khe, rstage_s = a_cell[se], gw[se], cu["effkh"][se], \
        rstage[sr]
    seg_isf = torch.clamp(sfe_raw, min=0.0)
    q_seg_surf, res_w = _weir_local(seg_isf, rstage_s, sfl["dep_e"],
                                    sfl["neg_depth"], sfl["cwr"],
                                    sfl["length"])
    q_r2e, res_r2e = _r2e_local(rstage_s, sfl["zr_loc"], gwe, khe,
                                sfl["ksat_riv"], sfl["length"],
                                sfl["bed_thick"])
    q_seg_sub = q_r2e * F.segfu
    if with_t:
        t_acell = t_sf - t_qinf + t_qexf
        t_seg_isf = _dmax0(sfe_raw, t_acell[se])
        t_rst_s = t_rst[sr]
        t_qseg_surf = _weir_local_t(t_seg_isf, t_rst_s, sfl["cwr"],
                                    sfl["length"], res_w)
        t_qseg_sub = _r2e_local_t(rstage_s, sfl["zr_loc"], gwe, t_rst_s,
                                  t_gw[se], tcu["effkh"][se], sfl["length"],
                                  sfl["bed_thick"], res_r2e) * F.segfu

    # river chain (Flux_RiverDown, MD_RiverFlux.cpp:5-63)
    dn = ri["dn"].long()
    rstage_dn = rstage[dn]
    s_down = ((rstage - rf["depth"]) - (rstage_dn - rf["depth_dn"])) \
        / rf["dist2down"] + rf["s_mean"]
    per_z = r_per <= ZERO
    r_hyd = _W(per_z, 0.0, r_csa / _W(per_z, 1.0, r_per))
    q_down_int = _manning(r_csa, rf["avg_rough"], r_hyd, s_down)
    s_out = rf["bed_slope"] + rstage * 2.0 / rf["length"]
    q_out_zdg = _manning(r_csa, rf["avg_rough"], r_hyd, s_out)
    sq_g = torch.sqrt(GRAV * torch.clamp(rstage, min=1e-30))
    q_out_crit = r_csa * sq_g * 60.0
    has_down, to_lake = ri["has_down"] > 0, ri["to_lake"] > 0
    crit = ri["crit_out"] > 0
    q_riv_down = _W(to_lake, q_out_zdg,
                    _W(has_down, q_down_int, _W(crit, q_out_crit, q_out_zdg)))
    if with_t:
        t_sdown = (t_rst - t_rst[dn]) / rf["dist2down"]
        t_rhyd = _W(per_z, 0.0, (t_csa * r_per - r_csa * t_per)
                    / _W(per_z, 1.0, r_per * r_per))
        t_qdown_int = _manning_t(r_csa, rf["avg_rough"], r_hyd, s_down,
                                 t_csa, t_rhyd, t_sdown)
        t_sout = t_rst * 2.0 / rf["length"]
        t_qzdg = _manning_t(r_csa, rf["avg_rough"], r_hyd, s_out, t_csa,
                            t_rhyd, t_sout)
        t_sqg = _W(rstage > 1e-30, GRAV * t_rst / (2.0 * sq_g), 0.0)
        t_qcrit = (t_csa * sq_g + r_csa * t_sqg) * 60.0
        t_qriv_down = _W(to_lake, t_qzdg,
                         _W(has_down, t_qdown_int,
                            _W(crit, t_qcrit, t_qzdg)))

    # reductions (PassValue equivalents, fixed-width lists)
    q_riv_surf = _list_sum(q_seg_surf, T.seg_to_riv)
    q_riv_sub = _list_sum(q_seg_sub, T.seg_to_riv)
    e2r_surf = _list_sum(q_seg_surf, T.seg_to_ele, -1.0)
    e2r_sub = _list_sum(q_seg_sub, T.seg_to_ele, -1.0)
    q_riv_up = _list_sum(q_riv_down, T.riv_up, -1.0)
    if with_t:
        t_qriv_surf = _list_sum(t_qseg_surf, T.seg_to_riv)
        t_qriv_sub = _list_sum(t_qseg_sub, T.seg_to_riv)
        t_e2r_surf = _list_sum(t_qseg_surf, T.seg_to_ele, -1.0)
        t_e2r_sub = _list_sum(t_qseg_sub, T.seg_to_ele, -1.0)
        t_qriv_up = _list_sum(t_qriv_down, T.riv_up, -1.0)

    # lake bucket dStage (MD_f.cpp:44-47,180-191; Lake.cpp:toparea)
    if nl > 0:
        p_l, e_l = F.flake[0], F.flake[1]
        avail = p_l + stg
        inner = torch.minimum(e_l, avail)
        evap = torch.clamp(inner, min=0.0)
        surf_l = _list_sum(q_lk_surf_e.reshape(-1), T.edge_to_lake)
        sub_l = _list_sum(q_lk_sub_e.reshape(-1), T.edge_to_lake)
        q_rl = _W(to_lake, q_riv_down, 0.0)
        rivin_l = _list_sum(q_rl, T.riv_to_lake)
        ta, t_ta = _toparea(stg, T.lake_zmin, T.bathy_y, T.bathy_a,
                            t_stg if with_t else None)
        inflow = rivin_l + sub_l + surf_l
        dlake = p_l - evap + inflow / ta
        if with_t:
            t_evap = _dmax0(inner, _dmin(e_l, avail, torch.zeros_like(t_stg),
                                         t_stg))
            t_inflow = (_list_sum(_W(to_lake, t_qriv_down, 0.0),
                                  T.riv_to_lake)
                        + _list_sum(t_lk_sub_e.reshape(-1), T.edge_to_lake)
                        + _list_sum(t_lk_surf_e.reshape(-1), T.edge_to_lake))
            t_dlake = -t_evap + (t_inflow * ta - inflow * t_ta) / (ta * ta)
    else:
        dlake = y.new_zeros(0)
        t_dlake = dlake

    # assembly (f_applyDY, MD_f.cpp:52-215)
    area, sy = c["area"], c["sy"]
    live = ~is_lake if nl > 0 else None

    def rows(v):
        return v if live is None else _W(live, v, 0.0)

    if not with_t:
        dsf = f["net_prcp"] - q_infil + q_exfil \
            - (e2r_surf + slot_sum(q_esurf)) / area - et["es"]
        dus = q_infil - q_rech - et["eu"] - et["tu"]
        dgw = q_rech - q_exfil - (e2r_sub + slot_sum(q_esub)) / area \
            - et["eg"] - et["tg"]
        dgw = _W(ci["ibc_pos"], 0.0, dgw)
        dgw = dgw + _W(ci["ibc_neg"], f["ele_qbc"] / area, 0.0)
        dsf = dsf + _W(ci["iss_pos"], f["ele_qss"] / area, 0.0)
        dgw = dgw + _W(ci["iss_neg"], f["ele_qss"] / area, 0.0)
        dus = dus / sy
        dgw = dgw / sy
        da_raw = (-q_riv_up - q_riv_surf - q_riv_sub - q_riv_down
                  + F.friv[1]) / rf["length"]
        d_area = torch.maximum(da_raw, -r_csa)
        driv, _ = _da_to_dy(d_area, r_topw, bs)
        driv = _W(riv_bcpos, 0.0, driv)
        if not want_diag:
            return torch.cat([rows(dsf), rows(dus), rows(dgw), driv, dlake])
        pj, va = 1.0 - c["imp_af"], c["veg_frac"]
        has_veg = f["lai"] > ZERO
        ic_dom = f["e_ic"] >= f["pot_tran"]
        e_ic_out = _W(has_veg, _W(ic_dom, f["pot_tran"] * pj * va,
                                  f["e_ic"]), 0.0)
        own_surf, own_sub = slot_sum(q_esurf), slot_sum(q_esub)
        ets = [et[k] for k in ("es", "eu", "eg", "tu", "tg")]
        if nl > 0:
            ets = [rows(v) for v in ets]
            e_ic_out, own_surf, own_sub = (rows(e_ic_out), rows(own_surf),
                                           rows(own_sub))
        parts = [q_rech, e2r_sub + own_sub, e2r_surf + own_surf, e2r_sub,
                 e2r_surf, q_infil, q_exfil, *ets, e_ic_out,
                 q_riv_up, q_riv_down, q_riv_sub, q_riv_surf]
        if nl > 0:
            parts += [ta, evap, p_l, rivin_l, surf_l, sub_l]
        return torch.cat(parts)

    t_dsf = -t_qinf + t_qexf - (t_e2r_surf + slot_sum(t_qesurf)) / area \
        - tet["es"]
    t_dus = t_qinf - t_qrech - tet["eu"] - tet["tu"]
    t_dgw = t_qrech - t_qexf - (t_e2r_sub + slot_sum(t_qesub)) / area \
        - tet["eg"] - tet["tg"]
    t_dgw = _W(ci["ibc_pos"], 0.0, t_dgw)
    t_dus = t_dus / sy
    t_dgw = t_dgw / sy
    da_raw = (-q_riv_up - q_riv_surf - q_riv_sub - q_riv_down
              + F.friv[1]) / rf["length"]
    t_da_raw = (-t_qriv_up - t_qriv_surf - t_qriv_sub - t_qriv_down) \
        / rf["length"]
    d_area = torch.maximum(da_raw, -r_csa)
    t_darea = _dmax(da_raw, -r_csa, t_da_raw, -t_csa)
    _, res_dy = _da_to_dy(d_area, r_topw, bs)
    t_driv = _da_to_dy_t(d_area, r_topw, t_darea, t_topw, res_dy)
    t_driv = _W(riv_bcpos, 0.0, t_driv)
    return torch.cat([rows(t_dsf), rows(t_dus), rows(t_dgw), t_driv, t_dlake])


def mega_rhs_plain(tables, forcing, y, close_boundary: bool):
    """Plain version of the RHS kernel: dY, flat ``[3Ne + Nr + Nl]``."""
    return _mega_core(tables, forcing, y, close_boundary)


def mega_jvp_plain(tables, forcing, y, ty, close_boundary: bool):
    """Plain version of the tangent kernel: J(y)·ty, flat."""
    return _mega_core(tables, forcing, y, close_boundary, ty=ty)


def mega_diag_plain(tables, forcing, y, close_boundary: bool):
    """Plain version of the diagnostics kernel: the DIAG_CELL, DIAG_RIV and
    (lake meshes) DIAG_LAKE fields, flat in that order."""
    return _mega_core(tables, forcing, y, close_boundary, want_diag=True)


def diag_size(tables) -> int:
    nlf = len(DIAG_LAKE) if tables.nl > 0 else 0
    return (len(DIAG_CELL) * tables.ne + len(DIAG_RIV) * tables.nr
            + nlf * tables.nl)


def diag_dict(tables, flat) -> dict:
    """Split the flat diagnostics into a dict of views."""
    out, off = {}, 0
    layout = [(DIAG_CELL, tables.ne), (DIAG_RIV, tables.nr)]
    if tables.nl > 0:
        layout.append((DIAG_LAKE, tables.nl))
    for keys, n in layout:
        for k in keys:
            out[k] = flat[off:off + n]
            off += n
    return out


# ---------------------------------------------------------------------------
# CUDA launch (csrc/mega.cu) and the solver's entry points
# ---------------------------------------------------------------------------

# the tables in the pointer order of csrc/mega.cu:make_args
_KERNEL_TABLES = ("cell_f", "cell_i", "edge_f", "edge_i", "seg_f", "seg_i",
                  "riv_f", "riv_i", "seg_to_ele", "seg_to_riv", "riv_up",
                  "edge_to_lake", "riv_to_lake", "lake_zmin", "bathy_y",
                  "bathy_a")
_FLOAT_TABLES = ("cell_f", "edge_f", "seg_f", "riv_f", "lake_zmin",
                 "bathy_y", "bathy_a")
# threads per block of the one-launch kernels (csrc/mega.cu kBlock)
FUSED_BLOCK = 128
# lake-list entries a round of stage C gathers, one a thread (csrc/mega.cu
# kChunk)
STAGE_C_CHUNK = FUSED_BLOCK


def _require(name, t, dev, dtype, shape):
    """Raise unless *t* is a contiguous *dtype* tensor on *dev* whose shape
    matches *shape* (None matches any length)."""
    if t.device != dev:
        raise ValueError(f"{name} on {t.device}, tables on {dev}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
    if t.dtype != dtype:
        raise ValueError(f"{name} is {t.dtype}, the kernel takes {dtype}")
    if len(t.shape) != len(shape) or any(
            w is not None and s != w for s, w in zip(t.shape, shape)):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, the kernel "
                         f"takes {shape}")


def _check_tables(t: MegaTables) -> None:
    """Refuse tables the kernels cannot read: every table on cell_f's
    device, contiguous, float32 or int32, of this mesh's shape."""
    ne, nr, ns, nl = t.ne, t.nr, t.ns, t.nl
    shapes = {
        "cell_f": (len(CELL_F), ne), "cell_i": (len(CELL_I), ne),
        "edge_f": (len(EDGE_F), ne, 3), "edge_i": (len(EDGE_I), ne, 3),
        "seg_f": (len(SEG_F), ns), "seg_i": (len(SEG_I), ns),
        "riv_f": (len(RIV_F), nr), "riv_i": (len(RIV_I), nr),
        "seg_to_ele": (ne, None), "seg_to_riv": (nr, None),
        "riv_up": (nr, None), "edge_to_lake": (nl, None),
        "riv_to_lake": (nl, None), "lake_zmin": (nl,),
        "bathy_y": (nl, None), "bathy_a": (nl, t.bathy_y.shape[-1])}
    dev = t.cell_f.device
    for name, shape in shapes.items():
        dtype = torch.float32 if name in _FLOAT_TABLES else torch.int32
        _require(name, getattr(t, name), dev, dtype, shape)


def _check_forcing(t: MegaTables, f: MegaForcing) -> None:
    """Refuse a packed forcing the kernels cannot read with these tables."""
    shapes = {"fcell": (len(FORC_CELL), t.ne), "friv": (len(FORC_RIV), t.nr),
              "segfu": (t.ns,), "flake": (2, t.nl)}
    for name, shape in shapes.items():
        _require(name, getattr(f, name), t.cell_f.device, torch.float32, shape)


def _check_states(t: MegaTables, *states) -> None:
    """What every call checks: each state float32 of length 3Ne + Nr + Nl,
    contiguous, on the tables' device."""
    n = 3 * t.ne + t.nr + t.nl
    for i, s in enumerate(states):
        _require(f"state{i}", s, t.cell_f.device, torch.float32, (n,))


def launch_plan(n_threads: int, sm_count: int, blocks_per_sm: int,
                block: int = FUSED_BLOCK) -> int:
    """Blocks of the one-launch kernels for *n_threads* (one per cell,
    reach and lake).  Their grid barrier needs every block resident at
    once, so a grid above ``sm_count * blocks_per_sm`` is refused: there is
    no fallback.  The kernels keep to 128 registers a thread, so an SM
    holds 65,536 / (128 x 128) = 4 blocks, and an H100's 132 SMs 67,584
    threads, above MAX_CELLS plus the reaches and lakes of the meshes the
    path takes."""
    blocks = -(-n_threads // block)
    if blocks > sm_count * blocks_per_sm:
        raise ValueError(
            f"{n_threads} threads in {blocks} blocks of {block} cannot be "
            f"resident at once: the card holds {blocks_per_sm} blocks on "
            f"each of {sm_count} SMs")
    return blocks


_OCCUPANCY: dict = {}


def occupancy(name: str) -> dict:
    """What the card holds of kernel *name* (a key of ``launch_counts``;
    csrc/mega.cu ``shud_mega_occupancy``), queried once: blocks per SM at
    FUSED_BLOCK threads, SMs, and the kernel's registers a thread."""
    if name not in _OCCUPANCY:
        out = (ctypes.c_int * 4)()
        # the kernel's number in csrc/mega.cu shud_mega_occupancy
        kernel = ("mega_rhs", "mega_jvp", "mega_diag").index(name)
        err = load_library().shud_mega_occupancy(kernel, out)
        if err != 0:
            raise RuntimeError(f"occupancy query failed: CUDA error {err}")
        if not out[2]:
            raise RuntimeError("the card has no cooperative launch")
        _OCCUPANCY[name] = dict(blocks_per_sm=out[0], sm_count=out[1],
                                registers=out[3])
    return _OCCUPANCY[name]


def _kernel_dims(t: MegaTables) -> list:
    return [t.ne, t.nr, t.ns, t.nl, t.seg_to_ele.shape[1],
            t.seg_to_riv.shape[1], t.riv_up.shape[1], t.edge_to_lake.shape[1],
            t.riv_to_lake.shape[1], t.bathy_y.shape[1]]


class _LaunchState:
    """What one MegaTables on the card keeps for its kernel calls, made at
    the first call: the library's entry points, one scratch buffer (the
    calls run in order on torch's current stream, so they can share it),
    each kernel's dims array (the grid from launch_plan last), the pointer
    array of the forcing bound last (tables, forcing, state, tangent,
    output, scratch, launch counter, stage C's clock), whose state,
    tangent, output, counter and clock slots each call fills in, and on a
    lake mesh stage C's clock: ``lake_ns`` [3, Nl] int64, a row per kernel
    (``launch_counts``' order), each lake's nanoseconds summed over the
    calls made while ``trace`` is on (``lake_stage_ns``).

    A captured window (``solver/graph.py``) keeps the pointers of its
    capture: the forcing it binds is the window's static buffers, which
    every window refills, and the one scratch buffer is shared safely by
    the replays because they run in order on one stream, as the eager
    calls do."""

    def __init__(self, t: MegaTables):
        _check_tables(t)
        lib = load_library()
        dims = _kernel_dims(t)
        self.fns = {k: getattr(lib, f"shud_{k}") for k in launch_counts}
        self.scratch = torch.empty(lib.shud_mega_scratch_floats(*dims[:4]),
                                   dtype=torch.float32, device=t.cell_f.device)
        n_threads = t.ne + t.nr + t.nl
        self.dims = {}
        for name in launch_counts:
            occ = occupancy(name)
            grid = launch_plan(n_threads, occ["sm_count"],
                               occ["blocks_per_sm"])
            for cb in (False, True):
                self.dims[name, cb] = (ctypes.c_int * 12)(*dims, cb, grid)
        self.forcing = None
        self.ptrs = None
        self.lake_ns = (torch.zeros((len(launch_counts), t.nl),
                                    dtype=torch.int64, device=t.cell_f.device)
                        if t.nl > 0 else None)
        self.clock = {name: (0 if self.lake_ns is None
                             else self.lake_ns[k].data_ptr())
                      for k, name in enumerate(launch_counts)}

    def bind(self, t: MegaTables, forcing: MegaForcing) -> None:
        _check_forcing(t, forcing)
        tensors = [getattr(t, n) for n in _KERNEL_TABLES] + list(forcing)
        self.ptrs = (ctypes.c_void_p * 26)(
            *[v.data_ptr() for v in tensors], 0, 0, 0, self.scratch.data_ptr(),
            0, 0)
        self.forcing = forcing


def _launch_state(t: MegaTables) -> _LaunchState:
    st = t.__dict__.get("_launch")
    if st is None:
        st = t._launch = _LaunchState(t)
    return st


def _launch_direct(name, t, forcing, y, ty, close_boundary, n_out):
    """One kernel call: the states checked, the cached pointers and
    scratch, three pointers set (and stage C's clock while ``trace`` is
    on), one C call."""
    _check_states(t, *((y,) if ty is y else (y, ty)))
    st = _launch_state(t)
    if st.forcing is not forcing:
        st.bind(t, forcing)
    out = y.new_empty(n_out)
    p = st.ptrs
    p[20], p[21], p[22] = y.data_ptr(), ty.data_ptr(), out.data_ptr()
    p[24] = _counts.pointer(name, y.device)
    p[25] = st.clock[name] if trace.enabled() else 0
    err = st.fns[name](p, st.dims[name, bool(close_boundary)],
                       torch.cuda.current_stream(y.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    launch_counts[name] += 1
    return out


def lake_stage_ns(tables) -> "dict | None":
    """Stage C's clock of *tables* on the card: for each kernel
    (``launch_counts``' names) each lake's nanoseconds from the second
    grid barrier to its last write, summed over the calls made while
    ``trace`` is on since the last ``reset_lake_stage`` (a captured call
    keeps the clock of its capture); None on a lake-free mesh or before
    the tables' first call on the card."""
    st = tables.__dict__.get("_launch")
    if st is None or st.lake_ns is None:
        return None
    rows = st.lake_ns.tolist()
    return {name: rows[k] for k, name in enumerate(launch_counts)}


def reset_lake_stage(tables) -> None:
    """Zero stage C's clock of *tables* (in stream order)."""
    st = tables.__dict__.get("_launch")
    if st is not None and st.lake_ns is not None:
        st.lake_ns.zero_()


def mega_rhs(tables, forcing, y, close_boundary: bool):
    """dY of the flat state ``[3Ne + Nr + Nl]``: one kernel launch."""
    if on_cpu(y, tables.cell_f, what="mega kernels"):
        return mega_rhs_plain(tables, forcing, y, close_boundary)
    return _launch_direct("mega_rhs", tables, forcing, y, y, close_boundary,
                          y.shape[0])


def mega_jvp(tables, forcing, y, ty, close_boundary: bool):
    """J(y)·ty, flat: one launch of the tangent kernel."""
    if on_cpu(y, ty, tables.cell_f, what="mega kernels"):
        return mega_jvp_plain(tables, forcing, y, ty, close_boundary)
    return _launch_direct("mega_jvp", tables, forcing, y, ty, close_boundary,
                          y.shape[0])


def mega_diag(tables, forcing, y, close_boundary: bool):
    """The diagnostics, flat (``diag_dict`` splits them): one kernel
    launch."""
    if on_cpu(y, tables.cell_f, what="mega kernels"):
        return mega_diag_plain(tables, forcing, y, close_boundary)
    return _launch_direct("mega_diag", tables, forcing, y, y, close_boundary,
                          diag_size(tables))


def rhs_mega(tables, forcing, y, close_boundary: bool, kernel: bool = True):
    """dY through the RHS kernel.  *kernel* False runs its plain version,
    on the card too: the reference path the kernels are held against.
    Refused inside a ``torch.func`` transform, on every device: J·v is
    ``linearize_mega``'s; and where autograd would record
    (``edge.kernels_may_run``)."""
    if not kernels_may_run(y):
        raise RuntimeError("rhs_mega takes no torch.func transform: its "
                           "J·v is linearize_mega's hand tangent")
    fn = mega_rhs if kernel else mega_rhs_plain
    return fn(tables, forcing, y, close_boundary)


def linearize_mega(tables, forcing, y, close_boundary: bool,
                   kernel: bool = True):
    """What one Newton iteration needs at *y*, as ``jax.linearize`` gives
    the JAX solver (``shud_tpu/solver/bdf.py:174``) through the megakernel's
    custom JVP rule (``pallas_mega.py:1547-1570``): dY from one RHS call,
    and a function that gives J(y)·v from one tangent call per Krylov
    vector, outside any ``torch.func`` transform: dY is ``rhs_mega``'s and
    J·v ``mega_jvp``'s.  *kernel* False: the plain versions."""
    rhs_fn, jvp_fn = ((mega_rhs, mega_jvp) if kernel
                      else (mega_rhs_plain, mega_jvp_plain))
    fy = rhs_fn(tables, forcing, y, close_boundary)
    return fy, lambda v: jvp_fn(tables, forcing, y, v, close_boundary)


def rhs_mega_diag(tables, forcing, y, close_boundary: bool,
                  kernel: bool = True) -> dict:
    """The window diagnostics as a dict of flat tensors (DIAG_CELL [Ne],
    DIAG_RIV [Nr], DIAG_LAKE [Nl] on lake meshes), one kernel call (or,
    with *kernel* False, the plain version)."""
    fn = mega_diag if kernel else mega_diag_plain
    return diag_dict(tables, fn(tables, forcing, y, close_boundary))
