"""Sharded RHS: one rank's share of dY/dt under the domain decomposition.

The counterpart of ``shud_tpu/parallel/sharded.py``.  Each rank owns one
cell block and one reach block of the partition (``partition.py``); lakes
are replicated.  Communication per RHS evaluation rides the partition's
K edge-coloured rounds (``ExchangePlan``), each round one exchange with one
neighbour rank (``comm.Group.ppermute_round``):

* forward: (sf, gw, effKH) of exported boundary cells and the stage of
  reaches that remote segments or remote upstream reaches reference;
* reverse: per-remote-reach flux partials (Qsurf, Qsub, Qup) sent back to
  the reach's owner, added there through fixed-width gather lists (the
  distributed counterpart of the reference's ``PassValue`` reduction,
  MD_f.cpp:217-257).

Per-lake sums are completed with ``comm.psum``.  The physics is the
single-device port's (``core/rhs.py``).  The lateral edge stencil of a
rank is one call of the edge trio (``core/edge.py``) over the rank's cell
block with the cell ghost buffer appended (``[Np + Gc]`` rows, the ghost
rows masked out): local and cross-shard edges in one call, lake banks
merged by mask as ``rhs.edge_fluxes`` merges them.

``linearize`` is the solver's hook, a hand linearization as
``rhs.linearize`` is on one device (``torch.func.jvp`` cannot trace a
send or a receive): one primal with ``edge_coeff`` per Newton iteration,
then per Krylov vector one ``edge_apply``, one forward halo of the
tangents of (sf, gw, effKH) and stage, one reverse halo of the partial
tangents and, with lakes, one ``psum``, on the primal's rounds.
"""

from __future__ import annotations

import types
from typing import NamedTuple

import numpy as np
import torch

from shud_tpu_torch.config import GRAV, ZERO
from shud_tpu_torch.core import edge as edge_mod
from shud_tpu_torch.core import physics as ph
from shud_tpu_torch.core.device import (
    EdgeTables, _fixed_width_lists, gather_sum)
from shud_tpu_torch.core.physics import maximum
from shud_tpu_torch.core.rhs import (
    _cell_update_lin, _lake_toparea, _lake_toparea_lin, _vertical_lin,
    edge_fluxes, et_flux, flux_infiltration, flux_recharge, lake_cell_update,
    update_element)
from shud_tpu_torch.core.state import ForcingSlice
from shud_tpu_torch.parallel.comm import Group
from shud_tpu_torch.parallel.partition import ShardedMesh

# the window diagnostics, as the JAX package's sharded diag_fn returns them
DIAG_CELL = ("q_infil", "q_exfil", "q_rech", "q_surf_tot", "q_sub_tot",
             "q_e2r_surf", "q_e2r_sub", "es", "eu", "eg", "tu", "tg", "e_ic")
DIAG_EDGE = ("q_esurf", "q_esub")
DIAG_RIV = ("q_riv_surf", "q_riv_sub", "q_riv_down", "q_riv_up")
DIAG_LAKE = ("q_lake_evap", "q_lake_prcp", "q_lake_surf", "q_lake_sub",
             "q_lake_rivin", "lake_area")


class StateGroup:
    """What the solver needs of a sharded state (``solver/bdf._dot``): the
    rank's group, the length of its cell and reach blocks at the head of
    the local state (the replicated lakes follow), and the global padded
    size (the JAX package's ``tsize``: 3·P·Np + P·Rp + Nl)."""

    def __init__(self, group: Group, n_blocks: int, size: int):
        self.group = group
        self.n_blocks = n_blocks
        self.size = size

    def psum(self, x):
        return self.group.psum(x)


class _Lists(NamedTuple):
    """Fixed-width gather lists of one rank's reductions."""

    seg_to_riv: torch.Tensor   # local segments -> local reaches
    seg_to_ele: torch.Tensor   # segments -> their cells
    seg_to_gr: torch.Tensor    # segments of remote reaches -> ghost slots
    riv_to_down: torch.Tensor  # local down-links -> local reaches
    riv_to_gr: torch.Tensor    # remote down-links -> ghost slots
    rev: list                  # per round: received partials -> reaches
    cell_to_lake: torch.Tensor = None
    edge_to_lake: torch.Tensor = None
    riv_to_lake: torch.Tensor = None


class _EdgeView(NamedTuple):
    """What ``rhs.edge_fluxes`` reads, over the cell block with the ghost
    rows appended (``[Np + Gc]`` rows)."""

    edge_tables: EdgeTables
    edge_kernel: bool
    nb: torch.Tensor        # [Np+Gc,3] neighbour row, 0 where none
    has_lake: torch.Tensor  # [Np+Gc,3] lake-bank edge
    lk: torch.Tensor        # [Np+Gc,3] lake id, 0 where none
    edge: torch.Tensor      # [Np+Gc,3] edge length
    dist_nb: torch.Tensor   # [Np+Gc,3] dist2nabor, 1.0 off-neighbour
    edge_lake_dzl: torch.Tensor
    edge_lake_dzb: torch.Tensor


def _pad_rows(a: np.ndarray, n: int, fill) -> np.ndarray:
    pad = np.full((n,) + a.shape[1:], fill, dtype=a.dtype)
    return np.concatenate([a, pad])


class ShardRHS:
    """One rank's RHS over its blocks of the partition *sm*.

    The local state is one flat tensor ``[sf(Np), us(Np), gw(Np),
    riv(Rp), lake(Nl)]``; the forcing slice holds the rank's cell block
    ([Np]) and reach block ([Rp]).  ``edge_kernel``: ``"auto"`` runs the
    CUDA edge trio exactly when the run is float32 on CUDA, ``False`` their
    plain versions."""

    def __init__(self, sm: ShardedMesh, group: Group, dtype: torch.dtype,
                 close_boundary: bool = True,
                 edge_kernel: "bool | str" = "auto"):
        if group.size != sm.p:
            raise ValueError(
                f"partition has {sm.p} shards but the group has "
                f"{group.size} rank(s) (one rank per shard)")
        device = group.device
        on_card = dtype == torch.float32 and device.type == "cuda"
        if edge_kernel == "auto":
            edge_kernel = on_card
        if edge_kernel and not on_card:
            raise ValueError(
                "the edge-flux kernels need float32 on a CUDA device")
        q = group.rank
        self.group = group
        self.dtype, self.device = dtype, device
        self.close_boundary = bool(close_boundary)
        self.plan = plan = sm.plan
        self.np_cells, self.nr_riv = npc, nrr = sm.np_cells, sm.nr_riv
        self.nl = nl = sm.num_lake
        self.n_blocks = 3 * npc + nrr
        self.state_group = StateGroup(group, self.n_blocks,
                                      sm.p * self.n_blocks + nl)
        gc = plan.g_cell

        def t(a, dt=None):
            a = np.asarray(a)
            if dt is None:
                dt = {"b": torch.bool, "i": torch.long,
                      "u": torch.long}.get(a.dtype.kind, dtype)
            return torch.as_tensor(a, device=device).to(dt).contiguous()

        # ---- cells: MeshData names on the rank's block (_CellView) ----
        cell = {k: t(v[q]) for k, v in sm.cell.items()}
        self.m = types.SimpleNamespace(**cell, num_lake=nl)
        valid = sm.valid[q]
        self.valid = cell["valid"]
        self.fvalid = self.valid.to(dtype)
        self.seg = {k: t(v[q]) for k, v in sm.seg.items()}
        self.riv = {k: t(v[q]) for k, v in sm.riv.items()}
        self.rvalid = self.riv["valid"]
        self.frvalid = self.rvalid.to(dtype)
        halo = sm.halo
        self.cell_send = [t(halo["cell_send"][q, k, :plan.s_cell[k]])
                          for k in range(plan.k)]
        self.riv_send = [t(halo["riv_send"][q, k, :plan.s_riv[k]])
                         for k in range(plan.k)]

        # ---- the edge stencil over [Np + Gc] rows ----
        ed = sm.edge
        has_nb = ed["has_nb"][q]
        remote = halo["nb_remote"][q]
        ext_nb = np.where(remote, npc + halo["nb_gpos"][q], halo["nb_local"][q])
        lakenabr = (sm.lake["lakenabr"][q] if nl > 0
                    else np.full((npc, 3), -1, np.int64))
        has_lake = lakenabr >= 0
        m_int = has_nb & ~has_lake
        m_bnd = ~has_nb & ~has_lake & valid[:, None]
        dist2nabor = ed["dist2nabor"][q]

        def rows(a, fill):
            return _pad_rows(np.asarray(a), gc, fill)

        et = EdgeTables(
            nabr=t(rows(np.where(m_int, ext_nb, -1), -1), torch.int32),
            nb=t(rows(np.where(m_int, ext_nb, 0), 0)),
            edge=t(rows(ed["edge"][q], 0.0)),
            dist=t(rows(np.where(m_int, dist2nabor, 1.0), 1.0)),
            avg_rough=t(rows(ed["avg_rough"][q], 1.0)),
            dzs=t(rows(ed["dz_surf"][q], 0.0)),
            dzb=t(rows(ed["dz_bottom"][q], 0.0)),
            d2e=t(rows(ed["dist2edge"][q], 1.0)),
            m_int=t(rows(m_int, False), torch.uint8),
            m_bnd=t(rows(m_bnd, False), torch.uint8),
            dep=t(rows(sm.cell["depression"][q], 0.0)),
            rough=t(rows(sm.cell["rough"][q], 1.0)),
        )
        zeros3 = np.zeros((npc, 3))
        self.ev = _EdgeView(
            edge_tables=et, edge_kernel=bool(edge_kernel),
            nb=t(rows(np.where(has_nb, ext_nb, 0), 0)),
            has_lake=t(rows(has_lake, False)),
            lk=t(rows(np.where(has_lake, lakenabr, 0), 0)),
            edge=et.edge,
            dist_nb=t(rows(np.where(has_nb, dist2nabor, 1.0), 1.0)),
            edge_lake_dzl=t(rows(sm.lake["dzl"][q] if nl else zeros3, 0.0)),
            edge_lake_dzb=t(rows(sm.lake["dzb"][q] if nl else zeros3, 0.0)),
        )
        self.has_lake = self.ev.has_lake[:npc]
        self.has_nb = t(has_nb)
        self.edge_kernel = bool(edge_kernel)

        # ---- fixed-width gather lists of the local reductions ----
        sg, rv = sm.seg, sm.riv
        sval, sloc = sg["valid"][q], sg["riv_local"][q]
        ns = sval.shape[0]
        rval = rv["valid"][q]
        hd, dloc = rv["has_down"][q], rv["down_local"][q]
        gr = plan.g_riv

        def fw(targets, n, pad):
            return t(_fixed_width_lists(targets, n, pad))

        lists = dict(
            seg_to_riv=fw(np.where(sval & sloc, sg["riv_slot"][q], -1),
                          nrr, ns),
            seg_to_ele=fw(np.where(sval, sg["ele_slot"][q], -1), npc, ns),
            seg_to_gr=fw(np.where(sval & ~sloc, sg["riv_gpos"][q], -1),
                         gr, ns),
            riv_to_down=fw(np.where(rval & hd & dloc, rv["down_slot"][q],
                                    -1), nrr, nrr),
            riv_to_gr=fw(np.where(rval & hd & ~dloc, rv["down_gpos"][q],
                                  -1), gr, nrr),
            rev=[fw(halo["riv_send"][q, k, :plan.s_riv[k]], nrr,
                    plan.s_riv[k]) for k in range(plan.k)],
        )
        if nl > 0:
            i_lake = sm.cell["i_lake"][q]
            lists.update(
                cell_to_lake=fw(np.where((i_lake > 0) & valid, i_lake - 1,
                                         -1), nl, npc),
                edge_to_lake=fw(lakenabr.ravel(), nl, 3 * npc),
                riv_to_lake=fw(np.where(rval & (rv["riv_to_lake"][q] >= 0),
                                        rv["riv_to_lake"][q], -1), nl, nrr),
            )
            lk = sm.lake
            self.lake_view = types.SimpleNamespace(
                lake_zmin=t(lk["zmin"]), lake_bathy_y=t(lk["bathy_y"]),
                lake_bathy_a=t(lk["bathy_a"]))
            self.lake_num_ele = t(lk["num_ele"])
        self.lists = _Lists(**lists)

    # ------------------------------------------------------------------
    # state and forcing layout

    def split(self, y):
        npc, nrr = self.np_cells, self.nr_riv
        return (y[:npc], y[npc:2 * npc], y[2 * npc:3 * npc],
                y[3 * npc:3 * npc + nrr], y[3 * npc + nrr:])

    def local_state(self, ys: dict) -> torch.Tensor:
        """This rank's flat state from ``partition.shard_state``'s blocks."""
        q = self.group.rank
        return torch.as_tensor(np.concatenate(
            [ys["sf"][q], ys["us"][q], ys["gw"][q], ys["riv"][q],
             ys["lake"]]), device=self.device).to(self.dtype)

    def forcing_slice(self, cell: dict, riv: dict) -> ForcingSlice:
        """A ``ForcingSlice`` from the rank's forcing blocks ([Np] cell
        fields, [Rp] reach fields)."""
        return ForcingSlice(**{k: cell[k] for k in (
            "net_prcp", "prcp", "pot_evap", "pot_tran", "e_ic", "lai",
            "fu_surf", "fu_sub", "ele_ybc", "ele_qbc", "ele_qss")},
            riv_ybc=riv["riv_ybc"], riv_qbc=riv["riv_qbc"])

    # ------------------------------------------------------------------
    # the halo

    def _forward(self, cells: torch.Tensor, stage: torch.Tensor):
        """Forward halo: (cell ghost [Gc,3], reach ghost [Gr]) of the
        exported rows of *cells* [Np,3] and entries of *stage* [Rp]."""
        plan, g = self.plan, self.group
        gc_parts, gr_parts = [], []
        for k in range(plan.k):
            sc, sr = plan.s_cell[k], plan.s_riv[k]
            if not (sc or sr):
                continue
            send = torch.cat([cells[self.cell_send[k]].reshape(-1),
                              stage[self.riv_send[k]]])
            recv = g.ppermute_round(send, plan.perms[k])
            if sc:
                gc_parts.append(recv[:3 * sc].reshape(sc, 3))
            if sr:
                gr_parts.append(recv[3 * sc:])
        ghost_c = (torch.cat(gc_parts) if gc_parts
                   else cells.new_zeros(1, 3))
        ghost_r = torch.cat(gr_parts) if gr_parts else stage.new_zeros(1)
        return ghost_c, ghost_r

    def _reverse(self, partials: torch.Tensor) -> torch.Tensor:
        """Reverse halo: per-remote-reach partials [Gr,3] back to their
        owners; returns the [Rp,3] sums this rank received."""
        plan = self.plan
        acc = partials.new_zeros(self.nr_riv, 3)
        for k in range(plan.k):
            sr = plan.s_riv[k]
            if not sr:
                continue
            off = plan.off_riv[k]
            recv = self.group.ppermute_round(
                partials[off:off + sr].contiguous(), plan.rev_perms[k])
            acc = acc + gather_sum(recv, self.lists.rev[k])
        return acc

    # ------------------------------------------------------------------
    # the RHS

    def rhs(self, t, y, fs: ForcingSlice):
        return self._rhs(fs, y)[0]

    def rhs_full(self, t, y, fs: ForcingSlice):
        """(dy, the window diagnostics): the JAX package's sharded
        ``diag_fn`` fields, cell [Np], edge [Np,3], reach [Rp], lake [Nl]
        (complete on every rank)."""
        dy, diag, _ = self._rhs(fs, y)
        return dy, diag

    def _rhs(self, fs: ForcingSlice, y, coeffs: "list | None" = None):
        m, ev, lists, riv = self.m, self.ev, self.lists, self.riv
        npc, nl = self.np_cells, self.nl
        sf, us, gw_raw, riv_y, lake_stg = self.split(y)
        gw = torch.where(m.i_bc > 0, fs.ele_ybc, gw_raw)
        riv_stage = torch.where(riv["riv_bc"] > 0, fs.riv_ybc, riv_y)
        bs, bw = riv["riv_bank_slope"], riv["riv_bottom_width"]
        r_topw = maximum(riv_stage * bs * 2.0 + bw, 0.0)
        r_csa = maximum(riv_stage * (bw + riv_stage * bs), 0.0)
        r_per = maximum(2.0 * ph.absolute(riv_stage) * torch.sqrt(1.0 + bs**2)
                        + bw, 0.0)

        cu = update_element(m, sf, us, gw)
        if nl > 0:
            cu = lake_cell_update(m, cu)
            is_lake_cell = m.i_lake > 0
        es, eu, eg, tu, tg, e_ic_out, ibeta = et_flux(m, fs, sf, us, gw,
                                                      cu.satn)
        qi, qex = flux_infiltration(m, cu, sf, us, gw, fs.net_prcp)
        q_infil = qi * fs.fu_surf
        q_exfil = qex * fs.fu_surf
        q_rech = flux_recharge(m, cu, us, gw) * fs.fu_sub
        if nl > 0:
            q_infil = torch.where(is_lake_cell, 0.0, q_infil)
            q_exfil = torch.where(is_lake_cell, 0.0, q_exfil)
            q_rech = torch.where(is_lake_cell, 0.0, q_rech)
            es = torch.where(is_lake_cell, 0.0, es)
            eu = torch.where(is_lake_cell, 0.0, eu)
            eg = torch.where(is_lake_cell, 0.0, eg)
            tu = torch.where(is_lake_cell, 0.0, tu)
            tg = torch.where(is_lake_cell, 0.0, tg)

        # ---- forward halo, then the edge trio over [Np + Gc] rows ----
        ghost_c, ghost_r = self._forward(
            torch.stack([sf, gw, cu.eff_kh], dim=-1), riv_stage)
        sf_x = torch.cat([sf, ghost_c[:, 0]])
        gw_x = torch.cat([gw, ghost_c[:, 1]])
        kh_x = torch.cat([cu.eff_kh, ghost_c[:, 2]])
        q_esurf, q_esub0, lk_surf_e, lk_sub_e = (
            v[:npc] for v in edge_fluxes(
                ev, types.SimpleNamespace(eff_kh=kh_x), sf_x, gw_x, lake_stg,
                self.close_boundary, False, coeffs))
        q_esub = q_esub0 * fs.fu_sub[:, None]
        if nl > 0:
            lc = is_lake_cell[:, None]
            q_esurf = torch.where(lc, 0.0, q_esurf)
            q_esub = torch.where(lc, 0.0, q_esub)
            lk_surf_e = torch.where(lc, 0.0, lk_surf_e)
            lk_sub_e = torch.where(lc, 0.0, lk_sub_e)

        # ---- segments: local elements, stage local or from the halo ----
        sg = self.seg
        se, sval, sloc = sg["ele_slot"], sg["valid"], sg["riv_local"]
        seg_stage = torch.where(sloc, riv_stage[sg["riv_slot"]],
                                ghost_r[sg["riv_gpos"]])
        seg_isf_raw = sf[se] - q_infil[se] + q_exfil[se]
        seg_isf = maximum(seg_isf_raw, 0.0)
        zero_e = torch.zeros_like(seg_isf)
        q_seg_surf = ph.weir_flow_jtoi(
            zero_e, seg_isf, -sg["rdepth"], seg_stage, zero_e, sg["cwr"],
            sg["length"], m.depression[se])
        q_seg_sub = ph.flux_r2e_gw(
            seg_stage, m.aq_depth[se] - sg["rdepth"], gw[se], zero_e,
            cu.eff_kh[se], sg["rksat"], sg["length"], sg["rbed"],
        ) * fs.fu_sub[se]
        q_seg_surf = torch.where(sval, q_seg_surf, 0.0)
        q_seg_sub = torch.where(sval, q_seg_sub, 0.0)

        # ---- the river chain: owner-computed, downstream stage local or
        # from the halo ----
        has_down = riv["has_down"]
        to_lake = riv["riv_to_lake"] >= 0
        stage_dn = torch.where(riv["down_local"],
                               riv_stage[riv["down_slot"]],
                               ghost_r[riv["down_gpos"]])
        s_mean = 0.5 * (riv["riv_bed_slope"] + riv["down_bedslope"])
        s_down = ((riv_stage - riv["riv_depth"])
                  - (stage_dn - riv["down_depth"])) / riv["riv_dist2down"] \
            + s_mean
        small = r_per <= ZERO
        r_hyd = torch.where(small, 0.0,
                            r_csa / torch.where(small, 1.0, r_per))
        rough = riv["riv_avg_rough"]
        q_down_int = ph.manning_equation(r_csa, rough, r_hyd, s_down)
        s_out = riv["riv_bed_slope"] + riv_stage * 2.0 / riv["riv_length"]
        q_out_zdg = ph.manning_equation(r_csa, rough, r_hyd, s_out)
        q_out_crit = (r_csa * torch.sqrt(GRAV * maximum(riv_stage, 1e-30))
                      * 60.0)
        q_riv_down = torch.where(to_lake, q_out_zdg, torch.where(
            has_down, q_down_int,
            torch.where(riv["riv_outlet_code"] == -4, q_out_crit,
                        q_out_zdg)))
        q_riv_down = torch.where(self.rvalid, q_riv_down, 0.0)

        # ---- local reductions, then the reverse halo ----
        q_riv_surf = gather_sum(q_seg_surf, lists.seg_to_riv)
        q_riv_sub = gather_sum(q_seg_sub, lists.seg_to_riv)
        q_e2r_surf = gather_sum(-q_seg_surf, lists.seg_to_ele)
        q_e2r_sub = gather_sum(-q_seg_sub, lists.seg_to_ele)
        q_riv_up = gather_sum(-q_riv_down, lists.riv_to_down)
        partials = torch.stack([
            gather_sum(q_seg_surf, lists.seg_to_gr),
            gather_sum(q_seg_sub, lists.seg_to_gr),
            gather_sum(-q_riv_down, lists.riv_to_gr)], dim=-1)
        recv = self._reverse(partials)
        q_riv_surf = q_riv_surf + recv[:, 0]
        q_riv_sub = q_riv_sub + recv[:, 1]
        q_riv_up = q_riv_up + recv[:, 2]

        # ---- assembly ----
        area = m.area
        q_surf_tot = q_e2r_surf + q_esurf.sum(dim=1)
        q_sub_tot = q_e2r_sub + q_esub.sum(dim=1)
        dsf = fs.net_prcp - q_infil + q_exfil - q_surf_tot / area - es
        dus = q_infil - q_rech - eu - tu
        dgw = q_rech - q_exfil - q_sub_tot / area - eg - tg
        dgw = torch.where(m.i_bc > 0, 0.0, dgw)
        dgw = dgw + torch.where(m.i_bc < 0, fs.ele_qbc / area, 0.0)
        dsf = dsf + torch.where(m.i_ss > 0, fs.ele_qss / area, 0.0)
        dgw = dgw + torch.where(m.i_ss < 0, fs.ele_qss / area, 0.0)
        dus = dus / m.sy
        dgw = dgw / m.sy
        if nl > 0:
            dsf = torch.where(is_lake_cell, 0.0, dsf)
            dus = torch.where(is_lake_cell, 0.0, dus)
            dgw = torch.where(is_lake_cell, 0.0, dgw)
        dsf = torch.where(self.valid, dsf, 0.0)
        dus = torch.where(self.valid, dus, 0.0)
        dgw = torch.where(self.valid, dgw, 0.0)

        d_area_raw = (-q_riv_up - q_riv_surf - q_riv_sub - q_riv_down
                      + fs.riv_qbc) / riv["riv_length"]
        d_area = torch.maximum(d_area_raw, -r_csa)
        driv = ph.fun_da_to_dy(d_area, r_topw, bs)
        driv = torch.where(riv["riv_bc"] > 0, 0.0, driv)
        driv = torch.where(self.rvalid, driv, 0.0)

        # ---- lakes: replicated, per-lake sums completed over the ranks
        # (MD_f.cpp:180-191) ----
        saved_lake = {}
        if nl > 0:
            lk_cell = torch.where(is_lake_cell, m.i_lake - 1, 0)
            inv_nele = 1.0 / maximum(self.lake_num_ele.to(y.dtype), 1.0)
            part = torch.stack([
                gather_sum(torch.where(is_lake_cell,
                                       fs.pot_evap * inv_nele[lk_cell], 0.0),
                           lists.cell_to_lake),
                gather_sum(torch.where(is_lake_cell,
                                       fs.prcp * inv_nele[lk_cell], 0.0),
                           lists.cell_to_lake),
                gather_sum(lk_surf_e.reshape(-1), lists.edge_to_lake),
                gather_sum(lk_sub_e.reshape(-1), lists.edge_to_lake),
                gather_sum(q_riv_down, lists.riv_to_lake)])
            (q_lake_evap_raw, q_lake_prcp, q_lake_surf, q_lake_sub,
             q_lake_rivin) = self.group.psum(part)
            q_lake_evap = maximum(
                torch.minimum(q_lake_evap_raw, q_lake_prcp + lake_stg), 0.0)
            lake_area = _lake_toparea(self.lake_view, lake_stg)
            dlake = q_lake_prcp - q_lake_evap + (
                q_lake_rivin + q_lake_sub + q_lake_surf) / lake_area
            saved_lake = dict(
                q_lake_evap_raw=q_lake_evap_raw, q_lake_prcp=q_lake_prcp,
                q_lake_rivin=q_lake_rivin, q_lake_surf=q_lake_surf,
                q_lake_sub=q_lake_sub, lake_area=lake_area)
        else:
            dlake = lake_stg.new_zeros(0)
            q_lake_evap = q_lake_prcp = q_lake_surf = q_lake_sub = dlake
            q_lake_rivin = lake_area = dlake

        dy = torch.cat([dsf, dus, dgw, driv, dlake])
        diag = dict(
            q_infil=q_infil, q_exfil=q_exfil, q_rech=q_rech,
            q_esurf=q_esurf, q_esub=q_esub,
            q_surf_tot=q_surf_tot, q_sub_tot=q_sub_tot,
            q_riv_surf=q_riv_surf, q_riv_sub=q_riv_sub,
            q_riv_down=q_riv_down, q_riv_up=q_riv_up,
            q_e2r_surf=q_e2r_surf, q_e2r_sub=q_e2r_sub,
            es=es, eu=eu, eg=eg, tu=tu, tg=tg, e_ic=e_ic_out,
            q_lake_evap=q_lake_evap, q_lake_prcp=q_lake_prcp,
            q_lake_surf=q_lake_surf, q_lake_sub=q_lake_sub,
            q_lake_rivin=q_lake_rivin, lake_area=lake_area,
        )
        saved = dict(
            sf=sf, us=us, gw=gw, riv_stage=riv_stage, lake_stg=lake_stg,
            cu=cu, kh_x=kh_x, ibeta=ibeta, r_topw=r_topw, r_csa=r_csa,
            r_per=r_per, r_hyd=r_hyd, s_down=s_down, s_out=s_out,
            seg_stage=seg_stage, seg_isf=seg_isf, seg_isf_raw=seg_isf_raw,
            d_area_raw=d_area_raw, d_area=d_area, **saved_lake)
        return dy, diag, saved

    # ------------------------------------------------------------------
    # the hand linearization

    def linearize(self, t, y, fs: ForcingSlice):
        """``(rhs(y), v -> J(y)·v)``, the solver's hook: one primal with
        the coefficient kernel per Newton iteration, then per vector one
        ``edge_apply`` and the tangent halos (module docstring)."""
        coeffs = []
        dy, _, saved = self._rhs(fs, y, coeffs)
        return dy, self._tangent(fs, saved, coeffs)

    def _tangent(self, fs: ForcingSlice, s: dict, coeffs: list):
        m, ev, lists, riv = self.m, self.ev, self.lists, self.riv
        npc, nl = self.np_cells, self.nl
        sf, us, gw, rs, cu = s["sf"], s["us"], s["gw"], s["riv_stage"], s["cu"]
        dtype = sf.dtype
        keep_gw = (m.i_bc <= 0).to(dtype)  # a head BC fixes gw
        keep_rs = (riv["riv_bc"] <= 0).to(dtype)

        # ---- cells: the 3x3 local Jacobian of (dsf, dus, dgw) ----
        c = _cell_update_lin(m, sf, us, gw)
        v = _vertical_lin(m, fs, sf, us, gw, cu, s["ibeta"], c)
        qi, qx, qr = v["qi"], v["qx"], v["qr"]
        keep_cell = self.fvalid
        if nl > 0:
            is_lake_cell = m.i_lake > 0
            keep_cell = keep_cell * (~is_lake_cell).to(dtype)
        inv_sy = keep_cell / m.sy
        bc_sy = keep_gw * inv_sy
        lj = {}
        for x in ("sf", "us", "gw"):
            lj["s" + x] = (-qi[x] + qx[x] - v["es"][x]) * keep_cell
            lj["u" + x] = (qi[x] - qr[x] - v["eu"][x] - v["tu"][x]) * inv_sy
            lj["g" + x] = (qr[x] - qx[x] - v["eg"][x] - v["tg"][x]) * bc_sy
        a_surf = -keep_cell / m.area
        a_sub = -bc_sy / m.area
        kh_gw = c["kh_gw"]

        # ---- lake-bank edges, merged by mask ----
        if nl > 0:
            has_lake, lk = self.has_lake, ev.lk[:npc]
            nb = ev.nb[:npc]
            B, dist = ev.edge[:npc], ev.dist_nb[:npc]
            isf = maximum(sf, 0.0)[:, None]
            lake_nb = s["lake_stg"][lk]
            lake_nsf = maximum(lake_nb, 0.0)
            c_y0, c_yj = ph.weir_flow_jtoi_local_lin(
                lake_nsf + ev.edge_lake_dzl[:npc], isf, lake_nsf, 0.6, B,
                0.01)
            ls_sf = c_yj * ph.d_max(sf, 0.0)[:, None]
            ls_lk = c_y0 * ph.d_max(lake_nb, 0.0)
            gw_col = gw[:, None]
            dh = (gw_col - lake_nb) + ev.edge_lake_dzb[:npc]
            ym = ph.avg_y_gw(gw_col, lake_nb)
            grad = dh / dist
            km = 0.5 * (cu.eff_kh[:, None] + s["kh_x"][nb])
            live = ~(((dh > 0.0) & (gw_col <= 0.02))
                     | ((dh < 0.0) & (lake_nb <= 0.02)))
            half_k = torch.where(live, 0.5 * grad * ym * B, 0.0)
            lb_gw = torch.where(live, (km / dist * ym + km * grad * 0.5
                                       * ph.d_max(gw, 0.0)[:, None]) * B,
                                0.0) + half_k * kh_gw[:, None]
            lb_lk = torch.where(live, (-km / dist * ym + km * grad * 0.5
                                       * ph.d_max(lake_nb, 0.0)) * B, 0.0)
            lake_edge = has_lake & ~is_lake_cell[:, None]

        # ---- segments ----
        sg = self.seg
        se, sval, sloc = sg["ele_slot"], sg["valid"], sg["riv_local"]
        fsval = sval.to(dtype)
        zero_e = torch.zeros_like(s["seg_isf"])
        w_i, w_j = ph.weir_flow_jtoi_lin(
            zero_e, s["seg_isf"], -sg["rdepth"], s["seg_stage"], zero_e,
            sg["cwr"], sg["length"], m.depression[se])
        w_i = w_i * ph.d_max(s["seg_isf_raw"], 0.0) * fsval
        w_j = w_j * fsval
        b_sf = w_i * (1.0 - qi["sf"] + qx["sf"])[se]
        b_us = w_i * (-qi["us"] + qx["us"])[se]
        b_gw = w_i * (-qi["gw"] + qx["gw"])[se]
        r_yr, r_ye, r_k = ph.flux_r2e_gw_lin(
            s["seg_stage"], m.aq_depth[se] - sg["rdepth"], gw[se], zero_e,
            cu.eff_kh[se], sg["rksat"], sg["length"], sg["rbed"])
        fu_seg = fs.fu_sub[se] * fsval
        sb_rs = r_yr * fu_seg
        sb_gw = (r_ye + r_k * kh_gw[se]) * fu_seg

        # ---- reaches ----
        bs, bw = riv["riv_bank_slope"], riv["riv_bottom_width"]
        topw_rs = ph.d_max(rs * bs * 2.0 + bw, 0.0) * (bs * 2.0)
        csa_rs = ph.d_max(rs * (bw + rs * bs), 0.0) * (bw + 2.0 * rs * bs)
        root = torch.sqrt(1.0 + bs**2)
        per_rs = (ph.d_max(2.0 * ph.absolute(rs) * root + bw, 0.0)
                  * 2.0 * ph.d_abs(rs) * root)
        r_csa, r_per, r_hyd = s["r_csa"], s["r_per"], s["r_hyd"]
        small = r_per <= ZERO
        psafe = torch.where(small, 1.0, r_per)
        hyd_rs = torch.where(small, 0.0, (csa_rs - r_hyd * per_rs) / psafe)
        rough = riv["riv_avg_rough"]
        has_down = riv["has_down"]
        ma, mr, ms = ph.manning_equation_lin(r_csa, rough, r_hyd, s["s_down"])
        int_dn = -ms / riv["riv_dist2down"]
        int_self = ma * csa_rs + mr * hyd_rs - int_dn
        za, zr, zs = ph.manning_equation_lin(r_csa, rough, r_hyd, s["s_out"])
        zdg = za * csa_rs + zr * hyd_rs + zs * 2.0 / riv["riv_length"]
        sq = torch.sqrt(GRAV * maximum(rs, 1e-30))
        crit = (csa_rs * sq + r_csa * (GRAV * ph.d_max(rs, 1e-30))
                / (2.0 * sq)) * 60.0
        to_lake = riv["riv_to_lake"] >= 0
        p_self = torch.where(to_lake, zdg, torch.where(
            has_down, int_self,
            torch.where(riv["riv_outlet_code"] == -4, crit, zdg)))
        p_self = p_self * self.frvalid
        p_dn = torch.where(~to_lake & has_down, int_dn, 0.0) * self.frvalid
        da_raw, floor = s["d_area_raw"], -r_csa
        f_da, f_w = ph.fun_da_to_dy_lin(s["d_area"], s["r_topw"], bs)
        keep_r = keep_rs * self.frvalid
        dr_area = keep_r * f_da * ph.d_max(da_raw, floor) / riv["riv_length"]
        dr_rs = keep_r * (f_w * topw_rs
                          - f_da * ph.d_max(floor, da_raw) * csa_rs)

        # ---- lakes ----
        if nl > 0:
            lake_stg = s["lake_stg"]
            ev_raw, prcp = s["q_lake_evap_raw"], s["q_lake_prcp"]
            y_cap = prcp + lake_stg
            evap_lk = (ph.d_max(torch.minimum(ev_raw, y_cap), 0.0)
                       * ph.d_min(y_cap, ev_raw))
            area = s["lake_area"]
            inflow = s["q_lake_rivin"] + s["q_lake_sub"] + s["q_lake_surf"]
            inv_area = 1.0 / area
            c_lk = -evap_lk - inflow / (area * area) * _lake_toparea_lin(
                self.lake_view, lake_stg)

        apply = (edge_mod.edge_apply if self.edge_kernel
                 else edge_mod.edge_apply_plain)
        et, fu_sub = ev.edge_tables, fs.fu_sub
        down_local = riv["down_local"]

        def jvp(vec):
            tsf = vec[:npc]
            tus = vec[npc:2 * npc]
            tgw = vec[2 * npc:3 * npc] * keep_gw
            trs = vec[3 * npc:3 * npc + self.nr_riv] * keep_rs
            tkh = kh_gw * tgw
            # the forward halo of the tangents, on the primal's rounds
            gt_c, gt_r = self._forward(torch.stack([tsf, tgw, tkh], dim=-1),
                                       trs)
            tsf_x = torch.cat([tsf, gt_c[:, 0]])
            tgw_x = torch.cat([tgw, gt_c[:, 1]])
            tkh_x = torch.cat([tkh, gt_c[:, 2]])
            tqs, tqb = (v_[:npc] for v_ in apply(coeffs, tsf_x, tgw_x, tkh_x,
                                                 et))
            if nl > 0:
                tlk = vec[self.n_blocks:]
                tl = tlk[lk]
                tqs = torch.where(has_lake, ls_sf * tsf[:, None] + ls_lk * tl,
                                  tqs)
                tqb = torch.where(has_lake, lb_gw * tgw[:, None]
                                  + half_k * tkh_x[nb] + lb_lk * tl, tqb)
            t_stage = torch.where(sloc, trs[sg["riv_slot"]],
                                  gt_r[sg["riv_gpos"]])
            t_ss = (b_sf * tsf[se] + b_us * tus[se] + b_gw * tgw[se]
                    + w_j * t_stage)
            t_sb = sb_rs * t_stage + sb_gw * tgw[se]
            t_surf = tqs.sum(dim=1) - gather_sum(t_ss, lists.seg_to_ele)
            t_sub = fu_sub * tqb.sum(dim=1) - gather_sum(t_sb,
                                                         lists.seg_to_ele)
            tdsf = lj["ssf"] * tsf + lj["sus"] * tus + lj["sgw"] * tgw \
                + a_surf * t_surf
            tdus = lj["usf"] * tsf + lj["uus"] * tus + lj["ugw"] * tgw
            tdgw = lj["gsf"] * tsf + lj["gus"] * tus + lj["ggw"] * tgw \
                + a_sub * t_sub
            t_dn = torch.where(down_local, trs[riv["down_slot"]],
                               gt_r[riv["down_gpos"]])
            t_down = p_self * trs + p_dn * t_dn
            # the reverse halo of the partial tangents
            recv = self._reverse(torch.stack([
                gather_sum(t_ss, lists.seg_to_gr),
                gather_sum(t_sb, lists.seg_to_gr),
                gather_sum(-t_down, lists.riv_to_gr)], dim=-1))
            t_up = gather_sum(-t_down, lists.riv_to_down) + recv[:, 2]
            t_area = (-t_up - (gather_sum(t_ss, lists.seg_to_riv)
                               + recv[:, 0])
                      - (gather_sum(t_sb, lists.seg_to_riv) + recv[:, 1])
                      - t_down)
            tdriv = dr_area * t_area + dr_rs * trs
            parts = [tdsf, tdus, tdgw, tdriv]
            if nl > 0:
                t_in = self.group.psum(
                    gather_sum(t_down, lists.riv_to_lake)
                    + gather_sum(torch.where(lake_edge, tqb, 0.0).reshape(-1),
                                 lists.edge_to_lake)
                    + gather_sum(torch.where(lake_edge, tqs, 0.0).reshape(-1),
                                 lists.edge_to_lake))
                parts.append(t_in * inv_area + c_lk * tlk)
            return torch.cat(parts)

        return jvp


def state_blocks(sm: ShardedMesh, flats) -> dict:
    """The ranks' flat local states (host arrays, in rank order) as
    ``partition.shard_state``'s blocks (the lakes from rank 0)."""
    npc, nrr = sm.np_cells, sm.nr_riv
    a = np.stack([np.asarray(f) for f in flats])
    return {"sf": a[:, :npc], "us": a[:, npc:2 * npc],
            "gw": a[:, 2 * npc:3 * npc], "riv": a[:, 3 * npc:3 * npc + nrr],
            "lake": a[0, 3 * npc + nrr:]}
