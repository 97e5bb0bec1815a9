# Copied verbatim from shud_tpu/parallel/partition.py; only the package
# imports differ, and the TPU's banded per-shard edge blocks
# (_build_shard_edge_blocks) are left out: edge_blocks stays None.
"""Mesh domain decomposition for multi-chip execution.

The reference's only parallelism is OpenMP threads over flat arrays
(``src/ModelData/MD_f_omp.cpp``); there is no distributed mode to port.  The
TPU design follows SURVEY §5.7: partition the unstructured cell graph into P
spatially-compact blocks (recursive coordinate bisection on centroids),
shard every cell-axis array over a 1-D device mesh, and exchange one ghost
ring of dynamic per-cell values per RHS evaluation.

Communication design (SURVEY §5.8): the halo is **neighbour-wise** — the
shard adjacency graph is edge-coloured into K rounds, and each round is one
``lax.ppermute`` in which every shard sends one packed boundary block to one
neighbour shard.  Per-device payload is O(edge-cut of this shard), not
O(P·B) as an ``all_gather`` would be, so the exchange volume stays constant
under weak scaling.  The river network is partitioned too (each reach owned
by the shard holding the majority of its segments' elements): segment→river
sums and the downstream-routing reduction (`PassValue`,
``src/ModelData/MD_f.cpp:217-257``) are owner-computed locally, and only
values crossing a cut — remote-reach stages forward, per-remote-reach flux
partials backward — travel in the same K ppermute rounds.  Lakes remain
replicated (Nlake is tiny) with ``psum``-completed per-lake reductions.

Static neighbour quantities (z_surf, z_bottom, rough, downstream river
depth/bed-slope, per-segment river parameters) are pre-baked into per-edge /
per-segment / per-reach arrays so only (sf, gw, effKH) and river stage
travel in the halo.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from shud_tpu_torch.core.mesh import MeshData


def rcb_partition(x: np.ndarray, y: np.ndarray, p: int) -> np.ndarray:
    """Recursive coordinate bisection -> part id per cell.  p must be a
    power of two; parts are balanced to within one cell."""
    assert p & (p - 1) == 0, "P must be a power of two"
    n = len(x)
    part = np.zeros(n, dtype=np.int64)

    def split(idx, lo, hi):
        if hi - lo == 1:
            part[idx] = lo
            return
        xs, ys = x[idx], y[idx]
        if xs.max() - xs.min() >= ys.max() - ys.min():
            key = xs
        else:
            key = ys
        order = np.argsort(key, kind="stable")
        half = len(idx) // 2
        mid = (lo + hi) // 2
        split(idx[order[:half]], lo, mid)
        split(idx[order[half:]], mid, hi)

    split(np.arange(n), 0, p)
    return part


@dataclasses.dataclass
class ExchangePlan:
    """Static neighbour-wise exchange schedule (closed over at trace time).

    Round k is one ``ppermute`` whose permutation is ``perms[k]``; shard s
    packs ``s_cell[k]`` cell-export slots (3 values each: sf, gw, effKH)
    and ``s_riv[k]`` river-stage slots.  The receiver lays round k's block
    at offset ``off_cell[k]`` / ``off_riv[k]`` of its flat ghost buffers.
    The reverse (flux-partial) exchange reuses the same rounds with
    ``rev_perms`` and 3 values per river slot (Qsurf, Qsub, Qup partials).
    """

    k: int
    perms: list
    rev_perms: list
    s_cell: list
    s_riv: list
    off_cell: list
    off_riv: list
    g_cell: int  # total cell ghost slots (>= 1)
    g_riv: int  # total river ghost slots (>= 1)
    b_merged: int = 0  # max merged per-shard cell export count (the B an
    # all_gather halo would ship from EVERY shard to every device)

    def bytes_per_eval(self, itemsize: int = 8) -> int:
        """Per-device halo payload of one RHS evaluation (send side; the
        receive volume is identical by symmetry of the round schedule)."""
        fwd_cell = sum(self.s_cell) * 3 * itemsize
        fwd_riv = sum(self.s_riv) * itemsize
        rev_riv = sum(self.s_riv) * 3 * itemsize
        return fwd_cell + fwd_riv + rev_riv

    def allgather_bytes_per_eval(self, p: int, itemsize: int = 8) -> int:
        """What the round-1 all_gather design would move per device per
        eval: every device receives every shard's padded export block."""
        return p * self.b_merged * 3 * itemsize


def _greedy_rounds(pairs):
    """Directed edge colouring: split (src, dst) pairs into rounds where
    each shard sends to at most one destination and receives from at most
    one source — the validity condition of ``lax.ppermute``."""
    rounds = []
    remaining = sorted(pairs)
    while remaining:
        used_s, used_d = set(), set()
        this, rest = [], []
        for s, d in remaining:
            if s not in used_s and d not in used_d:
                this.append((s, d))
                used_s.add(s)
                used_d.add(d)
            else:
                rest.append((s, d))
        rounds.append(this)
        remaining = rest
    return rounds


def _group_imports(src, dst, slot, p):
    """(src, dst, slot) triples -> {(s, d): sorted unique slot array}:
    the list of s-local slots that shard d imports from shard s."""
    src = np.asarray(src, np.int64)
    if len(src) == 0:
        return {}
    trip = np.unique(
        np.stack(
            [src, np.asarray(dst, np.int64), np.asarray(slot, np.int64)],
            axis=1,
        ),
        axis=0,
    )
    keys = trip[:, 0] * p + trip[:, 1]
    bounds = np.flatnonzero(np.diff(keys)) + 1
    return {
        (int(c[0, 0]), int(c[0, 1])): np.ascontiguousarray(c[:, 2])
        for c in np.split(trip, bounds)
    }


def _gpos(groups, round_of, off, qsrc, qdst, qslot):
    """Flat ghost-buffer position of each (src, dst, slot) query."""
    out = np.zeros(len(qsrc), np.int64)
    for (s, d), slots in groups.items():
        m = (qsrc == s) & (qdst == d)
        if m.any():
            out[m] = off[round_of[(s, d)]] + np.searchsorted(slots, qslot[m])
    return out


@dataclasses.dataclass
class ShardedMesh:
    """Per-shard mesh arrays, leading axis = shard (P)."""

    p: int
    np_cells: int  # padded cells per shard
    ns_seg: int  # padded segments per shard
    nr_riv: int  # padded reaches per shard
    num_ele: int  # total active cells
    num_riv: int
    num_lake: int

    # permutation: new global id -> old id, and inverse
    perm: np.ndarray
    inv_perm: np.ndarray
    old_to_shard: np.ndarray  # [Ne] owner shard per original cell id
    old_to_slot: np.ndarray  # [Ne] local slot per original cell id
    valid: np.ndarray  # [P, Np] bool
    riv_owner: np.ndarray  # [Nr] owner shard per original reach id
    riv_slot_of: np.ndarray  # [Nr] local slot per original reach id

    # per-cell params (all [P, Np])
    cell: dict
    # per-edge static neighbour data ([P, Np, 3])
    edge: dict
    # per-shard segment arrays ([P, Sp])
    seg: dict
    # river arrays (sharded, [P, Rp])
    riv: dict
    # halo tables (per-shard send lists + per-edge ghost positions)
    halo: dict
    # static exchange schedule
    plan: ExchangePlan
    # lakes (replicated small tables + sharded per-edge lake ids)
    lake: dict = dataclasses.field(default_factory=dict)
    # the JAX package's per-shard banded Pallas edge blocks (a TPU layout):
    # never built here, always None
    edge_blocks: object = None


_CELL_FIELDS = [
    "area", "z_surf", "z_bottom", "aq_depth", "wetland_level",
    "rootreach_level", "macpore_level", "inf_ksat_v", "theta_s", "theta_fc",
    "theta_r", "alpha", "beta", "h_area_f", "mac_ksat_v", "inf_d", "ksat_h",
    "ksat_v", "geo_v_area_f", "mac_ksat_h", "mac_d", "sy", "veg_frac",
    "albedo", "rough", "rz_d", "imp_af", "depression", "fix_pressure",
    "wind_h", "nx", "ny", "nz",
]
_CELL_INT_FIELDS = ["i_bc", "i_ss", "i_lake", "i_forc", "i_lc", "i_mf"]
_EDGE_FIELDS = ["edge", "dist2edge", "dist2nabor", "avg_rough"]
_RIV_FIELDS = [
    "riv_outlet_code", "riv_to_lake", "riv_bc", "riv_length",
    "riv_bed_slope", "riv_depth", "riv_bank_slope", "riv_bottom_width",
    "riv_rough", "riv_cwr", "riv_ksat_h", "riv_bed_thick", "riv_avg_rough",
    "riv_dist2down",
]
# padded-lane fill values that keep the padded river math finite (the
# results are masked by `valid`; these only avoid 0/0)
_RIV_PAD = {
    "riv_length": 1.0, "riv_dist2down": 1.0, "riv_avg_rough": 1.0,
    "riv_rough": 1.0, "riv_bed_thick": 1.0, "riv_bottom_width": 1.0,
    "riv_to_lake": -1, "riv_outlet_code": -1,
}


def _shard_rcm_slots(md: MeshData, part: np.ndarray, p: int,
                     tile_cells: "int | None" = None):
    """Per-shard Reverse Cuthill–McKee local slots: minimise each shard's
    induced-subgraph bandwidth so the Pallas edge kernel's banded-window
    precondition holds per shard with the smallest possible block size.

    ``tile_cells``: when set, each shard is RCB-split into tiles of about
    that many cells and RCM runs PER TILE (tiles concatenated in RCB
    order).  A planar mesh's bandwidth grows as sqrt(cells) — at the
    10M-cell single-chip design point the full-shard RCM band reaches
    ~2.3k (37 kernel row-shift iterations); per-tile RCM caps the
    kernel-visible band at ~2*sqrt(tile_cells) and routes the O(cut)
    inter-tile edges through the compact local-remainder list instead
    (the same treatment cross-shard edges already get).

    Returns ``(old_to_slot, tile_of)``; ``tile_of`` is the per-cell tile
    id within its shard (all zeros when untiled)."""
    from shud_tpu_torch.utils.reorder import rcm_permutation

    ne = md.num_ele
    nabr = np.asarray(md.nabr)
    old_to_slot = np.zeros(ne, dtype=np.int64)
    tile_of = np.zeros(ne, dtype=np.int64)
    for q in range(p):
        cells = np.flatnonzero(part == q)
        if tile_cells and len(cells) > tile_cells:
            nt = 1 << int(np.ceil(np.log2(len(cells) / tile_cells)))
            tpart = rcb_partition(
                np.asarray(md.x)[cells], np.asarray(md.y)[cells], nt)
            tile_of[cells] = tpart
            off = 0
            for tq in range(nt):
                tloc = np.flatnonzero(tpart == tq)
                sub_cells = cells[tloc]  # ascending (flatnonzero order)
                nb = nabr[sub_cells]
                pos = np.searchsorted(sub_cells, np.maximum(nb, 0))
                pos = np.minimum(pos, len(sub_cells) - 1)
                in_tile = (nb >= 0) & (sub_cells[pos] == nb)
                sub = np.where(in_tile, pos, -1)
                perm_t = rcm_permutation(sub)  # perm[new_local] = old_local
                s = np.empty(len(sub_cells), dtype=np.int64)
                s[perm_t] = np.arange(len(sub_cells))
                old_to_slot[sub_cells] = off + s
                off += len(sub_cells)
        else:
            g2l = np.full(ne, -1, dtype=np.int64)
            g2l[cells] = np.arange(len(cells))
            sub = np.where(nabr[cells] >= 0,
                           g2l[np.maximum(nabr[cells], 0)], -1)
            perm_q = rcm_permutation(sub)  # perm[new_local] = old_local
            slot_of = np.empty(len(cells), dtype=np.int64)
            slot_of[perm_q] = np.arange(len(cells))
            old_to_slot[cells] = slot_of
    return old_to_slot, tile_of


def build_sharded_mesh(md: MeshData, p: int,
                       shard_order: str = "keep",
                       tile_cells: "int | None" = None) -> ShardedMesh:
    """``shard_order``: local slot numbering within each shard —
    ``"keep"`` (induced global order; bitwise-stable with prior rounds) or
    ``"rcm"`` (per-shard Reverse Cuthill–McKee, required for the Pallas
    edge kernel on meshes whose global numbering is not banded).

    ``tile_cells`` (rcm only): per-tile RCM numbering — bounds the edge
    kernel's band at large single-shard cell counts; inter-tile edges are
    evaluated on a compact local-remainder list (see _shard_rcm_slots)."""
    ne = md.num_ele
    part = rcb_partition(md.x, md.y, p)
    sizes = np.bincount(part, minlength=p)
    np_cells = int(sizes.max())
    offs = np.zeros(p + 1, dtype=np.int64)
    offs[1:] = np.cumsum(sizes)

    # map old cell id -> (shard, local slot)
    old_to_shard = part.astype(np.int64)
    tile_of = np.zeros(ne, dtype=np.int64)
    if shard_order == "rcm":
        old_to_slot, tile_of = _shard_rcm_slots(md, part, p,
                                                tile_cells=tile_cells)
    else:
        # induced global order: slot = rank of old id within its shard
        perm0 = np.lexsort((np.arange(ne), part))  # new -> old
        local_slot = np.empty(ne, dtype=np.int64)
        for q in range(p):
            local_slot[offs[q] : offs[q + 1]] = np.arange(sizes[q])
        old_to_slot = np.empty(ne, dtype=np.int64)
        old_to_slot[perm0] = local_slot
    # perm/inv_perm: new global id = shard offset + local slot
    new_id = offs[old_to_shard] + old_to_slot
    perm = np.empty(ne, dtype=np.int64)  # new -> old
    perm[new_id] = np.arange(ne)
    inv_perm = new_id.copy()

    valid = np.zeros((p, np_cells), dtype=bool)
    for q in range(p):
        valid[q, : sizes[q]] = True

    def scatter_cell(arr, fill=0.0):
        out = np.full((p, np_cells), fill, dtype=np.asarray(arr).dtype)
        out[old_to_shard, old_to_slot] = np.asarray(arr)
        return out

    cell = {f: scatter_cell(getattr(md, f)) for f in _CELL_FIELDS}
    for f in _CELL_INT_FIELDS:
        cell[f] = scatter_cell(getattr(md, f), fill=0)
    # benign padding: avoid /0 in padded lanes
    for f in ["area", "sy", "aq_depth", "inf_d", "theta_s", "rough",
              "fix_pressure", "wind_h", "beta", "theta_fc"]:
        cell[f] = np.where(valid, cell[f], 1.0)
    cell["beta"] = np.where(valid, cell["beta"], 2.0)
    cell["theta_r"] = np.where(valid, cell["theta_r"], 0.1)
    cell["theta_s"] = np.where(valid, cell["theta_s"], 0.5)
    cell["theta_fc"] = np.where(valid, cell["theta_fc"], 0.375)
    cell["valid"] = valid

    edge = {f: np.zeros((p, np_cells, 3)) for f in _EDGE_FIELDS}
    for f in _EDGE_FIELDS:
        edge[f][old_to_shard, old_to_slot] = getattr(md, f)
    edge["dist2nabor"] = np.where(edge["dist2nabor"] == 0.0, 1.0,
                                  edge["dist2nabor"])
    edge["dist2edge"] = np.where(edge["dist2edge"] == 0.0, 1.0,
                                 edge["dist2edge"])
    edge["avg_rough"] = np.where(edge["avg_rough"] == 0.0, 1.0,
                                 edge["avg_rough"])
    # static per-edge elevation differences (local-datum form shared with
    # the single-chip fast path)
    has_nb = md.nabr >= 0
    for name, src in [("dz_surf", md.edge_dz_surf),
                      ("dz_bottom", md.edge_dz_bottom)]:
        buf = np.zeros((p, np_cells, 3))
        buf[old_to_shard, old_to_slot] = src
        edge[name] = buf
    hasnb_buf = np.zeros((p, np_cells, 3), dtype=bool)
    hasnb_buf[old_to_shard, old_to_slot] = has_nb
    edge["has_nb"] = hasnb_buf

    # ---- river ownership: majority vote of segment-element owners ----
    nrv = md.num_riv
    votes = np.zeros((max(nrv, 1), p), dtype=np.int64)
    np.add.at(votes, (md.seg_riv, old_to_shard[md.seg_ele]), 1)
    riv_owner = votes.argmax(axis=1)[:nrv]
    orphan = votes.sum(axis=1)[:nrv] == 0
    # orphan reaches (no segments) follow their downstream owner
    for _ in range(64):
        if not orphan.any():
            break
        dn = np.where(md.riv_down >= 0, md.riv_down, 0)
        fixable = orphan & (md.riv_down >= 0) & ~orphan[dn]
        if not fixable.any():
            break
        riv_owner[fixable] = riv_owner[dn[fixable]]
        orphan = orphan & ~fixable

    riv_sizes = np.bincount(riv_owner, minlength=p)
    nr_riv = max(1, int(riv_sizes.max()))
    riv_slot_of = np.empty(max(nrv, 1), dtype=np.int64)
    riv_perm = np.lexsort((np.arange(nrv), riv_owner))
    roffs = np.zeros(p + 1, dtype=np.int64)
    roffs[1:] = np.cumsum(riv_sizes)
    for q in range(p):
        riv_slot_of[riv_perm[roffs[q] : roffs[q + 1]]] = np.arange(
            riv_sizes[q]
        )
    riv_slot_of = riv_slot_of[:nrv]
    rvalid = np.zeros((p, nr_riv), dtype=bool)
    for q in range(p):
        rvalid[q, : riv_sizes[q]] = True

    # ---- import lists: cells ----
    ii = np.repeat(np.arange(ne), 3)
    nn = md.nabr.ravel()
    ok = nn >= 0
    cross = np.zeros(ne * 3, dtype=bool)
    cross[ok] = old_to_shard[nn[ok]] != old_to_shard[ii[ok]]
    cell_groups = _group_imports(
        old_to_shard[nn[cross]], old_to_shard[ii[cross]],
        old_to_slot[nn[cross]], p,
    )

    # ---- import lists: river stages ----
    # (a) segments whose river lives on another shard than their element
    seg_dst = old_to_shard[md.seg_ele]
    seg_src = riv_owner[md.seg_riv]
    seg_cross = seg_src != seg_dst
    # (b) down-links crossing shards (need downstream stage for the slope)
    hd = md.riv_down >= 0
    up_ids = np.flatnonzero(hd)
    dn_ids = md.riv_down[up_ids]
    link_src = riv_owner[dn_ids]
    link_dst = riv_owner[up_ids]
    link_cross = link_src != link_dst
    riv_groups = _group_imports(
        np.concatenate([seg_src[seg_cross], link_src[link_cross]]),
        np.concatenate([seg_dst[seg_cross], link_dst[link_cross]]),
        np.concatenate([
            riv_slot_of[md.seg_riv[seg_cross]],
            riv_slot_of[dn_ids[link_cross]],
        ]),
        p,
    )

    # ---- round schedule over the union pair graph ----
    pairs = sorted(set(cell_groups) | set(riv_groups))
    rounds = _greedy_rounds(pairs)
    k_rounds = len(rounds)
    round_of = {pr: k for k, rnd in enumerate(rounds) for pr in rnd}
    s_cell = [
        max((len(cell_groups[pr]) for pr in rnd if pr in cell_groups),
            default=0)
        for rnd in rounds
    ]
    s_riv = [
        max((len(riv_groups[pr]) for pr in rnd if pr in riv_groups),
            default=0)
        for rnd in rounds
    ]
    off_cell = np.concatenate([[0], np.cumsum(s_cell)]).tolist()
    off_riv = np.concatenate([[0], np.cumsum(s_riv)]).tolist()
    merged_sets = {}
    for (s, _d), slots in cell_groups.items():
        merged_sets.setdefault(s, set()).update(slots.tolist())
    b_merged = max((len(v) for v in merged_sets.values()), default=0)
    plan = ExchangePlan(
        k=k_rounds,
        perms=[list(rnd) for rnd in rounds],
        rev_perms=[[(d, s) for (s, d) in rnd] for rnd in rounds],
        s_cell=s_cell, s_riv=s_riv,
        off_cell=off_cell[:-1], off_riv=off_riv[:-1],
        g_cell=max(1, int(off_cell[-1])),
        g_riv=max(1, int(off_riv[-1])),
        b_merged=b_merged,
    )

    # ---- per-shard send tables ----
    sc_max = max(1, max(s_cell, default=0))
    sr_max = max(1, max(s_riv, default=0))
    kk = max(1, k_rounds)
    cell_send = np.zeros((p, kk, sc_max), dtype=np.int64)
    riv_send = np.zeros((p, kk, sr_max), dtype=np.int64)
    for k, rnd in enumerate(rounds):
        for pr in rnd:
            s, _d = pr
            cl = cell_groups.get(pr)
            if cl is not None:
                cell_send[s, k, : len(cl)] = cl
            rl = riv_groups.get(pr)
            if rl is not None:
                riv_send[s, k, : len(rl)] = rl

    # ---- per-edge neighbour tables ----
    nb_remote_flat = cross.reshape(ne, 3)
    nb_local_flat = np.where(ok & ~cross, old_to_slot[np.where(nn >= 0, nn, 0)],
                             0).reshape(ne, 3)
    gq = _gpos(
        cell_groups, round_of, plan.off_cell,
        old_to_shard[nn[cross]], old_to_shard[ii[cross]],
        old_to_slot[nn[cross]],
    )
    nb_gpos_flat = np.zeros(ne * 3, dtype=np.int64)
    nb_gpos_flat[cross] = gq
    nb_gpos_flat = nb_gpos_flat.reshape(ne, 3)

    def scatter_edge_tbl(arr, dtype):
        out = np.zeros((p, np_cells, 3), dtype=dtype)
        out[old_to_shard, old_to_slot] = arr
        return out

    halo = {
        "cell_send": cell_send,
        "riv_send": riv_send,
        "nb_remote": scatter_edge_tbl(nb_remote_flat, bool),
        "nb_local": scatter_edge_tbl(nb_local_flat, np.int64),
        "nb_gpos": scatter_edge_tbl(nb_gpos_flat, np.int64),
    }

    # ---- compact cross-shard edge lists (Pallas-mode XLA remainder) ------
    # The per-shard edge kernel evaluates local-interior and open-boundary
    # edges; the O(edge-cut) remainder — cross-shard edges (+ lake banks,
    # below) — is evaluated on these compact lists and mask-merged, so no
    # dense [Np,3] neighbour gather remains in the kernel path.
    ci = ii[cross]          # old cell id of each cross edge
    cj = (np.arange(ne * 3) % 3)[cross]
    c_shard = old_to_shard[ci]
    rmt_counts = np.bincount(c_shard, minlength=p)
    eb_max = max(1, int(rmt_counts.max()) if len(ci) else 1)
    rmt = {
        "cell": np.zeros((p, eb_max), np.int64),
        "slot": np.zeros((p, eb_max), np.int64),
        "gpos": np.zeros((p, eb_max), np.int64),
        "B": np.zeros((p, eb_max)),
        "dist": np.ones((p, eb_max)),
        "ravg": np.ones((p, eb_max)),
        "dzs": np.zeros((p, eb_max)),
        "dzb": np.zeros((p, eb_max)),
        "dep": np.zeros((p, eb_max)),
        "valid": np.zeros((p, eb_max), bool),
    }
    if len(ci):
        order_r = np.argsort(c_shard, kind="stable")
        rq = c_shard[order_r]
        rj = np.arange(len(ci)) - np.concatenate(
            [[0], np.cumsum(rmt_counts)])[rq]
        cio, cjo = ci[order_r], cj[order_r]
        rmt["cell"][rq, rj] = old_to_slot[cio]
        rmt["slot"][rq, rj] = cjo
        rmt["gpos"][rq, rj] = nb_gpos_flat[cio, cjo]
        rmt["B"][rq, rj] = md.edge[cio, cjo]
        rmt["dist"][rq, rj] = np.where(
            md.dist2nabor[cio, cjo] == 0.0, 1.0, md.dist2nabor[cio, cjo])
        rmt["ravg"][rq, rj] = np.maximum(md.avg_rough[cio, cjo], 1e-20)
        rmt["dzs"][rq, rj] = md.edge_dz_surf[cio, cjo]
        rmt["dzb"][rq, rj] = md.edge_dz_bottom[cio, cjo]
        rmt["dep"][rq, rj] = md.depression[cio]
        rmt["valid"][rq, rj] = True
    halo.update({f"rmt_{k}": v for k, v in rmt.items()})

    # ---- compact lake-bank edge lists (Pallas-mode lake branch) ----------
    lakenb_flat = np.asarray(md.lakenabr).ravel()
    lcross = lakenb_flat >= 0
    li = ii[lcross]
    lj = (np.arange(ne * 3) % 3)[lcross]
    l_shard = old_to_shard[li]
    lk_counts = np.bincount(l_shard, minlength=p)
    lb_max = max(1, int(lk_counts.max()) if len(li) else 1)
    lke = {
        "cell": np.zeros((p, lb_max), np.int64),
        "slot": np.zeros((p, lb_max), np.int64),
        "lake": np.zeros((p, lb_max), np.int64),
        "nb_remote": np.zeros((p, lb_max), bool),
        "nb_local": np.zeros((p, lb_max), np.int64),
        "nb_gpos": np.zeros((p, lb_max), np.int64),
        "B": np.zeros((p, lb_max)),
        "dist": np.ones((p, lb_max)),
        "dzl": np.zeros((p, lb_max)),
        "dzb": np.zeros((p, lb_max)),
        "contrib": np.zeros((p, lb_max), bool),  # bank cell (not lake cell)
        "valid": np.zeros((p, lb_max), bool),
    }
    if len(li):
        order_l = np.argsort(l_shard, kind="stable")
        lq = l_shard[order_l]
        lj2 = np.arange(len(li)) - np.concatenate(
            [[0], np.cumsum(lk_counts)])[lq]
        lio, ljo = li[order_l], lj[order_l]
        lke["cell"][lq, lj2] = old_to_slot[lio]
        lke["slot"][lq, lj2] = ljo
        lke["lake"][lq, lj2] = md.lakenabr[lio, ljo]
        lke["nb_remote"][lq, lj2] = nb_remote_flat[lio, ljo]
        lke["nb_local"][lq, lj2] = nb_local_flat[lio, ljo]
        lke["nb_gpos"][lq, lj2] = nb_gpos_flat[lio, ljo]
        lke["B"][lq, lj2] = md.edge[lio, ljo]
        lke["dist"][lq, lj2] = np.where(
            md.dist2nabor[lio, ljo] == 0.0, 1.0, md.dist2nabor[lio, ljo])
        lke["dzl"][lq, lj2] = md.edge_lake_dzl[lio, ljo]
        lke["dzb"][lq, lj2] = md.edge_lake_dzb[lio, ljo]
        lke["contrib"][lq, lj2] = np.asarray(md.i_lake)[lio] <= 0
        lke["valid"][lq, lj2] = True
    halo.update({f"lke_{k}": v for k, v in lke.items()})

    # ---- segments per shard (vectorised fill) ----
    seg_shard = old_to_shard[md.seg_ele]
    seg_sizes = np.bincount(seg_shard, minlength=p)
    ns_seg = max(1, int(seg_sizes.max()))
    order = np.argsort(seg_shard, kind="stable")
    seg_q = seg_shard[order]
    # position within shard = running index per shard
    seg_j = np.arange(md.num_seg) - np.concatenate(
        [[0], np.cumsum(seg_sizes)]
    )[seg_q]
    riv_of_seg = md.seg_riv[order]
    seg_riv_local = (riv_owner[riv_of_seg] == seg_q)
    seg_riv_gpos_all = _gpos(
        riv_groups, round_of, plan.off_riv,
        riv_owner[md.seg_riv], seg_shard, riv_slot_of[md.seg_riv],
    )[order]
    seg = {
        "ele_slot": np.zeros((p, ns_seg), dtype=np.int64),
        "riv_slot": np.zeros((p, ns_seg), dtype=np.int64),
        "riv_gpos": np.zeros((p, ns_seg), dtype=np.int64),
        "riv_local": np.zeros((p, ns_seg), dtype=bool),
        "length": np.zeros((p, ns_seg)),
        "cwr": np.zeros((p, ns_seg)),
        "rdepth": np.zeros((p, ns_seg)),
        "rksat": np.zeros((p, ns_seg)),
        "rbed": np.ones((p, ns_seg)),
        "valid": np.zeros((p, ns_seg), dtype=bool),
    }
    seg["ele_slot"][seg_q, seg_j] = old_to_slot[md.seg_ele[order]]
    seg["riv_slot"][seg_q, seg_j] = np.where(
        seg_riv_local, riv_slot_of[riv_of_seg], 0
    )
    seg["riv_gpos"][seg_q, seg_j] = np.where(
        seg_riv_local, 0, seg_riv_gpos_all
    )
    seg["riv_local"][seg_q, seg_j] = seg_riv_local
    seg["length"][seg_q, seg_j] = md.seg_length[order]
    seg["cwr"][seg_q, seg_j] = md.seg_cwr[order]
    seg["rdepth"][seg_q, seg_j] = md.riv_depth[riv_of_seg]
    seg["rksat"][seg_q, seg_j] = md.riv_ksat_h[riv_of_seg]
    seg["rbed"][seg_q, seg_j] = md.riv_bed_thick[riv_of_seg]
    seg["valid"][seg_q, seg_j] = True

    # ---- river blocks ----
    def scatter_riv(arr, fill=0.0):
        a = np.asarray(arr)
        out = np.full((p, nr_riv), fill, dtype=a.dtype)
        out[riv_owner, riv_slot_of] = a
        return out

    riv = {
        f: scatter_riv(getattr(md, f), fill=_RIV_PAD.get(f, 0))
        for f in _RIV_FIELDS
    }
    riv["valid"] = rvalid
    # down-link tables: local slot or ghost position + pre-baked statics
    down_local_g = np.zeros(max(nrv, 1), dtype=bool)
    down_slot_g = np.zeros(max(nrv, 1), dtype=np.int64)
    down_gpos_g = np.zeros(max(nrv, 1), dtype=np.int64)
    down_depth_g = np.zeros(max(nrv, 1))
    down_bs_g = np.asarray(md.riv_bed_slope, dtype=float).copy() \
        if nrv else np.zeros(1)
    if len(up_ids):
        down_local_g[up_ids] = ~link_cross
        down_slot_g[up_ids] = np.where(link_cross, 0, riv_slot_of[dn_ids])
        lg = _gpos(
            riv_groups, round_of, plan.off_riv,
            link_src[link_cross], link_dst[link_cross],
            riv_slot_of[dn_ids[link_cross]],
        )
        tmp = np.zeros(len(up_ids), dtype=np.int64)
        tmp[link_cross] = lg
        down_gpos_g[up_ids] = tmp
        down_depth_g[up_ids] = md.riv_depth[dn_ids]
        down_bs_g[up_ids] = md.riv_bed_slope[dn_ids]
    riv["has_down"] = scatter_riv(hd, fill=False)
    riv["down_local"] = scatter_riv(down_local_g[:nrv], fill=False) \
        if nrv else np.zeros((p, nr_riv), dtype=bool)
    riv["down_slot"] = scatter_riv(down_slot_g[:nrv], fill=0) \
        if nrv else np.zeros((p, nr_riv), dtype=np.int64)
    riv["down_gpos"] = scatter_riv(down_gpos_g[:nrv], fill=0) \
        if nrv else np.zeros((p, nr_riv), dtype=np.int64)
    riv["down_depth"] = scatter_riv(down_depth_g[:nrv]) \
        if nrv else np.zeros((p, nr_riv))
    riv["down_bedslope"] = scatter_riv(down_bs_g[:nrv]) \
        if nrv else np.zeros((p, nr_riv))

    lake = {}
    if md.num_lake > 0:
        lakenabr = np.full((p, np_cells, 3), -1, dtype=np.int64)
        lakenabr[old_to_shard, old_to_slot] = md.lakenabr
        dzl = np.zeros((p, np_cells, 3))
        dzl[old_to_shard, old_to_slot] = md.edge_lake_dzl
        dzb = np.zeros((p, np_cells, 3))
        dzb[old_to_shard, old_to_slot] = md.edge_lake_dzb
        lake = {
            "lakenabr": lakenabr,
            "dzl": dzl,
            "dzb": dzb,
            "zmin": np.asarray(md.lake_zmin),
            "bathy_y": np.asarray(md.lake_bathy_y),
            "bathy_a": np.asarray(md.lake_bathy_a),
            "num_ele": np.asarray(md.lake_num_ele),
        }

    same_tile = np.ones(ne * 3, dtype=bool)
    if tile_cells:
        same_tile[ok] = tile_of[nn[ok]] == tile_of[ii[ok]]

    # ---- compact intra-shard inter-tile edge list (tiled numbering) ------
    # Same flux laws as the cross-shard remainder, but the neighbour value
    # is local to the shard block (no ghost): evaluated in XLA and
    # merged by scatter-add exactly like rmt_*.  Only present when tiling
    # actually cut edges — its presence is the static switch the sharded
    # RHS keys on.
    # (lake-bank edges stay on the lke_* list regardless of tiles)
    tcut = ok & ~cross & ~same_tile & ~(np.asarray(md.lakenabr) >= 0).ravel()
    if tcut.any():
        ti = ii[tcut]
        tj = (np.arange(ne * 3) % 3)[tcut]
        tnb = nn[tcut]
        t_shard = old_to_shard[ti]
        t_counts = np.bincount(t_shard, minlength=p)
        tb_max = max(1, int(t_counts.max()))
        loc = {
            "cell": np.zeros((p, tb_max), np.int64),
            "slot": np.zeros((p, tb_max), np.int64),
            "nbr": np.zeros((p, tb_max), np.int64),
            "B": np.zeros((p, tb_max)),
            "dist": np.ones((p, tb_max)),
            "ravg": np.ones((p, tb_max)),
            "dzs": np.zeros((p, tb_max)),
            "dzb": np.zeros((p, tb_max)),
            "dep": np.zeros((p, tb_max)),
            "valid": np.zeros((p, tb_max), bool),
        }
        order_t = np.argsort(t_shard, kind="stable")
        tq_ = t_shard[order_t]
        tj2 = np.arange(len(ti)) - np.concatenate(
            [[0], np.cumsum(t_counts)])[tq_]
        tio, tjo, tno = ti[order_t], tj[order_t], tnb[order_t]
        loc["cell"][tq_, tj2] = old_to_slot[tio]
        loc["slot"][tq_, tj2] = tjo
        loc["nbr"][tq_, tj2] = old_to_slot[tno]
        loc["B"][tq_, tj2] = md.edge[tio, tjo]
        loc["dist"][tq_, tj2] = np.where(
            md.dist2nabor[tio, tjo] == 0.0, 1.0, md.dist2nabor[tio, tjo])
        loc["ravg"][tq_, tj2] = np.maximum(md.avg_rough[tio, tjo], 1e-20)
        loc["dzs"][tq_, tj2] = md.edge_dz_surf[tio, tjo]
        loc["dzb"][tq_, tj2] = md.edge_dz_bottom[tio, tjo]
        loc["dep"][tq_, tj2] = md.depression[tio]
        loc["valid"][tq_, tj2] = True
        halo.update({f"loc_{k}": v for k, v in loc.items()})
    return ShardedMesh(
        p=p, np_cells=np_cells, ns_seg=ns_seg, nr_riv=nr_riv,
        num_ele=ne, num_riv=md.num_riv, num_lake=md.num_lake,
        perm=perm, inv_perm=inv_perm, old_to_shard=old_to_shard,
        old_to_slot=old_to_slot, valid=valid,
        riv_owner=riv_owner[:nrv] if nrv else riv_owner[:0],
        riv_slot_of=riv_slot_of[:nrv] if nrv else riv_slot_of[:0],
        cell=cell, edge=edge, seg=seg, riv=riv, halo=halo, plan=plan,
        lake=lake,
    )


def shard_state(sm: ShardedMesh, y: np.ndarray) -> dict:
    """Split a global concat state vector into the sharded pytree."""
    ne, nr = sm.num_ele, sm.num_riv
    sf, us, gw = y[:ne], y[ne : 2 * ne], y[2 * ne : 3 * ne]
    riv = y[3 * ne : 3 * ne + nr]
    lake = y[3 * ne + nr :]

    def to_blocks(v):
        out = np.zeros((sm.p, sm.np_cells))
        out[sm.old_to_shard, sm.old_to_slot] = v
        return out

    rb = np.zeros((sm.p, sm.nr_riv))
    if nr:
        rb[sm.riv_owner, sm.riv_slot_of] = riv
    return {
        "sf": to_blocks(sf), "us": to_blocks(us), "gw": to_blocks(gw),
        "riv": rb, "lake": lake.copy(),
    }


def riv_blocks(sm: ShardedMesh, v: np.ndarray) -> np.ndarray:
    """Scatter a per-reach array into the sharded [P, Rp] block layout."""
    out = np.zeros((sm.p, sm.nr_riv), dtype=np.asarray(v).dtype)
    if sm.num_riv:
        out[sm.riv_owner, sm.riv_slot_of] = v
    return out


def unshard_state(sm: ShardedMesh, ys: dict) -> np.ndarray:
    def from_blocks(b):
        b = np.asarray(b)
        return b[sm.old_to_shard, sm.old_to_slot]

    rb = np.asarray(ys["riv"])
    riv = rb[sm.riv_owner, sm.riv_slot_of] if sm.num_riv else rb[:0, 0]
    return np.concatenate([
        from_blocks(ys["sf"]), from_blocks(ys["us"]), from_blocks(ys["gw"]),
        riv, np.asarray(ys["lake"]),
    ])
