"""Device-side mesh: the host ``MeshData`` as tensors on one device.

The counterpart of ``shud_tpu/core/device.py:to_device``.  ``to_torch``
takes a ``MeshData`` from either package (duck-typed by field name), casts
floats to the run's dtype and indices to ``torch.long``, and adds what the
port's RHS reads beyond the raw fields:

* the flat ``[Ne,3]`` edge tables of the edge-flux kernels (``EdgeTables``);
* fixed-width gather lists that replace ``segment_sum``: each target sums a
  padded row of source values in a fixed order, so every reduction is
  deterministic on the GPU (``index_add_`` uses float atomics there).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from shud_tpu_torch.core.mesh import MeshData

_STATIC_FIELDS = ("num_ele", "num_riv", "num_seg", "num_lake",
                  "watershed_area")
# TPU-only layouts: kept as fields of the copied MeshData, never read here
_UNUSED_FIELDS = ("roll_offsets", "roll_k_idx", "edge_blocks")
_ARRAY_FIELDS = tuple(
    f.name for f in dataclasses.fields(MeshData)
    if f.name not in _STATIC_FIELDS + _UNUSED_FIELDS
)


class EdgeTables(NamedTuple):
    """Static per-edge inputs of the edge-flux kernels, flat ``[Ne,3]``
    (edge slot minor), plus the two per-cell fields they read."""

    nabr: torch.Tensor       # [Ne,3] int32 neighbour, -1 where not gathered
    nb: torch.Tensor         # [Ne,3] long neighbour, 0 where not gathered
    edge: torch.Tensor       # [Ne,3] edge length
    dist: torch.Tensor       # [Ne,3] dist2nabor, 1.0 off-interior
    avg_rough: torch.Tensor  # [Ne,3] mean Manning roughness
    dzs: torch.Tensor        # [Ne,3] z_surf_i - z_surf_nb (f64-precomputed)
    dzb: torch.Tensor        # [Ne,3] z_bottom_i - z_bottom_nb
    d2e: torch.Tensor        # [Ne,3] centroid-to-edge distance
    m_int: torch.Tensor      # [Ne,3] uint8: interior-neighbour law
    m_bnd: torch.Tensor      # [Ne,3] uint8: open-boundary law
    dep: torch.Tensor        # [Ne] depression threshold
    rough: torch.Tensor      # [Ne] cell Manning roughness


class GatherLists(NamedTuple):
    """``[n_targets, K]`` source ids per reduction target, padded with the
    index of an appended zero (see ``gather_sum``)."""

    seg_to_riv: torch.Tensor
    seg_to_ele: torch.Tensor
    riv_to_down: torch.Tensor
    cell_to_lake: torch.Tensor = None
    edge_to_lake: torch.Tensor = None
    riv_to_lake: torch.Tensor = None


@dataclasses.dataclass
class TorchMesh(MeshData):
    """``MeshData`` whose array fields are tensors on one device."""

    has_nabr: torch.Tensor = None    # [Ne,3] bool
    has_lake: torch.Tensor = None    # [Ne,3] bool
    nb: torch.Tensor = None          # [Ne,3] long, 0 where no neighbour
    lk: torch.Tensor = None          # [Ne,3] long, 0 where no lake
    dist_nb: torch.Tensor = None     # [Ne,3] dist2nabor, 1.0 off-neighbour
    edge_tables: EdgeTables = None
    lists: GatherLists = None
    edge_kernel: bool = False  # edge_fluxes launches the CUDA kernels


def _fixed_width_lists(targets: np.ndarray, n_targets: int, pad_idx: int):
    """Invert a many-to-one map: for each target, the (sorted) source ids
    mapping to it, padded with *pad_idx* (a source slot whose value is
    guaranteed zero).  Returns [n_targets, K] int32.

    Copied from ``shud_tpu/core/pallas_mega.py:_fixed_width_lists``."""
    lists: list[list[int]] = [[] for _ in range(n_targets)]
    for src, tgt in enumerate(np.asarray(targets)):
        if 0 <= tgt < n_targets:
            lists[int(tgt)].append(src)
    k = max(1, max((len(l) for l in lists), default=1))
    out = np.full((n_targets, k), pad_idx, dtype=np.int32)
    for t, l in enumerate(lists):
        out[t, : len(l)] = l
    return out


def gather_sum(values: torch.Tensor, lists: torch.Tensor) -> torch.Tensor:
    """``segment_sum`` through a fixed-width gather list: the padded slots
    point at an appended zero, and each row is summed in a fixed order.
    *values* may have trailing dimensions (summed per column)."""
    padded = torch.cat([values, values.new_zeros((1,) + values.shape[1:])])
    return padded[lists].sum(dim=1)


def to_torch(md, dtype: torch.dtype, device: "str | torch.device",
             edge_kernel: "bool | None" = None) -> TorchMesh:
    """Move a host mesh to *device* (no default: the caller says where):
    floats to *dtype*, indices to long.

    ``edge_kernel`` (default: on exactly for float32 on CUDA) routes
    ``rhs.edge_fluxes`` through the CUDA edge-flux kernels; it is refused
    for any other dtype or device, because the kernels exist only there."""
    device = torch.device(device)
    if edge_kernel is None:
        edge_kernel = dtype == torch.float32 and device.type == "cuda"
    if edge_kernel and not (dtype == torch.float32 and device.type == "cuda"):
        raise ValueError("the edge-flux kernels need float32 on a CUDA device")

    def t(a, dt=None):
        v = np.asarray(a)
        if dt is None:
            dt = dtype if np.issubdtype(v.dtype, np.floating) else torch.long
        return torch.as_tensor(v, device=device).to(dt).contiguous()

    kw = {name: getattr(md, name) for name in _STATIC_FIELDS}
    for name in _ARRAY_FIELDS:
        raw = getattr(md, name)
        kw[name] = None if raw is None else t(raw)

    ne, nr, nl = md.num_ele, md.num_riv, md.num_lake
    nabr = np.asarray(md.nabr)
    lakenabr = np.asarray(md.lakenabr)
    has_nabr = nabr >= 0
    has_lake = lakenabr >= 0
    m_int = has_nabr & ~has_lake
    m_bnd = ~has_nabr & ~has_lake
    dist2nabor = np.asarray(md.dist2nabor)
    et = EdgeTables(
        nabr=t(np.where(m_int, nabr, -1), torch.int32),
        nb=t(np.where(m_int, nabr, 0)),
        edge=t(md.edge), dist=t(np.where(m_int, dist2nabor, 1.0)),
        avg_rough=t(md.avg_rough), dzs=t(md.edge_dz_surf),
        dzb=t(md.edge_dz_bottom), d2e=t(md.dist2edge),
        m_int=t(m_int, torch.uint8), m_bnd=t(m_bnd, torch.uint8),
        dep=t(md.depression), rough=t(md.rough),
    )

    seg_riv = np.asarray(md.seg_riv)
    seg_ele = np.asarray(md.seg_ele)
    riv_down = np.asarray(md.riv_down)
    ns = len(seg_riv)
    lists = dict(
        seg_to_riv=t(_fixed_width_lists(seg_riv, nr, ns)),
        seg_to_ele=t(_fixed_width_lists(seg_ele, ne, ns)),
        riv_to_down=t(_fixed_width_lists(riv_down, nr, nr)),
    )
    if nl > 0:
        i_lake = np.asarray(md.i_lake)
        lists.update(
            cell_to_lake=t(_fixed_width_lists(
                np.where(i_lake > 0, i_lake - 1, -1), nl, ne)),
            edge_to_lake=t(_fixed_width_lists(lakenabr.ravel(), nl, 3 * ne)),
            riv_to_lake=t(_fixed_width_lists(
                np.asarray(md.riv_to_lake), nl, nr)),
        )

    return TorchMesh(
        **kw,
        has_nabr=t(has_nabr, torch.bool), has_lake=t(has_lake, torch.bool),
        nb=t(np.where(has_nabr, nabr, 0)), lk=t(np.where(has_lake, lakenabr, 0)),
        dist_nb=t(np.where(has_nabr, dist2nabor, 1.0)),
        edge_tables=et, lists=GatherLists(**lists), edge_kernel=edge_kernel,
    )
