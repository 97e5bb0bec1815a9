# A frozen copy of shud_tpu_torch/core/state.py,
# its imports rewritten to this package; otherwise unchanged.
"""State layout and the per-window forcing slice.

The counterpart of ``shud_tpu/core/state.py``.  The global ODE state vector
matches the reference layout (``src/Model/Macros.hpp:21-26``):
``Y = [sf(Ne), us(Ne), gw(Ne), riv(Nr), lake(Nl)]``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class ForcingSlice(NamedTuple):
    """Per-cell land-surface quantities held fixed during one solver
    interval (refreshed by the driver at each forcing/ET step, mirroring
    ``updateforcing``/``ET`` in the reference driver ``shud.cpp:91-155``)."""

    net_prcp: torch.Tensor  # qEleNetPrep [m/min]
    prcp: torch.Tensor  # qElePrep [m/min] (lake budget)
    pot_evap: torch.Tensor  # qPotEvap [m/min]
    pot_tran: torch.Tensor  # qPotTran [m/min]
    e_ic: torch.Tensor  # qEleE_IC [m/min] (canopy-interception evap)
    lai: torch.Tensor  # t_lai
    fu_surf: torch.Tensor  # unfrozen surface fraction
    fu_sub: torch.Tensor  # unfrozen subsurface fraction
    ele_ybc: torch.Tensor  # Dirichlet GW head per cell (0 unless i_bc > 0)
    ele_qbc: torch.Tensor  # fixed GW flux per cell [m3/min] (i_bc < 0)
    ele_qss: torch.Tensor  # source/sink per cell [m3/min]
    riv_ybc: torch.Tensor  # fixed river stage (riv_bc > 0)
    riv_qbc: torch.Tensor  # fixed river inflow [m3/min] (riv_bc < 0)


def split_y(y, ne: int, nr: int, nl: int):
    sf = y[:ne]
    us = y[ne : 2 * ne]
    gw = y[2 * ne : 3 * ne]
    riv = y[3 * ne : 3 * ne + nr]
    lake = y[3 * ne + nr : 3 * ne + nr + nl]
    return sf, us, gw, riv, lake

