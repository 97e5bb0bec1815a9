"""Cryosphere / permafrost module (``cryosphere=1``).

The counterpart of ``shud_tpu/core/cryo.py``, porting the reference's
accumulated-temperature machinery (``src/classes/AccTemperature.hpp``): per
cell, a running mean of daily-mean air temperature over ~7-day (surface)
and ~28-day (subsurface) windows; the frozen fractions
``fu_Surf``/``fu_Sub = 1 - FrozenFraction(acc, max, min)``
(``functions.hpp:191-201``) multiply infiltration, recharge and lateral
subsurface fluxes (``MD_ET.cpp:301-311``).

State is a fixed-length ring buffer per window, its per-cell fields on the
device and its counters (entries, write slot, samples in the current day,
the day's start) on the host, so that the day flush is decided without a
device round trip.  The flush mirrors ``_AccTemp::push`` exactly,
including the quirk that the very first sample immediately flushes as a
full "day" (``Time_start`` initialised to -9999).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from shud_tpu_torch.core.landsurface import frozen_fraction


class AccTempState(NamedTuple):
    ring: torch.Tensor  # [maxlen, Ne] daily means (zero until filled)
    size: int  # entries in the ring (<= maxlen)
    head: int  # next write slot
    acc: torch.Tensor  # [Ne] running sum of the ring entries
    acc_day: torch.Tensor  # [Ne] within-day accumulator
    n_day: int  # samples in the current day
    time_start: float  # start of the current day [min]


def acc_temp_init(ne: int, maxlen: int, dtype: torch.dtype,
                  device: "str | torch.device") -> AccTempState:
    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return AccTempState(ring=z(maxlen, ne), size=0, head=0, acc=z(ne),
                        acc_day=z(ne), n_day=0, time_start=-9999.0)


def acc_temp_push(st: AccTempState, temp, t_now: float) -> AccTempState:
    """Per forcing step: accumulate; flush a daily mean when a day has
    elapsed (AccTemperature.hpp:push)."""
    acc_day = st.acc_day + temp
    n_day = st.n_day + 1
    if not (t_now - st.time_start) >= 1440.0:
        return st._replace(acc_day=acc_day, n_day=n_day)
    maxlen = st.ring.shape[0]
    day_mean = acc_day / n_day
    evicted = st.ring[st.head] if st.size >= maxlen else 0.0
    ring = st.ring.clone()
    ring[st.head] = day_mean
    return AccTempState(
        ring=ring, size=min(st.size + 1, maxlen),
        head=(st.head + 1) % maxlen, acc=st.acc + day_mean - evicted,
        acc_day=torch.zeros_like(acc_day), n_day=0, time_start=t_now)


def acc_temp_mean(st: AccTempState):
    return st.acc / max(st.size, 1)


class CryoState(NamedTuple):
    surf: AccTempState
    sub: AccTempState


def cryo_init(ne: int, surf_days: int = 7, sub_days: int = 28,
              dtype: torch.dtype = torch.float64,
              device: "str | torch.device" = "cuda") -> CryoState:
    return CryoState(
        surf=acc_temp_init(ne, surf_days, dtype, device),
        sub=acc_temp_init(ne, sub_days, dtype, device),
    )


def cryo_step(cs: CryoState, temp, t_now: float, surf_max=-1.0,
              surf_min=-5.0, sub_max=-3.0, sub_min=-10.0):
    """Push this step's temperature; return (new_state, fu_surf, fu_sub)
    (MD_ET.cpp:296-311)."""
    surf = acc_temp_push(cs.surf, temp, t_now)
    sub = acc_temp_push(cs.sub, temp, t_now)
    fu_surf = 1.0 - frozen_fraction(acc_temp_mean(surf), surf_max, surf_min)
    fu_sub = 1.0 - frozen_fraction(acc_temp_mean(sub), sub_max, sub_min)
    return CryoState(surf=surf, sub=sub), fu_surf, fu_sub
