"""Cryosphere / permafrost module (``cryosphere=1``).

The counterpart of ``shud_tpu/core/cryo.py``, porting the reference's
accumulated-temperature machinery (``src/classes/AccTemperature.hpp``): per
cell, a running mean of daily-mean air temperature over ~7-day (surface)
and ~28-day (subsurface) windows; the frozen fractions
``fu_Surf``/``fu_Sub = 1 - FrozenFraction(acc, max, min)``
(``functions.hpp:191-201``) multiply infiltration, recharge and lateral
subsurface fluxes (``MD_ET.cpp:301-311``).

State is a fixed-length ring buffer per window, every field a tensor on
the device (the counters 0-d int64, the day's start 0-d in the state's
dtype), and the day flush a select, as in the JAX package: no step reads
the device, so a captured output interval (``driver/fused.py``
``IntervalGraph``) runs it on the card.  The flush mirrors
``_AccTemp::push`` exactly, including the quirk that the very first sample
immediately flushes as a full "day" (``Time_start`` initialised to -9999).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from shud_tpu_torch.core.landsurface import frozen_fraction


class AccTempState(NamedTuple):
    ring: torch.Tensor  # [maxlen, Ne] daily means (zero until filled)
    size: torch.Tensor  # 0-d int64, entries in the ring (<= maxlen)
    head: torch.Tensor  # 0-d int64, next write slot
    acc: torch.Tensor  # [Ne] running sum of the ring entries
    acc_day: torch.Tensor  # [Ne] within-day accumulator
    n_day: torch.Tensor  # 0-d int64, samples in the current day
    time_start: torch.Tensor  # 0-d, start of the current day [min]


def acc_temp_init(ne: int, maxlen: int, dtype: torch.dtype,
                  device: "str | torch.device") -> AccTempState:
    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    return AccTempState(
        ring=z(maxlen, ne), size=z(dt=torch.int64), head=z(dt=torch.int64),
        acc=z(ne), acc_day=z(ne), n_day=z(dt=torch.int64),
        time_start=torch.full((), -9999.0, dtype=dtype, device=device))


def over_count(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """x over a 0-d count, rounded as PyTorch divides a tensor by a host
    integer on its device (the counts were host integers before they were
    device tensors): the product with the reciprocal on CUDA, the quotient
    on the CPU (JAX's arithmetic there)."""
    n = n.to(x.dtype)
    return x * (1.0 / n) if x.is_cuda else x / n


def acc_temp_push(st: AccTempState, temp, t_now) -> AccTempState:
    """Per forcing step: accumulate; flush a daily mean when a day has
    elapsed (AccTemperature.hpp:push).  *t_now*: a host number or a 0-d
    tensor; the elapsed time is compared in float64."""
    maxlen = st.ring.shape[0]
    acc_day = st.acc_day + temp
    n_day = st.n_day + 1
    flush = (t_now - st.time_start.double()) >= 1440.0
    day_mean = over_count(acc_day, n_day)
    head = st.head.view(1)
    evicted = torch.where(st.size >= maxlen,
                          st.ring.index_select(0, head)[0], 0.0)
    row = torch.where(flush, day_mean, st.ring.index_select(0, head)[0])
    return AccTempState(
        ring=st.ring.index_copy(0, head, row[None]),
        size=torch.where(flush, torch.clamp(st.size + 1, max=maxlen),
                         st.size),
        head=torch.where(flush, (st.head + 1) % maxlen, st.head),
        acc=torch.where(flush, st.acc + day_mean - evicted, st.acc),
        acc_day=torch.where(flush, torch.zeros_like(acc_day), acc_day),
        n_day=torch.where(flush, torch.zeros_like(n_day), n_day),
        time_start=torch.where(flush, t_now, st.time_start))


def acc_temp_mean(st: AccTempState):
    return over_count(st.acc, torch.clamp(st.size, min=1))


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


def cryo_step(cs: CryoState, temp, t_now, surf_max=-1.0,
              surf_min=-5.0, sub_max=-3.0, sub_min=-10.0):
    """Push this step's temperature; return (new_state, fu_surf, fu_sub)
    (MD_ET.cpp:296-311)."""
    surf = acc_temp_push(cs.surf, temp, t_now)
    sub = acc_temp_push(cs.sub, temp, t_now)
    fu_surf = 1.0 - frozen_fraction(acc_temp_mean(surf), surf_max, surf_min)
    fu_sub = 1.0 - frozen_fraction(acc_temp_mean(sub), sub_max, sub_min)
    return CryoState(surf=surf, sub=sub), fu_surf, fu_sub
