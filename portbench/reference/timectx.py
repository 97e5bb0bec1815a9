# A frozen copy of shud_tpu_torch/utils/timectx.py,
# its imports rewritten to this package; otherwise unchanged.
"""Simulation calendar: yyyymmdd base date + minutes offset.

Reimplements the reference ``TimeContext`` (src/classes/TimeContext.cpp:
55-224): civil-date <-> serial-day conversion (the Howard-Hinnant
days-from-civil algorithm, proleptic Gregorian), Julian day, and ISO
formatting of simulation times.  Pure Python (host-side only — times on
device are plain minute floats)."""

from __future__ import annotations

import dataclasses


def days_from_civil(y: int, m: int, d: int) -> int:
    """Serial day number (days since 1970-01-01) of a civil date."""
    y -= m <= 2
    era = (y if y >= 0 else y - 399) // 400
    yoe = y - era * 400
    doy = (153 * (m + (-3 if m > 2 else 9)) + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def civil_from_days(z: int) -> tuple[int, int, int]:
    """Inverse of :func:`days_from_civil`."""
    z += 719468
    era = (z if z >= 0 else z - 146096) // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = mp + (3 if mp < 10 else -9)
    return y + (m <= 2), m, d


@dataclasses.dataclass(frozen=True)
class TimeContext:
    """Base date (yyyymmdd int, as in forcing/output headers) + conversions
    for simulation times expressed in minutes since that base."""

    base_yyyymmdd: int

    @property
    def base_day(self) -> int:
        b = self.base_yyyymmdd
        return days_from_civil(b // 10000, (b // 100) % 100, b % 100)

    def civil(self, t_min: float) -> tuple[int, int, int, int, int, int]:
        """(y, m, d, H, M, S) of simulation time *t_min*."""
        total_s = int(round(t_min * 60.0))
        day, rem = divmod(total_s, 86400)
        y, m, d = civil_from_days(self.base_day + day)
        hh, rem = divmod(rem, 3600)
        mm, ss = divmod(rem, 60)
        return y, m, d, hh, mm, ss


    def yyyymmdd(self, t_min: float) -> int:
        y, m, d, *_ = self.civil(t_min)
        return y * 10000 + m * 100 + d


    def day_of_year(self, t_min: float) -> int:
        y, m, d, *_ = self.civil(t_min)
        return days_from_civil(y, m, d) - days_from_civil(y, 1, 1) + 1
