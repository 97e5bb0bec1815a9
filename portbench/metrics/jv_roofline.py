"""jv_roofline: as rhs_roofline, for one product of the linearization's
J·v (the tangent read once more), the linearization made beforehand."""

from portbench import work


def read(probe):
    seconds = probe.jv_seconds
    if seconds is None:
        return None
    return work.roofline_pct(probe.work["jv"], seconds, probe.kind)
