"""rhs_roofline: the least time of one right-hand-side evaluation (the
reference's fields, state and output over the card's bandwidth, or its
operations over the float32 peak) over its device time as the timed path
calls it, in a CUDA graph replayed warm."""

from portbench import work


def read(probe):
    seconds = probe.rhs_seconds
    if seconds is None:
        return None
    return work.roofline_pct(probe.work["rhs"], seconds, probe.kind)
