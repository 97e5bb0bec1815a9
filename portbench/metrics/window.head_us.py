"""window.head_us: the card's microseconds a window in the head (the
window's forcing, buckets, overlays and the solver's head, with the
window loop's test), from the stamps inside the interval graph over
traced replays (``IntervalGraph.phases``, ``portbench/spans.py``)."""

from portbench import spans


def read(probe):
    t = spans.measure(probe)
    if t is None or not t["windows"]:
        return None
    return t["phases"]["head_ns"] / t["windows"] / 1e3
