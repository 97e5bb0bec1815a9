"""window.tail_us: the card's microseconds a window in the tail (the
diagnostics and the interval sums), from the stamps inside the interval
graph over traced replays (``IntervalGraph.phases``,
``portbench/spans.py``)."""

from portbench import spans


def read(probe):
    t = spans.measure(probe)
    if t is None or not t["windows"]:
        return None
    return t["phases"]["tail_ns"] / t["windows"] / 1e3
