"""driver.host_us_per_interval: the host's microseconds an interval in
traced replays, from the program's own spans: ``shud.advance_interval``
and ``shud.fetch`` less ``shud.interval.wait``, the time the host is
blocked until the interval's graph has run (``portbench/spans.py``)."""

from portbench import spans


def read(probe):
    t = spans.measure(probe)
    if t is None or not t["intervals"]:
        return None
    return t["host_ns"] / t["intervals"] / 1e3
