"""driver.fetch_gbps: the rate of an interval's fetch, the bytes of the
tensors fetched to the host (the counter ``shud.fetch.bytes`` that
``_to_host`` states) over the mean microseconds of its span
``shud.fetch`` an interval of the traced replays (``portbench/spans.py``:
the pack into one buffer on the card, the copy to host memory, the
split).  On stderr: the bytes and the microseconds.  None where the
program states no such counter (an older checkout) or runs no interval
graph."""

import sys

from portbench import spans


def read(probe):
    try:
        from shud_tpu_torch import trace
    except ImportError:
        return None
    nbytes = trace.counters().get("shud.fetch.bytes")
    if nbytes is None:
        return None
    t = spans.measure(probe)
    if t is None or not t["intervals"]:
        return None
    us = t["span_us"].get("shud.fetch")
    if not us:
        return None
    print(f"fetch: {nbytes} bytes an interval in {us!r} us", file=sys.stderr)
    return nbytes / us / 1e3
