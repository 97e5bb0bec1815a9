"""setup.first_interval_s: seconds of the process's first interval, its
``shud.advance_interval`` span: the kernels' library load, the interval
graph's warm-up, capture and instantiation, and the interval's run
(``portbench/spans.py``)."""

from portbench import spans


def read(probe):
    t = spans.measure(probe)
    return None if t is None else t["first_interval_s"]
