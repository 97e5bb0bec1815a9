"""solver.newton_us: the card's microseconds a Newton iteration: the
windows' solve loops (steps, GMRES, J·v, the kept reductions), from the
stamps inside the interval graph, over the Newton iterations of the same
traced replays (``IntervalGraph.phases``, ``bdf.newton_iters``,
``portbench/spans.py``)."""

from portbench import spans


def read(probe):
    t = spans.measure(probe)
    if t is None or not t["newton_iters"]:
        return None
    return t["phases"]["solve_ns"] / t["newton_iters"] / 1e3
