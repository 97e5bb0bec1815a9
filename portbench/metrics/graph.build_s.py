"""graph.build_s: seconds the interval graph took to build in set-up, its
warm-up, capture and instantiation (``IntervalGraph.stats``)."""


def read(probe):
    s = probe.graph_stats
    if not s or s.get("capture_s") is None:
        return None
    return s["warmup_s"] + s["capture_s"] + s["instantiate_s"]
