"""graph.launches_per_nfe: device operations (kernels; copies and fills
left out) in the profiled interval over its right-hand-side evaluations."""


def read(probe):
    p = probe.profile
    if not p["nfe"] or not p["launches"]:
        return None
    return p["launches"] / p["nfe"]
