"""solver.nfe_per_sim_day: right-hand-side evaluations the solver made in
the window (its exact counter) over the simulated days completed."""


def read(probe):
    w = probe.window
    if not w["sim_minutes"]:
        return None
    return w["nfe"] / (w["sim_minutes"] / 1440.0)
