"""device.busy_us_per_nfe: a replay's device time without the profiler
(its intervals' ``advance_interval`` by CUDA events), in microseconds,
over the replay's right-hand-side evaluations."""


def read(probe):
    d = probe.device_time
    if not d["busy_s"] > 0 or not d["nfe"]:
        return None
    return 1e6 * d["busy_s"] / d["nfe"]
