"""device.idle_pct: the share of a replay's wall in which the card runs
none of the replay's work, without the profiler: 100 x (1 - the replay's
device time, its intervals' ``advance_interval`` from first to last
device operation by CUDA events, / the wall of an unprofiled replay).
What stays is the time the host holds the card back: the preparation and
launch of each interval, the fetch and the turnaround."""


def read(probe):
    d = probe.device_time
    if not d["busy_s"] > 0:
        return None
    return 100.0 * (1.0 - d["busy_s"] / d["wall_s"])
