"""The 95th percentile of every window frame's latency, host clock from
the ``process`` call to its return (nearest rank)."""
import math


def read(run):
    lat = sorted(run.latencies)
    if not lat:
        return None
    return 1e3 * lat[max(math.ceil(0.95 * len(lat)) - 1, 0)]
