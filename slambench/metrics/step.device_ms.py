"""Device time an ordinary frame: the mean, over the traced ordinary
frames, of the time in the frame's range in which a device operation ran
(profiler)."""
from slambench.metrics._frames import ordinary_traced


def read(run):
    fr = ordinary_traced(run)
    if not fr:
        return None
    return 1e3 * sum(f.busy_ns() * 1e-9 for f, _ in fr) / len(fr)
