"""Frames processed in the window over the window's wall time, which ends
with a synchronize (host clock)."""


def read(run):
    if run.window_s <= 0 or not run.latencies:
        return None
    return len(run.latencies) / run.window_s
