"""The device's idle share of an ordinary frame, in percent: over the
ordinary frames of a traced run outside its traced stretch (so without the
profiler's own cost), 1 less the step graph's replays on the device (CUDA
events inside the graph) over the frames' host-clock latencies. Besides
the replay an ordinary frame runs on the device only the copies of the
state into and out of the graph and the one fetch of its results, which
count as idle here."""
from slambench.metrics._frames import ordinary_replays


def read(run):
    fr = ordinary_replays(run)
    if not fr:
        return None
    return 100.0 * (1.0 - sum(r for _, r, _ in fr) / sum(t for _, _, t in fr))
