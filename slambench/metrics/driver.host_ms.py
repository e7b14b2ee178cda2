"""The host's exposed time a frame: over the ordinary frames of a traced
run outside its traced stretch (so without the profiler's own cost), the
mean of the frame's ``wall_s`` (the program's MetricsLogger span of
``process``) less its step graph's replay on the device (CUDA events
inside the graph)."""
from slambench.metrics._frames import ordinary_replays


def read(run):
    fr = ordinary_replays(run)
    if not fr:
        return None
    return 1e3 * sum(rec["wall_s"] - replay for rec, replay, _ in fr) / len(fr)
