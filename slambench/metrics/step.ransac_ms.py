"""RANSAC's device time an ordinary frame: over the ordinary frames of a
traced run outside its traced stretch, the mean of the step graph's
``ransac`` stage (the program's ``device_ms`` record field: CUDA events
the graph records at its stage marks; the fits, stage 1, stage 2 and the
refine together). None where the program records no stages."""
from slambench.metrics._frames import ordinary_replays


def read(run):
    ms = [rec["device_ms"]["ransac"] for rec, _, _ in ordinary_replays(run)
          if "ransac" in rec.get("device_ms", {})]
    if not ms:
        return None
    return sum(ms) / len(ms)
