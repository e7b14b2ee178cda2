"""The front end's device time an ordinary frame: over the ordinary frames
of a traced run outside its traced stretch, the mean of the step graph's
``features`` stage (the program's ``device_ms`` record field: CUDA events
the graph records at its stage marks), its parts ``features.carry``,
``features.orient`` and ``features.describe`` included. None where the
program records no stages."""
from slambench.metrics._frames import ordinary_replays


def read(run):
    ms = [rec["device_ms"]["features"] for rec, _, _ in ordinary_replays(run)
          if "features" in rec.get("device_ms", {})]
    if not ms:
        return None
    return sum(ms) / len(ms)
