"""Steered BRIEF's device time an ordinary frame: over the ordinary frames
of a traced run outside its traced stretch, the mean of the step graph's
``features.orient`` (the blur and the orientations on the dense
orientation map) and ``features.describe`` (the steered descriptors)
stages together (the program's ``device_ms`` record field). None where
the program marks neither (upright BRIEF, or a program that predates the
marks)."""
from slambench.metrics._frames import ordinary_replays

PARTS = ("features.orient", "features.describe")


def read(run):
    ms = [sum(rec["device_ms"][k] for k in PARTS)
          for rec, _, _ in ordinary_replays(run)
          if all(k in rec.get("device_ms", {}) for k in PARTS)]
    if not ms:
        return None
    return sum(ms) / len(ms)
