"""The carry's device time an ordinary frame: over the ordinary frames of
a traced run outside its traced stretch, the mean of the step graph's
``features.carry`` stage (the prediction through the constant-velocity
pose, detection and the carried keypoints' re-localisation; the program's
``device_ms`` record field). None where the program marks no such stage
(no carry, or a program that predates the mark)."""
from slambench.metrics._frames import ordinary_replays


def read(run):
    ms = [rec["device_ms"]["features.carry"]
          for rec, _, _ in ordinary_replays(run)
          if "features.carry" in rec.get("device_ms", {})]
    if not ms:
        return None
    return sum(ms) / len(ms)
