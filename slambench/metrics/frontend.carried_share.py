"""The share of a frame's keypoints that the carry placed, in %: over the
ordinary frames of a traced run outside its traced stretch, the mean of
``num_carried`` over ``num_keypoints`` (the valid keypoints), the counters
the program's step notes and its frame records hold where the front end
carries keypoints. None where the records hold neither."""
from slambench.metrics._frames import ordinary_replays


def read(run):
    shares = [100.0 * rec["num_carried"] / rec["num_keypoints"]
              for rec, _, _ in ordinary_replays(run)
              if rec.get("num_keypoints")
              and rec.get("num_carried") is not None]
    if not shares:
        return None
    return sum(shares) / len(shares)
