"""K2's (search-by-projection's) share of its roofline, in percent: over its
launches in the traced stretch, the sum of their least times
(``lib.roofline.k2`` at the configuration's keypoint count and the live
map the launch searched, the insert cursor that the frame started from:
``_frames.live_map``) over the sum of their measured times (profiler)."""
from slambench.lib import roofline
from slambench.metrics._frames import live_map


def read(run):
    if run.trace is None:
        return None
    n = run.cfg.frontend.max_keypoints
    archive = run.cfg.map.obs_per_point
    least, spent = 0.0, 0.0
    for name, s, e in run.trace.ops:
        if "associate_kernel" not in name:
            continue
        f = run.trace.frame_of(s)
        size = live_map(run, f.index) if f is not None else None
        if not size:
            continue
        least += roofline.least_s(*roofline.k2(n, size, archive))
        spent += (e - s) * 1e-9
    if spent <= 0:
        return None
    return 100.0 * least / spent
