"""K1's (the Hamming matrix's) share of its roofline, in percent: over its
launches in the traced stretch, the sum of their least times
(``lib.roofline.k1`` at the configuration's keypoint count, both sides)
over the sum of their measured times (profiler)."""
from slambench.lib import roofline


def read(run):
    if run.trace is None:
        return None
    durs = [e - s for n, s, e in run.trace.ops if "hamming_kernel" in n]
    if not durs:
        return None
    n = run.cfg.frontend.max_keypoints
    least = roofline.least_s(*roofline.k1(n, n))
    return 100.0 * least * len(durs) / (sum(durs) * 1e-9)
