"""What a window-BA event adds to its frame: the median over the window's
BA frames of their ``wall_s`` (the program's span of ``process``) less
the median ordinary frame's."""
import statistics

from slambench.metrics._frames import kind_of


def read(run):
    ba = [r["wall_s"] for r in run.frames if r["ran_ba"]]
    plain = [r["wall_s"] for r in run.frames if kind_of(r) == "ordinary"]
    if not ba or not plain:
        return None
    return 1e3 * (statistics.median(ba) - statistics.median(plain))
