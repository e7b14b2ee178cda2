"""A map maintenance's time: the median, over the window's frames before
its traced stretch that ran one, of the program's ``maintenance`` span
(``SLAMSystem.process``: LRU eviction, compaction, the id remap, and the
fetch of the new size, which waits for the device). Frames from the
traced stretch on are left out: the profiler slows the host's launches
for the rest of the process. None where no maintenance fell there."""
import statistics

from slambench.metrics._spans import spans_named


def read(run):
    first = run.trace.frames[0].index if run.trace is not None else None
    ms = [1e-6 * (e - s) for r in run.frames
          if r.get("ran_maintenance") and (first is None or r["frame"] < first)
          for s, e in spans_named(r, "maintenance")]
    if not ms:
        return None
    return statistics.median(ms)
