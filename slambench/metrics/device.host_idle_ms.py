"""The device's idle time an ordinary frame that host work left: over the
traced stretch's ordinary frames, the mean of the device's idle gaps
(profiler) inside the frame's range and outside its ``step`` and
``fetch`` spans (the program's spans, on the profiler's clock). The
step's replay runs while the host is in those two spans (under the
profiler the graph's launch holds the host for most of it), so their
gaps are the replay's and the profiler's; the rest is idle that the
host's other work left. None where the program records no spans."""
from slambench.lib.trace import covered_ns, union_ns
from slambench.metrics._frames import ordinary_traced
from slambench.metrics._spans import spans_named


def read(run):
    fr = [(f, rec) for f, rec in ordinary_traced(run) if "spans" in rec]
    if not fr:
        return None
    gaps = run.trace.idle_gaps()
    idle = 0
    for f, rec in fr:
        replay = union_ns(spans_named(rec, "step")
                          + spans_named(rec, "fetch"))
        for s, e in gaps:
            lo, hi = max(s, f.start), min(e, f.end)
            if hi > lo:
                idle += hi - lo - covered_ns(replay, lo, hi)
    return 1e-6 * idle / len(fr)
