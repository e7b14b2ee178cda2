"""The host's own time an ordinary frame, read from inside the program:
over the ordinary frames of a traced run before its traced stretch, the
mean of the frame's ``wall_s`` less the time the host spent in its
``fetch`` spans (the program's spans of its host reads, which wait for
the device). It holds the step graph's launch, which overlaps the
replay. Frames after the stretch are left out: once the profiler has run
in the process, the launch costs the host several times as much (the
device's time hardly moves). None where the program records no spans."""
from slambench.metrics._frames import ordinary_replays
from slambench.metrics._spans import spans_named


def read(run):
    first = run.trace.frames[0].index if run.trace is not None else None
    fr = [rec for rec, _, _ in ordinary_replays(run)
          if "spans" in rec and (first is None or rec["frame"] < first)]
    if not fr:
        return None
    return 1e3 * sum(rec["wall_s"] - 1e-9 * sum(
        e - s for s, e in spans_named(rec, "fetch")) for rec in fr) / len(fr)
