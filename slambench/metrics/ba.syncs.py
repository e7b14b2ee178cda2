"""Host syncs of a frame whose window-BA event solved: the median, over
such frames of the window outside its traced stretch, of the frame
record's ``syncs`` (the program's count of its host reads). None where
the program counts none."""
import statistics


def read(run):
    solved = {r["frame"] for r in run.records
              if r.get("kind") == "ba" and "skipped" not in r}
    n = [rec["syncs"] for rec in run.frames
         if rec["frame"] in solved and rec["frame"] in run.replay_s
         and "syncs" in rec]
    if not n:
        return None
    return statistics.median(n)
