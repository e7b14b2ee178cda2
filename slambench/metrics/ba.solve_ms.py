"""A window-BA solve's device time: the median, over the solved window-BA
events of the window outside its traced stretch, of the program's
``solve_device_ms`` (two CUDA events around the captured solve). None
where the program records none."""
import statistics


def read(run):
    ms = [r["solve_device_ms"] for r in run.records
          if r.get("kind") == "ba" and "solve_device_ms" in r
          and r["frame"] in run.replay_s]
    if not ms:
        return None
    return statistics.median(ms)
