"""From the process's start to the window's: imports, kernel load, scene
and frames, bootstrap and the step graph's capture, warm-up (host clock)."""


def read(run):
    return run.setup_s
