"""Kernels an ordinary frame (copies and fills left out): the mean over
the traced ordinary frames (profiler)."""
from slambench.metrics._frames import ordinary_traced


def read(run):
    fr = ordinary_traced(run)
    if not fr:
        return None
    return sum(len(f.kernels()) for f, _ in fr) / len(fr)
