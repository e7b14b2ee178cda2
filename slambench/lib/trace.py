"""A torch.profiler trace of a stretch of the measured window, reduced in
memory: the device's operations, each frame's share of them, and the
device's idle gaps labelled by what the host was doing.

The harness marks each ``process`` call of the stretch with a
``record_function`` range named ``slambench.frame.<i>``; the device
operations (kernels, copies and fills, from CUPTI) whose start lies in a
frame's range belong to that frame (``process`` ends in a fetch from the
device, so a frame's work ends inside its range). Nothing is written to
disk. ``classify`` is a frozen copy of the program's table of kernel
classes.
"""
from __future__ import annotations

import bisect
import collections
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

FRAME_PREFIX = "slambench.frame."

# (substrings of a lower-cased kernel name, class), first match wins
_CLASSES = (
    (("hamming_kernel",), "K1 hamming"),
    (("associate_kernel",), "K2 associate"),
    (("memcpy ",), "memcpy"),         # CUPTI's "Memcpy DtoD (...)" events
    (("memset ",), "memset"),
    (("gemm", "gemv", "cutlass", "xmma", "splitkreduce", "dot_kernel"),
     "gemm"),
    (("sort",), "sort"),
    (("scatter", "gather", "index_elementwise", "indexselect",
      "index_select", "index_put", "indexing"), "index/scatter/gather"),
    (("reduce", "scan"), "reduce/scan"),
    # memcpy32_post: a graph's copy node run as a kernel
    (("catarray", "copy", "memcpy"), "cat/copy"),
    (("elementwise",), "elementwise"),
)


def classify(name: str) -> str:
    """The class of a device operation's name: the two hand kernels by their
    symbols, then gemm, sort, index / scatter / gather, reduce / scan,
    cat / copy, elementwise; else ``other``."""
    low = name.lower()
    for subs, group in _CLASSES:
        if any(s in low for s in subs):
            return group
    return "other"


def is_kernel(name: str) -> bool:
    """Whether a device operation is a kernel (not a copy or a fill)."""
    return classify(name) not in ("memcpy", "memset")


def union_ns(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The sorted, merged union of (start, end) intervals."""
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def covered_ns(merged: List[Tuple[int, int]], lo: int, hi: int) -> int:
    """How much of [lo, hi] the merged intervals cover."""
    return sum(max(0, min(e, hi) - max(s, lo)) for s, e in merged)


@dataclass
class Frame:
    index: int
    start: int                  # ns, host clock of the trace
    end: int
    ops: List[Tuple[str, int, int]] = field(default_factory=list)

    def kernels(self):
        return [o for o in self.ops if is_kernel(o[0])]

    def busy_ns(self) -> int:
        return covered_ns(union_ns([(s, e) for _, s, e in self.ops]),
                          self.start, self.end)


@dataclass
class Trace:
    frames: List[Frame]
    ops: List[Tuple[str, int, int]]      # every device operation in order

    @property
    def window_ns(self) -> int:
        return self.frames[-1].end - self.frames[0].start

    def busy_ns(self) -> int:
        lo, hi = self.frames[0].start, self.frames[-1].end
        return covered_ns(union_ns([(s, e) for _, s, e in self.ops]), lo, hi)

    def frame_of(self, t: int):
        """The frame whose range holds host time t, or None."""
        i = bisect.bisect_right([f.start for f in self.frames], t) - 1
        if i >= 0 and t <= self.frames[i].end:
            return self.frames[i]
        return None

    def idle_gaps(self):
        """[(start, end)] of the stretch's times with no device operation."""
        lo, hi = self.frames[0].start, self.frames[-1].end
        gaps, t = [], lo
        for s, e in union_ns([(s, e) for _, s, e in self.ops]):
            if s > t:
                gaps.append((t, min(s, hi)))
            t = max(t, e)
            if t >= hi:
                break
        if t < hi:
            gaps.append((t, hi))
        return [(s, e) for s, e in gaps if e > s]

    def op_seconds(self) -> Dict[str, float]:
        out: Dict[str, float] = collections.Counter()
        for name, s, e in self.ops:
            out[name] += (e - s) * 1e-9
        return out


def _ns(ev, which: str) -> int:
    f = getattr(ev, f"{which}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(ev, f"{which}_us")() * 1000)


def reduce_events(events) -> Trace:
    """A ``Trace`` of a profiler's raw events (``kineto_results.events()``):
    the host's ``slambench.frame.<i>`` ranges and the device's operations.
    Raises when the stretch holds no frame or no device operation."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    frames, ops = [], []
    for ev in events:
        name = ev.name()
        if name.startswith(FRAME_PREFIX):
            if ev.device_type() != cuda:
                start = _ns(ev, "start")
                frames.append(Frame(int(name[len(FRAME_PREFIX):]), start,
                                    start + _ns(ev, "duration")))
            continue
        if ev.device_type() == cuda:
            start = _ns(ev, "start")
            ops.append((name, start, start + _ns(ev, "duration")))
    if not frames or not ops:
        raise RuntimeError(f"the trace holds {len(frames)} frames and "
                           f"{len(ops)} device operations")
    frames.sort(key=lambda f: f.start)
    ops.sort(key=lambda o: o[1])
    tr = Trace(frames, ops)
    for op in ops:
        f = tr.frame_of(op[1])
        if f is not None:
            f.ops.append(op)
    return tr


class Profiler:
    """torch.profiler over the frames between ``start`` and ``stop``, CPU and
    CUDA activity; ``frame(i)`` marks one ``process`` call."""

    def __init__(self, torch):
        self.torch = torch
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)

    def start(self):
        self.prof.__enter__()

    def frame(self, i: int):
        return self.torch.profiler.record_function(f"{FRAME_PREFIX}{i}")

    def stop(self):
        """End the trace (its events are reduced later, by ``reduce``)."""
        self.prof.__exit__(None, None, None)

    def reduce(self) -> Trace:
        return reduce_events(self.prof.profiler.kineto_results.events())
