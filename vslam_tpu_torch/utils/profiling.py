"""Profiling and timing tools on torch (port of
``vslam_tpu/utils/profiling.py``).

``device_trace`` records a ``torch.profiler`` trace (CPU activity, and CUDA
activity where a card is present) and writes it as Chrome-trace JSON;
``summarize_trace`` totals the trace's complete events by name, so hotspots
can be read without a trace viewer. ``StageTimer`` takes coarse host-clock
stage times, fenced by ``torch.cuda.synchronize``. ``event_ms`` and
``graph_ms`` give device times from CUDA events, for ``ops.bench_kernels``,
``ops.bench_stages`` and ``chip_smoke.py``'s graph timing; they need a card.
``chip_smoke.py`` keeps its own single-call timers (``_time_each_ms``,
``_time_ms``) because ``scripts/time_kernels.py --root`` loads them from
older checkouts, which have no ``utils/profiling.py``.
"""
from __future__ import annotations

import glob
import json
import os
import subprocess
import time
from contextlib import contextmanager
from typing import Dict, List, Tuple

import torch
from torch.utils._pytree import tree_leaves

TRACE_SUFFIX = ".pt.trace.json"


@contextmanager
def device_trace(outdir: str):
    """Profile the enclosed block; on exit write its Chrome-trace JSON to
    ``outdir/<pid>_<ns>.pt.trace.json``. Yields the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    os.makedirs(outdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        outdir, f"{os.getpid()}_{time.time_ns()}{TRACE_SUFFIX}"))


def summarize_trace(outdir: str, top: int = 30
                    ) -> List[Tuple[str, float, int]]:
    """Parse the traces ``device_trace`` wrote under outdir.

    Returns [(event name, total ms, count)] of the complete ("X") events,
    sorted by total time, descending.
    """
    totals: Dict[str, List[float]] = {}
    for fp in glob.glob(os.path.join(outdir, "**", "*" + TRACE_SUFFIX),
                        recursive=True):
        with open(fp) as f:
            data = json.load(f)
        for ev in data.get("traceEvents", []):
            if ev.get("ph") == "X" and "dur" in ev:
                rec = totals.setdefault(ev.get("name", "?"), [0.0, 0])
                rec[0] += float(ev["dur"])
                rec[1] += 1
    rows = sorted(totals.items(), key=lambda kv: -kv[1][0])[:top]
    return [(name, dur / 1000.0, int(cnt)) for name, (dur, cnt) in rows]


class StageTimer:
    """Host-clock stage timing. Work on a card is asynchronous: a stage
    ends with ``torch.cuda.synchronize`` of the devices its ``result``
    tensors lie on (of the current device when no result is given and CUDA
    is in use), so its time is attributable."""

    def __init__(self):
        self.times: Dict[str, List[float]] = {}

    @contextmanager
    def stage(self, name: str, result=None):
        t0 = time.perf_counter()
        yield
        if result is not None:
            devs = {t.device for t in tree_leaves(result)
                    if isinstance(t, torch.Tensor) and t.is_cuda}
            for d in devs:
                torch.cuda.synchronize(d)
        elif torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.times.setdefault(name, []).append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, float]:
        return {k: sum(v) / len(v) for k, v in self.times.items()}


def event_ms(fn, reps: int = 20, warmup: int = 1) -> float:
    """Mean device ms of single calls of fn() on the current CUDA stream,
    each between two CUDA events, after a ~0.2 ms spin that keeps the card
    busy while the host enqueues the call (the host's cost stays out of
    the window unless it exceeds the spin)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        torch.cuda._sleep(400_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def graph_ms(fn, reps: int = 10, generators=()) -> float:
    """Mean device ms of one replay of ``fn`` captured as a CUDA graph
    (``graph_times_ms``)."""
    return sum(graph_times_ms(fn, reps, generators)) / reps


def graph_times_ms(fn, reps: int = 10, generators=()) -> List[float]:
    """Device ms of each of ``reps`` back-to-back replays of ``fn`` captured
    once as a CUDA graph (a CUDA event between replays): the device time of
    fn's kernels without the host's launch cost. ``fn`` runs once eagerly
    on a side stream first (allocations and first-use work that a capture
    forbids); ``generators`` are registered with the graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    for gen in generators:
        g.register_generator_state(gen)
    with torch.cuda.graph(g):
        fn()
    g.replay()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    ev[0].record()
    for e in ev[1:]:
        g.replay()
        e.record()
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in zip(ev, ev[1:])]


def nvidia_smi() -> str:
    """The card's name and power limit as nvidia-smi reports them, to keep
    beside every device number."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except OSError as e:
        return f"nvidia-smi failed: {e}"
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else \
        f"nvidia-smi failed: {r.stderr.strip()}"


def host_ms(fn, reps: int = 3) -> float:
    """Mean host-clock ms of fn() through a ``torch.cuda.synchronize``,
    after one warm-up call: what an eager caller waits for."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps
