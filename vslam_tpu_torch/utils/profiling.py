"""Profiling and timing tools on torch (port of
``vslam_tpu/utils/profiling.py``).

``device_trace`` records a ``torch.profiler`` trace (CPU activity, and CUDA
activity where a card is present) and writes it as Chrome-trace JSON;
``summarize_trace`` totals the trace's complete events by name, so hotspots
can be read without a trace viewer (``print_trace_summary`` prints them).
``mark`` names a stage boundary inside a step graph captured with
``span=True`` (``scan_driver.ChunkGraph``), which times each stage of a
replay by CUDA events (``ChunkGraph.stage_ms``); ``note`` keeps a counter
of the step on the device for the frame's row (``noting``). ``event_ms`` and
``graph_ms`` give device times from CUDA events, for ``ops.bench_kernels``,
``ops.bench_stages`` and ``chip_smoke.py``'s graph timing (``capture``
makes the graph on ``graph_stream``, ``use_graph_stream`` keeps a
thread's work there); they need a card, as does ``graph_nodes``, a
captured graph's nodes by type from the CUDA driver. ``device_record``
names what a result ran on, with nvidia-smi's name and power limit;
``clocks`` reads the SM clock, temperature and clock-event reasons.
``chip_smoke.py`` keeps its own single-call timers (``_time_each_ms``,
``_time_ms``) because ``scripts/time_kernels.py --root`` loads them from
older checkouts, which have no ``utils/profiling.py``.
"""
from __future__ import annotations

import ctypes
import functools
import glob
import json
import os
import subprocess
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

import torch

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


def print_trace_summary(outdir: str, top: int = 30) -> None:
    for name, ms, cnt in summarize_trace(outdir, top):
        print(f"{ms:10.2f} ms  x{cnt:5d}  {name[:110]}")


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


@functools.lru_cache(maxsize=None)
def _graph_stream(index: int) -> "torch.cuda.Stream":
    return torch.cuda.Stream(index)


def graph_stream(device=None) -> "torch.cuda.Stream":
    """The one stream of a card on which the package captures and replays
    its CUDA graphs (``scan_driver.ChunkGraph``, ``capture``), made at its
    first use."""
    return _graph_stream(torch.cuda._get_device_index(device, optional=True))


def use_graph_stream(device=None) -> Optional["torch.cuda.Stream"]:
    """Make ``graph_stream(device)`` the calling thread's current stream
    on that card, ordered after the work already queued on the stream it
    replaces, and leave it current; return it (None, and nothing done,
    for a device that is not a card). A graph's warm-up, capture and
    replays then share one stream with the caller's own work before and
    after them. On the H100 a graph whose work changed streams ran in a
    mode ~23% slower: a warm-up and capture on side streams with replays
    on the default stream; replays on their own stream while the
    caller's work stayed on the default one; and, for seconds after this
    switch, the first graphs of a program whose own work had run on the
    default stream before it (about a third of processes; none that
    switched before their first work). So the package's entry points on a card
    (``SLAMSystem``, ``tracker.init_state`` and ``bootstrap``,
    ``tools.bench``, ``ops.profile_step``) call it before their first
    work there, ``ChunkGraph.run`` and ``capture`` call it again, and a
    program that works on the card before its first call of one of them
    calls it first itself (PERF.md §6)."""
    if device is not None and torch.device(device).type != "cuda":
        return None
    s = graph_stream(device)
    cur = torch.cuda.current_stream(device)
    if cur != s:
        s.wait_stream(cur)
        torch.cuda.set_stream(s)
    return s


_LOCAL = threading.local()


@contextmanager
def disable_jit():
    """Run ``utils.jit``'s entry points eagerly inside the block (in this
    thread), as ``jax.disable_jit`` does; ``capture`` makes its graphs
    under it. Public as ``utils.jit.disable_jit``."""
    _LOCAL.depth = getattr(_LOCAL, "depth", 0) + 1
    try:
        yield
    finally:
        _LOCAL.depth -= 1


def jit_disabled() -> bool:
    """Whether this thread is inside ``disable_jit``."""
    return bool(getattr(_LOCAL, "depth", 0))


def mark(name: str) -> None:
    """A stage boundary: the stage ``name`` starts here. Inside the capture
    of a ``scan_driver.ChunkGraph`` made with ``span=True`` it records an
    external timing CUDA event into the graph; anywhere else it does
    nothing. A dotted name (``ransac.fit``) is a part of the stage its
    prefix names."""
    marks = getattr(_LOCAL, "marks", None)
    if marks is None:
        return
    ev = torch.cuda.Event(enable_timing=True, external=True)
    ev.record()
    marks.append((name, ev))


@contextmanager
def recording_marks(on: bool = True):
    """Collect the ``mark`` calls of the enclosed capture (this thread):
    yields the list of (name, event) they append to, which stays empty
    when ``on`` is false."""
    marks = []
    if not on:
        yield marks
        return
    _LOCAL.marks = marks
    try:
        yield marks
    finally:
        _LOCAL.marks = None


def note(name: str, value) -> None:
    """A counter of the step, kept on the device: inside ``noting``
    (``scan_driver``'s step and frame bodies, which pack what was noted
    into the frame's row) ``value()``, a 0-d float64 tensor, is computed
    and kept under ``name``; anywhere else nothing is computed."""
    notes = getattr(_LOCAL, "notes", None)
    if notes is not None:
        notes[name] = value()


@contextmanager
def noting():
    """Collect the ``note`` calls of the enclosed block (this thread):
    yields the {name: tensor} dict they fill."""
    outer = getattr(_LOCAL, "notes", None)
    _LOCAL.notes = notes = {}
    try:
        yield notes
    finally:
        _LOCAL.notes = outer


def capture(fn, generators=()) -> "torch.cuda.CUDAGraph":
    """``fn`` captured once as a CUDA graph on ``use_graph_stream()``,
    which stays the current stream, so the graph's replays go there too.
    ``fn`` runs once eagerly first (allocations and first-use work that a
    capture forbids); ``generators`` are registered with the graph. Both
    runs are under ``disable_jit``: an entry point ``fn`` calls runs
    its eager body, which the graph records."""
    s = use_graph_stream()
    with disable_jit():
        fn()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        for gen in generators:
            g.register_generator_state(gen)
        with torch.cuda.graph(g, stream=s):
            fn()
    return g


# cudaGraphNodeType / CUgraphNodeType, by value
NODE_TYPES = ("kernel", "memcpy", "memset", "host", "graph", "empty",
              "wait_event", "event_record", "ext_semas_signal",
              "ext_semas_wait", "mem_alloc", "mem_free", "batch_mem_op",
              "conditional")


@functools.lru_cache(maxsize=None)
def _libcuda():
    cu = ctypes.CDLL("libcuda.so.1")
    cu.cuGraphGetNodes.argtypes = [ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_void_p),
                                   ctypes.POINTER(ctypes.c_size_t)]
    cu.cuGraphNodeGetType.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_int)]
    return cu


def _graph_node_list(graph: "torch.cuda.CUDAGraph"):
    cu = _libcuda()
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    err = cu.cuGraphGetNodes(raw, None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * n.value)()
    if not err:
        err = cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n))
    if err:
        raise RuntimeError(f"cuGraphGetNodes failed: CUresult {err}")
    return nodes


def graph_nodes(graph: "torch.cuda.CUDAGraph") -> Dict[str, int]:
    """{node type: count} of a graph captured with ``keep_graph=True``
    ("kernel", "memcpy", "memset", "event_record", ...), read from the CUDA
    driver (``cuGraphGetNodes``, ``cuGraphNodeGetType``) on its
    ``cudaGraph_t``."""
    cu = _libcuda()
    out: Dict[str, int] = {}
    kind = ctypes.c_int(0)
    for node in _graph_node_list(graph):
        err = cu.cuGraphNodeGetType(node, ctypes.byref(kind))
        if err:
            raise RuntimeError(f"cuGraphNodeGetType failed: CUresult {err}")
        name = NODE_TYPES[kind.value] if kind.value < len(NODE_TYPES) \
            else str(kind.value)
        out[name] = out.get(name, 0) + 1
    return out


# CUDA_KERNEL_NODE_PARAMS_v2: func at 0, kern (a CUkernel) at 56
_KERNEL_PARAMS_BYTES, _KERN_OFFSET = 128, 56


def graph_kernels(graph: "torch.cuda.CUDAGraph") -> Dict[str, int]:
    """{kernel name: count} of the kernel nodes of a graph captured with
    ``keep_graph=True`` (mangled names, as the driver gives them:
    ``cuGraphKernelNodeGetParams_v2``, then ``cuFuncGetName`` or
    ``cuKernelGetName``). Needs a driver of CUDA 12 or later, whose
    ``_v2`` parameters this reads; raises on an older one."""
    cu = _libcuda()
    get = getattr(cu, "cuGraphKernelNodeGetParams_v2", None)
    if get is None:
        raise RuntimeError("graph_kernels: the CUDA driver has no "
                           "cuGraphKernelNodeGetParams_v2")
    get.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    name = ctypes.c_char_p()
    kind = ctypes.c_int(0)
    out: Dict[str, int] = {}
    for node in _graph_node_list(graph):
        err = cu.cuGraphNodeGetType(node, ctypes.byref(kind))
        if err:
            raise RuntimeError(f"cuGraphNodeGetType failed: CUresult {err}")
        if kind.value != 0:
            continue
        buf = ctypes.create_string_buffer(_KERNEL_PARAMS_BYTES)
        err = get(node, buf)
        if err:
            raise RuntimeError(f"cuGraphKernelNodeGetParams failed: "
                               f"CUresult {err}")
        func = ctypes.c_void_p.from_buffer(buf).value
        if func:
            err = cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(func))
        else:
            kern = ctypes.c_void_p.from_buffer(buf, _KERN_OFFSET).value
            err = cu.cuKernelGetName(ctypes.byref(name),
                                     ctypes.c_void_p(kern))
        if err:
            raise RuntimeError(f"reading a kernel node's name failed: "
                               f"CUresult {err}")
        k = name.value.decode()
        out[k] = out.get(k, 0) + 1
    return out


def graph_times_ms(fn, reps: int = 10, generators=()) -> List[float]:
    """Device ms of each of ``reps`` back-to-back replays of ``fn`` captured
    once as a CUDA graph (``capture``; a CUDA event between replays): the
    device time of fn's kernels without the host's launch cost."""
    g = capture(fn, generators)
    g.replay()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    ev[0].record()
    for e in ev[1:]:
        g.replay()
        e.record()
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in zip(ev, ev[1:])]


def _smi_query(fields, index=None):
    """nvidia-smi's csv values of ``fields`` for card ``index`` (the
    first card when None), or the failure's text as a str."""
    cmd = ["nvidia-smi", f"--query-gpu={','.join(fields)}",
           "--format=csv,noheader"]
    if index is not None:
        cmd.append(f"--id={index}")
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except OSError as e:
        return f"nvidia-smi failed: {e}"
    if r.returncode != 0:
        return f"nvidia-smi failed: {r.stderr.strip() or r.stdout.strip()}"
    return [v.strip() for v in r.stdout.strip().splitlines()[0].split(",")]


def nvidia_smi() -> str:
    """The card's name and power limit as nvidia-smi reports them, to keep
    beside every device number."""
    v = _smi_query(("name", "power.limit"))
    return v if isinstance(v, str) else ", ".join(v)


CLOCK_FIELDS = ("clocks.sm", "clocks.max.sm", "temperature.gpu",
                "clocks_event_reasons.active")


def clocks(device) -> dict:
    """nvidia-smi's SM clock, its maximum, the temperature (C) and the
    active clock-event reasons (a bitmask, 0x0 when nothing holds the
    clock down) of a card, as nvidia-smi prints them; {} for a device that
    is not a card, {"error": ...} when nvidia-smi fails."""
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    v = _smi_query(CLOCK_FIELDS, device.index)
    if isinstance(v, str):
        return {"error": v}
    return dict(zip(CLOCK_FIELDS, v))


def device_record(device) -> dict:
    """What a result was measured on: the device type and name and, on a
    card, the card count and nvidia-smi's name and power limit."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"type": device.type, "name": device.type}
    return {"type": "cuda", "name": torch.cuda.get_device_name(device),
            "count": torch.cuda.device_count(), "smi": nvidia_smi()}


def synchronize(device=None) -> None:
    """``torch.cuda.synchronize`` of ``device`` (the current CUDA device
    when None); nothing for a CPU device, whose work is done on return."""
    if device is None or torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def host_ms(fn, reps: int = 3, device=None) -> float:
    """Mean host-clock ms of fn() through a ``synchronize(device)``, after
    one warm-up call: what an eager caller waits for."""
    fn()
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    synchronize(device)
    return 1e3 * (time.perf_counter() - t0) / reps
