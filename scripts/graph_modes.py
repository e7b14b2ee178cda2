#!/usr/bin/env python3
"""Capture the carried tracking step many times and read the mode of each
capture: its nodes by type and its replays' device ms.

    python3 scripts/graph_modes.py [--root DIR] [--captures 8] [--procs 2]
        [--replays 24] [--trace] [--attribute] [--one-stream]
        [--kernels-first {default,graph}] [--out FILE]

DIR is a checkout of this repository (default: the one holding this
script); its ``vslam_tpu_torch`` is the one measured, so one command can
read the parent and a change on the same card. The workload is
``tools.bench``'s headline segment: the default ``VSLAMConfig()``, the
scene of seed 17, 51200 distractors (``bench.prepopulate``), and the step
replayed as ``scan_driver.step_graph`` through ``scan_driver.carried``.

For each of ``--captures`` fresh ``ChunkGraph``s in this process (and
``--procs`` more processes of one capture each) it prints:

  * the graph's nodes by type, read from the CUDA driver
    (``cuGraphGetNodes`` / ``cuGraphNodeGetType`` on the captured
    ``cudaGraph_t``, kept with ``CUDAGraph(keep_graph=True)``); for the
    first capture the same counts are also parsed from
    ``CUDAGraph.debug_dump``'s DOT file and must agree;
  * ``--replays`` single-frame replays, each one's device ms from the CUDA
    events that ``ChunkGraph(span=True)`` records first and last inside
    the graph (the median, min and max, and the replay index of each
    switch between the modes);
  * bench's pattern: 20 and 40 frames in one ``carried`` call each, twice
    in turn, CUDA events around each call, differenced to ms a frame.

``--trace`` then traces 3 replays of the fastest and of the slowest
capture under ``torch.profiler`` and reads the trace: the copies as
``memcpy32_post``-style kernels or as ``Memcpy DtoD`` events, and the idle
after each device event, summed by the class of that event. ``--attribute``
profiles one eager ``track_step`` with Python stacks and counts every
``cudaMemcpyAsync`` by the port's call site that issued it (in a graph
capture each one is a memcpy node). ``--one-stream`` runs all of it on
one non-default stream, warm-up and capture included, whatever stream
the checkout's package asks for: the A/B that showed a checkout whose
graph work changed streams running in two modes (PERF.md §6).
``--kernels-first`` reads another pattern instead, in this process and
``--procs`` more: ``chip_smoke.py``'s kernel checks (phases 3-4, work of
the program's own on the card) on the default stream or on the graph
stream, then its phase 6 (direct ``track_step`` calls through
``utils.jit``'s cached graph, the process's first graph), and prints
each process's replay device ms and how many read the slow mode. Results
go to ``--out`` (JSON) and stdout; exits 2 without a card.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
SEED = 17
N_MAP = 51200
FAST_SLOW_MS = 51.5          # between the modes: ~44-49 fast, ~54-60 slow

# CUgraphNodeType (cuda.h)
NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host",
              4: "graph", 5: "empty", 6: "wait_event", 7: "event_record",
              8: "ext_semas_signal", 9: "ext_semas_wait", 10: "mem_alloc",
              11: "mem_free", 12: "batch_mem_op", 13: "conditional"}


def driver_node_types(raw_graph: int) -> dict:
    """{type: count} of the nodes of a ``cudaGraph_t`` (an int handle),
    from the CUDA driver."""
    cu = ctypes.CDLL("libcuda.so.1")
    cu.cuGraphGetNodes.argtypes = [ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_void_p),
                                   ctypes.POINTER(ctypes.c_size_t)]
    cu.cuGraphNodeGetType.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_int)]
    n = ctypes.c_size_t(0)
    rc = cu.cuGraphGetNodes(ctypes.c_void_p(raw_graph), None,
                            ctypes.byref(n))
    if rc:
        raise RuntimeError(f"cuGraphGetNodes: {rc}")
    nodes = (ctypes.c_void_p * n.value)()
    rc = cu.cuGraphGetNodes(ctypes.c_void_p(raw_graph), nodes,
                            ctypes.byref(n))
    if rc:
        raise RuntimeError(f"cuGraphGetNodes: {rc}")
    out = collections.Counter()
    t = ctypes.c_int(0)
    for node in nodes:
        rc = cu.cuGraphNodeGetType(node, ctypes.byref(t))
        if rc:
            raise RuntimeError(f"cuGraphNodeGetType: {rc}")
        out[NODE_TYPES.get(t.value, str(t.value))] += 1
    return dict(out)


# a node's label opens with its type ("{KERNEL | ..."), or with its id and
# then its type ("0 (topoId: 7)\nEVENT_RECORD ...")
_DOT_NODE = re.compile(r'"graph_\d+_node_\d+"\s*\[[^\]]*?label="\{?\s*'
                       r'(?:\d+ \(topoId: \d+\)\s*)?([A-Za-z_]+)', re.S)


def dot_node_types(path: str) -> dict:
    """{type: count} of the nodes in a ``debug_dump`` DOT file (each
    node's label opens with its type)."""
    with open(path) as f:
        text = f.read()
    return dict(collections.Counter(m.group(1).lower()
                                    for m in _DOT_NODE.finditer(text))), \
        text[:3000]


def workload(torch, dev, n_frames):
    """bench.py's headline segment: (cfg, state at map 51200, frames)."""
    from vslam_tpu_torch.config import VSLAMConfig
    from vslam_tpu_torch.datasets import synthetic
    from vslam_tpu_torch.pipeline import tracker
    from vslam_tpu_torch.tools import bench

    cfg = VSLAMConfig()
    K = cfg.camera.K()
    scene = synthetic.make_scene(seed=SEED, **bench.SCENE)
    fr = synthetic.render_sequence(
        K, synthetic.make_trajectory(n_frames + 1, step=bench.STEP,
                                     seed=SEED),
        scene, cfg.camera.width, cfg.camera.height)
    state = tracker.bootstrap(fr[0], cfg, dev)
    state = bench.prepopulate(state, N_MAP, SEED)
    return cfg, state, torch.from_numpy(fr[1:]).to(dev)


def kept_graphs(torch, scan_driver):
    """A checkout whose ``ChunkGraph`` makes a plain ``CUDAGraph()`` (one
    from before ``ChunkGraph.nodes``) gets graphs that keep their
    ``cudaGraph_t``, so their nodes can be read; a later one keeps its
    own. Returns whether it patched."""
    if hasattr(scan_driver, "graph_nodes"):
        return False
    base = torch.cuda.CUDAGraph
    torch.cuda.CUDAGraph = lambda keep_graph=True: base(keep_graph=True)
    return True


def measure(torch, cfg, state, frames, replays, dot_dir=None):
    """One fresh capture: node counts, per-replay span ms, bench's
    differenced ms a frame."""
    from vslam_tpu_torch.pipeline import scan_driver

    draws = state.key.get_state()
    g = scan_driver.step_graph(cfg, span=True)
    t0 = time.perf_counter()
    scan_driver.carried(state, frames[:1], cfg, g)[1].cpu()
    capture_s = time.perf_counter() - t0
    rec = dict(capture_s=capture_s)
    rec["nodes"] = driver_node_types(g.graph.raw_cuda_graph())
    if dot_dir is not None:
        path = os.path.join(dot_dir, "step.dot")
        try:
            g.graph.debug_dump(path)
            rec["nodes_dot"], rec["dot_head"] = dot_node_types(path)
            rec["dot_bytes"] = os.path.getsize(path)
            os.remove(path)
        except (RuntimeError, OSError) as e:
            rec["nodes_dot"] = {"error": repr(e)}
            rec["dot_bytes"] = 0
    spans, stamps = [], []
    state.key.set_state(draws)
    s = state
    for t in range(replays):
        s, rows = scan_driver.carried(s, frames[t:t + 1], cfg, g)
        rows.cpu()
        spans.append(g.span_ms())
        stamps.append(time.perf_counter())
    half = {}
    for n in (20, 40, 20, 40):
        state.key.set_state(draws)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        rows = scan_driver.carried(state, frames[:n], cfg, g)[1]
        ev[1].record()
        rows.cpu()
        half.setdefault(n, []).append(ev[0].elapsed_time(ev[1]))
    rec.update(span_ms=spans, median_ms=statistics.median(spans),
               min_ms=min(spans), max_ms=max(spans),
               switches=[i for i in range(1, len(spans))
                         if (spans[i] < FAST_SLOW_MS)
                         != (spans[i - 1] < FAST_SLOW_MS)],
               bench_ms=(min(half[40]) - min(half[20])) / 20,
               runs_ms={str(k): v for k, v in half.items()},
               stamps=stamps)
    state.key.set_state(draws)
    return g, rec


def _cls(ev):
    from vslam_tpu_torch.ops import profile_step
    if ev.get("cat") == "gpu_memcpy":
        return "memcpy event (copy engine)"
    if ev.get("cat") == "gpu_memset":
        return "memset event"
    name = ev["name"].lower()
    if "memcpy" in name:
        return "memcpy kernel"
    return profile_step.classify(ev["name"])


def read_trace(path, n_frames):
    """Device events of a Chrome trace: counts and the idle that follows
    each event, by the class of that event, per frame (idle only inside a
    replay: gaps longer than 1 ms, between replays, are left out)."""
    with open(path) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X" and e.get("cat") in
                  ("kernel", "gpu_memcpy", "gpu_memset")]
    events.sort(key=lambda e: float(e["ts"]))
    n = collections.Counter()
    idle = collections.Counter()
    names = collections.Counter()
    for a, b in zip(events, events[1:]):
        c = _cls(a)
        n[c] += 1
        gap = float(b["ts"]) - (float(a["ts"]) + float(a.get("dur", 0)))
        if 0 < gap < 1000.0:
            idle[c] += gap / 1000.0
        if "memcpy" in c:
            names[a["name"][:60]] += 1
    busy = sum(float(e.get("dur", 0)) for e in events) / 1000.0
    return dict(events_per_frame={k: v / n_frames for k, v in n.items()},
                idle_ms_per_frame={k: round(v / n_frames, 4)
                                   for k, v in idle.items()},
                idle_ms_per_event={k: round(idle[k] / n[k], 5)
                                   for k in idle if n[k]},
                busy_ms_per_frame=busy / n_frames,
                copy_names=dict(names))


def trace(torch, g, cfg, state, frames, out_dir, n=3):
    from vslam_tpu_torch.pipeline import scan_driver
    from vslam_tpu_torch.utils.profiling import TRACE_SUFFIX, device_trace

    d = tempfile.mkdtemp(prefix="trace_", dir=out_dir)
    draws = state.key.get_state()
    torch.cuda.synchronize()
    spans = []
    with device_trace(d):
        s = state
        for t in range(n):
            s, rows = scan_driver.carried(s, frames[t:t + 1], cfg, g)
            rows.cpu()
            spans.append(g.span_ms())
    state.key.set_state(draws)
    path = next(str(p) for p in Path(d).glob("*" + TRACE_SUFFIX))
    rec = read_trace(path, n)
    rec["traced_span_ms"] = spans
    return rec


def attribute(torch, cfg, state, frame):
    """Every cudaMemcpyAsync of one eager track_step, counted by the port's
    innermost call sites (and the aten op above the call). A checkout
    with ``utils.jit`` runs the step under its ``disable_jit`` (a direct
    call there replays a graph); an older one's step is eager."""
    from vslam_tpu_torch.pipeline import tracker
    try:
        from vslam_tpu_torch.utils.jit import disable_jit
    except ImportError:             # a checkout from before utils.jit
        disable_jit = contextlib.nullcontext

    draws = state.key.get_state()
    with disable_jit():
        tracker.track_step(state, frame, cfg)           # warm
    torch.cuda.synchronize()
    state.key.set_state(draws)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, with_stack=True) as prof, \
            disable_jit():
        tracker.track_step(state, frame, cfg)
        torch.cuda.synchronize()
    state.key.set_state(draws)
    sites = collections.Counter()
    total = 0
    for ev in prof.events():
        if not ev.name.startswith("cudaMemcpy"):
            continue
        total += 1
        chain, p = [], ev.cpu_parent
        while p is not None:
            chain.append(p.name)
            p = p.cpu_parent
        ops = [c for c in chain if c.startswith("aten::")][:3]
        py = [re.sub(r".*vslam_tpu_torch/", "", c) for c in chain
              if "vslam_tpu_torch/" in c][:3]
        sites[" < ".join([ev.name, *ops]) + " @ " + " | ".join(py)] += 1
    return dict(total=total, sites=sites.most_common())


def kernels_first(torch, dev, stream):
    """``chip_smoke.py``'s phases 3-4 on ``stream`` ("default": before
    the switch to the graph stream; "graph": after it), then its phase 6;
    returns phase 6's record (its cached replay's device ms first)."""
    import io

    import chip_smoke
    from vslam_tpu_torch.config import VSLAMConfig
    from vslam_tpu_torch.utils import profiling

    failures = []
    with contextlib.redirect_stdout(io.StringIO()):
        if stream == "graph":
            profiling.use_graph_stream(dev)
        chip_smoke.check_k1(torch, dev, failures)
        chip_smoke.check_k2(torch, dev, VSLAMConfig(), failures)
        _, rec = chip_smoke.run_main_path(torch, dev, failures)
    if failures:
        raise RuntimeError(f"chip_smoke's phases failed: {failures}")
    return dict(rec, median_ms=rec["replay_ms"])


def child(root, out_path, replays, one_stream=False, first=None):
    cmd = [sys.executable, str(Path(__file__).resolve()), "--root",
           str(root), "--captures", "1", "--procs", "0", "--replays",
           str(replays), "--out", out_path, "--quiet"] \
        + (["--one-stream"] if one_stream else []) \
        + (["--kernels-first", first] if first else [])
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if r.returncode != 0:
        raise RuntimeError(f"child failed ({r.returncode}): "
                           f"{r.stderr[-2000:]}")
    with open(out_path) as f:
        return json.load(f)["captures"]


def _line(tag, rec):
    return (f"{tag}: nodes {rec['nodes']}; replay median "
            f"{rec['median_ms']:.4f} ms (min {rec['min_ms']:.4f}, max "
            f"{rec['max_ms']:.4f}, switches at {rec['switches']}); bench "
            f"pattern {rec['bench_ms']:.4f} ms/frame; capture "
            f"{rec['capture_s']:.2f} s")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--captures", type=int, default=8)
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--replays", type=int, default=24)
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--attribute", action="store_true")
    ap.add_argument("--one-stream", action="store_true",
                    help="run everything, warm-up and capture included, "
                    "on one non-default stream")
    ap.add_argument("--kernels-first", choices=("default", "graph"),
                    help="chip_smoke.py's kernel checks on this stream, "
                    "then its direct track_step phase, per process")
    ap.add_argument("--out", default=None)
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        print("graph_modes: no CUDA device", file=sys.stderr)
        return 2
    from vslam_tpu_torch.utils.profiling import nvidia_smi

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = nvidia_smi()
    say = (lambda *a: None) if args.quiet else print
    say(f"graph_modes: root {root}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}; {smi}")
    if args.kernels_first:
        work = tempfile.mkdtemp(prefix="graph_modes_", dir=os.environ.get(
            "TMPDIR"))
        recs = [dict(kernels_first(torch, dev, args.kernels_first),
                     process="main")]
        for j in range(args.procs):
            recs += [dict(r, process=f"child {j}") for r in child(
                root, os.path.join(work, f"child{j}.json"), args.replays,
                first=args.kernels_first)]
        for r in recs:
            say(f"{r['process']}: kernel checks on the {args.kernels_first} "
                f"stream, then phase 6: replay {r['replay_ms']:.4f} device "
                f"ms, {r['ms_frame']:.3f} ms/frame")
        slow = sum(r["replay_ms"] > FAST_SLOW_MS for r in recs)
        say(f"{slow} of {len(recs)} processes in the slow mode (replay > "
            f"{FAST_SLOW_MS} ms; {smi})")
        res = dict(root=str(root), smi=smi, torch=torch.__version__,
                   kernels_first=args.kernels_first, captures=recs)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(res, f, indent=1)
        return 0
    from vslam_tpu_torch.pipeline import scan_driver
    kept_graphs(torch, scan_driver)
    if args.one_stream:
        # every stream the package asks for is this one, and so is the
        # capture stream: no switch between streams anywhere
        one = torch.cuda.Stream()
        torch.cuda.set_stream(one)
        torch.cuda.Stream = lambda *a, **k: one
        torch.cuda.graph.default_capture_stream = one
    from vslam_tpu_torch.utils import profiling
    if hasattr(profiling, "use_graph_stream"):
        # as the package's own entry points do, before the first work on
        # the card (a checkout from before it has none)
        profiling.use_graph_stream(dev)
    cfg, state, frames = workload(torch, dev, 41)
    res = dict(root=str(root), smi=smi, torch=torch.__version__,
               captures=[])
    graphs = []
    work = tempfile.mkdtemp(prefix="graph_modes_", dir=os.environ.get(
        "TMPDIR"))
    for i in range(args.captures):
        g, rec = measure(torch, cfg, state, frames, args.replays,
                         dot_dir=work if i == 0 else None)
        rec["process"] = "main"
        res["captures"].append(rec)
        graphs.append(g)
        say(_line(f"capture {i}", rec))
        if "nodes_dot" in rec:
            say(f"capture {i}: DOT ({rec['dot_bytes']} bytes) nodes "
                f"{rec['nodes_dot']}; agree with the driver: "
                f"{rec['nodes_dot'] == rec['nodes']}")
            say("DOT head: " + rec.get("dot_head", "")[:1500])
    for j in range(args.procs):
        for rec in child(root, os.path.join(work, f"child{j}.json"),
                         args.replays, args.one_stream):
            rec["process"] = f"child {j}"
            res["captures"].append(rec)
            say(_line(f"process {j + 1}", rec))
    med = [c["median_ms"] for c in res["captures"]]
    if med:
        res["spread"] = max(med) / min(med) - 1
        say(f"medians {[round(m, 4) for m in med]}; slowest / fastest - 1 "
            f"= {res['spread']:.4f} ({smi})")
    if args.trace and graphs:
        ms = [c["median_ms"] for c in res["captures"][:len(graphs)]]
        picks = {"fastest": ms.index(min(ms)), "slowest": ms.index(max(ms))}
        res["traces"] = {}
        for tag, i in picks.items():
            t = trace(torch, graphs[i], cfg, state, frames, work)
            t["capture"] = i
            res["traces"][tag] = t
            say(f"trace of the {tag} capture ({i}, median "
                f"{ms[i]:.4f} ms): {json.dumps(t)}")
    del graphs
    if args.attribute:
        res["attribute"] = attribute(torch, cfg, state, frames[0])
        say(f"eager track_step: {res['attribute']['total']} cudaMemcpy* "
            f"calls")
        for k, v in res["attribute"]["sites"]:
            say(f"  {v:5d}  {k}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
