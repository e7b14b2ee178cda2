"""Device time of each kernel of the carried tracking step, grouped by
class, on one GPU.

    python -m vslam_tpu_torch.ops.profile_step [--frames 6] [--device cuda]
        [--trace-dir out/profile_step]

Counterpart of ``vslam_tpu/ops/profile_step.py``, on its workload: the
default ``VSLAMConfig()``, the scene of seed 3 (12000 landmarks, 1 m
steps), 51200 distractors (``normal * [20, 8, 60]``, random descriptors,
from a ``torch.Generator``) inserted with ``frame_idx = 1 << 20``, and
``tools.bench``'s carried loop: ``track_step`` captured as a CUDA graph
(``pipeline.scan_driver.step_graph``) and replayed once per frame. The
warm-up and the capture run outside the trace; then ``--frames`` replays
run under ``utils.profiling.device_trace`` (``torch.profiler``, CUDA
activity). Each trace goes into a new directory made under
``--trace-dir``; nothing there is removed.

The replays' device ms come from CUDA events recorded inside the graph,
first node to last (``ChunkGraph(span=True)``), read after each replay,
over the same frames and RANSAC draws run once untraced just before the
trace: under the profiler the step's ~32000 kernels each add idle time
to a replay, so the traced replays (also printed, with CUDA events
around the traced loop) take longer than the step does.

The reference parses TPU xprof protobufs; here the trace is
``torch.profiler``'s Chrome-trace JSON. ``aggregate_device_ops`` totals
its device events by name (kernels apart from memcpy and memset), and
``classify`` groups CUDA kernel names. A trace of the replays that holds
no kernel event raises: the tool profiles the captured step or nothing.

Printed: the header (frames, kernel and copy totals, the replays'
CUDA-event ms and the kernels' ratio to it, the traced replays' and the
traced window's CUDA-event ms), the by-class table (ms total,
ms/frame, %, kernels/frame), the top 40 kernels (ms, count, ms/frame) and
each stage of ``ops.bench_stages`` captured alone and replayed once under
the trace: its kernels per replay and their device ms (RANSAC's share of
the step's kernels). Exits 2 when
``--device`` names a CUDA device that is not available.
"""
from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import sys
import tempfile

import torch

from ..config import VSLAMConfig
from ..datasets import synthetic
from ..mapping import point_map
from ..pipeline import scan_driver, tracker
from ..utils.profiling import (TRACE_SUFFIX, capture, device_trace,
                               nvidia_smi, use_graph_stream)
from . import bench_stages

# torch.profiler's Chrome-trace categories of device work
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
N_MAP = 51200


def aggregate_device_ops(trace_dir: str):
    """Total the device events of the Chrome traces under ``trace_dir``.
    Returns (ms, count, by_cat): {event name: total ms}, {event name:
    events} and {category: total ms} over ``DEVICE_CATS`` (host events,
    such as ``cpu_op`` and ``cuda_runtime``, are ignored)."""
    paths = glob.glob(os.path.join(trace_dir, "**", "*" + TRACE_SUFFIX),
                      recursive=True)
    if not paths:
        raise FileNotFoundError(f"no *{TRACE_SUFFIX} under {trace_dir}")
    ms, cnt, by_cat = (collections.Counter() for _ in range(3))
    for p in paths:
        with open(p) as f:
            events = json.load(f).get("traceEvents", [])
        for ev in events:
            cat = ev.get("cat")
            if cat in DEVICE_CATS and ev.get("ph") == "X":
                dur = float(ev.get("dur", 0.0)) / 1000.0      # us -> ms
                ms[ev["name"]] += dur
                cnt[ev["name"]] += 1
                by_cat[cat] += dur
    return ms, cnt, by_cat


# (substrings of a lower-cased kernel name, group), first match wins
_GROUPS = (
    (("hamming_kernel",), "K1 hamming"),
    (("associate_kernel",), "K2 associate"),
    (("jacobi_kernel",), "J jacobi"),
    (("sampson_kernel",), "G sampson_gn"),
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
    """The class of a CUDA kernel (or memcpy / memset) name: the four hand
    kernels by their symbols, then gemm (cuBLAS, CUTLASS), sort (cub's
    radix sorts), index / scatter / gather, reduce / scan, cat / copy,
    elementwise; else ``other``."""
    low = name.lower()
    for subs, group in _GROUPS:
        if any(s in low for s in subs):
            return group
    return "other"


def by_class(ms, count):
    """``aggregate_device_ops``' totals by ``classify`` group: ({group: ms},
    {group: events})."""
    ms_g, n_g = collections.Counter(), collections.Counter()
    for k, v in ms.items():
        ms_g[classify(k)] += v
        n_g[classify(k)] += count[k]
    return ms_g, n_g


def n_kernels(count) -> int:
    """The kernel events of an ``aggregate_device_ops`` count (memcpy and
    memset left out)."""
    return sum(c for k, c in count.items()
               if classify(k) not in ("memcpy", "memset"))


def workload(device, n_frames: int):
    """The reference's workload on ``device``: (cfg, state with the live map
    at 51200 distractors, (n_frames, H, W) frames)."""
    cfg = VSLAMConfig()
    K = cfg.camera.K()
    W, H = cfg.camera.width, cfg.camera.height
    scene = synthetic.make_scene(num_points=12000, seed=3,
                                 extent=(80, 15, 160), z_min=5.0)
    poses = synthetic.make_trajectory(n_frames + 1, step=1.0, seed=3)
    frames = synthetic.render_sequence(K, poses, scene, W, H)
    state = tracker.bootstrap(frames[0], cfg, device)
    gen = torch.Generator(device=device).manual_seed(11)
    scale = torch.tensor([20.0, 8.0, 60.0], device=device)
    xyz = torch.randn((N_MAP, 3), generator=gen, device=device) * scale
    desc = torch.randint(-2 ** 31, 2 ** 31, (N_MAP, 8), generator=gen,
                         device=device, dtype=torch.int32)
    m = point_map.insert_points(
        state.map, xyz, torch.zeros_like(xyz), desc,
        torch.ones((N_MAP,), dtype=torch.bool, device=device),
        frame_idx=1 << 20)
    return cfg, state.replace(map=m), torch.from_numpy(frames[1:]).to(device)


def _traced(device, trace_dir: str, fn):
    """Run ``fn`` under ``device_trace`` into a new directory made under
    ``trace_dir`` (nothing already there is touched), with CUDA events
    around it on a card. Returns (event ms, None off a card;
    aggregate_device_ops of that directory)."""
    os.makedirs(trace_dir, exist_ok=True)
    out = tempfile.mkdtemp(prefix="trace_", dir=trace_dir)
    cuda = torch.device(device).type == "cuda"
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)] \
        if cuda else None
    if cuda:
        torch.cuda.synchronize()
    with device_trace(out):
        if cuda:
            ev[0].record()
        fn()
        if cuda:
            ev[1].record()
            torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]) if cuda else None, \
        aggregate_device_ops(out)


def profile(device, n_frames: int = 6, trace_dir: str = "out/profile_step"):
    """Profile ``n_frames`` graph replays of the carried step at map 51200.
    Returns a dict: ``header``, ``ms`` / ``count`` by kernel name,
    ``by_cat``, ``event_ms`` (the replays' device ms, untraced: CUDA
    events inside the graph, summed over the replays), ``traced_ms`` (the
    same under the trace), ``window_ms`` (CUDA events around the traced
    loop), ``kernel_ms`` and ``n_frames``. Raises when the trace of the
    replays holds no kernel event."""
    use_graph_stream(device)
    cfg, state, frames = workload(device, n_frames)
    graph = scan_driver.step_graph(cfg, span=True)
    # warm-up and capture
    scan_driver.carried(state, frames, cfg, graph)[1].cpu()
    draws = state.key.get_state()

    def replays(spans):              # the same RANSAC draws in each run
        state.key.set_state(draws)
        s = state
        for t in range(n_frames):
            s, rows = scan_driver.carried(s, frames[t:t + 1], cfg, graph)
            rows.cpu()
            spans.append(graph.span_ms())
    untraced, traced = [], []
    replays(untraced)
    window_ms, (ms, cnt, by_cat) = _traced(device, trace_dir,
                                           lambda: replays(traced))
    event_ms, traced_ms = sum(untraced), sum(traced)
    if by_cat["kernel"] == 0:
        raise RuntimeError(f"no kernel events in the trace of the graph "
                           f"replays under {trace_dir}")
    kernel_ms = by_cat["kernel"]
    header = (f"profile_step: graph track_step, {n_frames} frames, map "
              f"{N_MAP}; kernels {kernel_ms:.3f} ms "
              f"({kernel_ms / n_frames:.3f} ms/frame, "
              f"{n_kernels(cnt) / n_frames:.0f} kernels/frame), memcpy "
              f"{by_cat['gpu_memcpy']:.3f} ms, memset "
              f"{by_cat['gpu_memset']:.3f} ms; replays {event_ms:.3f} ms "
              f"untraced (CUDA events in the graph), kernels / replays "
              f"{kernel_ms / event_ms:.4f}; traced replays "
              f"{traced_ms:.3f} ms, traced window {window_ms:.3f} ms "
              f"({nvidia_smi()})")
    return dict(header=header, ms=ms, count=cnt, by_cat=by_cat,
                event_ms=event_ms, traced_ms=traced_ms, window_ms=window_ms,
                kernel_ms=kernel_ms, n_frames=n_frames)


def stage_kernels(device, trace_dir: str = "out/profile_step/stages"):
    """Each stage of ``ops.bench_stages`` (the whole steps left out) at map
    51200, captured alone and replayed once under the trace. Returns
    [(stage, kernels, kernel ms, {class: kernels})]."""
    rows = []
    for name, fn, gens in bench_stages.stages(device, N_MAP):
        if name.startswith("track_step"):
            continue
        g = capture(fn, gens)
        _, (ms, cnt, by_cat) = _traced(device, trace_dir, g.replay)
        rows.append((name, n_kernels(cnt), by_cat["kernel"],
                     dict(by_class(ms, cnt)[1])))
    return rows


def print_stages(rows, file=sys.stdout) -> None:
    """``stage_kernels``' rows, one line each."""
    print("\n== stages alone, one replay (kernels | kernel ms | kernels by "
          "class) ==", file=file)
    for name, k, v, classes in rows:
        print(f"{name:40s} {k:6d} {v:9.3f}  " + ", ".join(
            f"{c} {x}" for c, x in sorted(classes.items(),
                                          key=lambda kv: -kv[1])),
              file=file)


def print_tables(res: dict, file=sys.stdout) -> None:
    """The reference's two tables: by class and the top 40 kernels."""
    ms, cnt, n = res["ms"], res["count"], res["n_frames"]
    total = sum(ms.values())
    by_group, n_group = by_class(ms, cnt)
    print("\n== by class (ms total | ms/frame | % | events/frame) ==",
          file=file)
    for g, v in by_group.most_common():
        print(f"{g:22s} {v:9.3f} {v / n:8.3f} {100 * v / total:5.1f}% "
              f"{n_group[g] / n:8.1f}", file=file)
    print("\n== top 40 kernels (ms total | count | ms/frame) ==", file=file)
    for k, v in ms.most_common(40):
        print(f"{v:9.3f} {cnt[k]:6d} {v / n:8.4f}  {k[:110]}", file=file)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--device", default="cuda", help="a CUDA device")
    ap.add_argument("--trace-dir", default="out/profile_step")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        print(f"profile_step: {args.device} is not an available CUDA "
              f"device", file=sys.stderr)
        return 2
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    torch.cuda.set_device(dev)
    res = profile(dev, args.frames, args.trace_dir)
    print(res["header"])
    print_tables(res)
    print_stages(stage_kernels(dev, os.path.join(args.trace_dir, "stages")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
