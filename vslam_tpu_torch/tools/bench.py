"""Steady-state tracking throughput on one GPU: frames/s of the carried
``track_step`` with a live map of 0, 51200 and 120000 points.

    python -m vslam_tpu_torch.tools.bench [--seed S] [--rng torch|threefry]
        [--n-timed 40] [--device cuda]

Counterpart of the repository's ``bench.py``, on its workload: the default
``VSLAMConfig()`` (KITTI-shaped 1248x384 frames, 3072 keypoints, 1024
RANSAC hypotheses, map capacity 131072 x 4 archive slots), a scene of
12000 landmarks seeded by ``--seed``, 1 m steps, ``n_timed + 2`` frames
rendered on the host.

  * The carried loop (``scan_driver.carried``) is bench.py's ``lax.scan``
    of ``tracker.track_step``: the step alone, with no keyframe insert and
    no maintenance (``scan_driver.step_body``). On a card it replays
    ``scan_driver.step_graph``, a ``ChunkGraph`` of that body: captured
    once as a CUDA graph on static buffers,
    replayed once per frame with frame ``t`` copied into its slot from a
    ``(T, H, W)`` device tensor, the per-frame rows (``scan_driver.pack``)
    written to a device buffer that the host fetches once per batch, and
    no host sync allowed inside the replay loop. On the CPU it is a Python
    loop over the same body.
  * Before each timed segment the live map is filled with ``prepopulate``:
    corridor landmarks with random descriptors (they never pass the
    Hamming gate, so tracking is unaffected) whose ``last_seen`` lies far
    in the future, so ``cull_stale`` never retires them. With ``--rng
    threefry`` the fill and the RANSAC stream are the reference's own
    draws (``utils.threefry``); with ``torch`` (the default) they come
    from ``torch.Generator``s.
  * ``timed``: the minimum of 3 runs of ``n_timed / 2`` frames and of 3
    runs of ``n_timed`` frames, the two lengths taken in turn, each on a
    perturbed RANSAC stream, timed on the host clock through the fetch of
    the per-frame rows; frames/s = ``(n/2) / (t_full - t_half)``. Taken in
    turn, a change in the step's speed partway through a segment would
    reach both lengths' minima rather than only the later length's. The
    warm-up runs first on another sequence and pays for the capture,
    which never enters a timed window. On a card each run is also timed
    by CUDA events, which gives the replays' device ms per frame by the
    same differencing, and each run's own device ms per frame.

Per segment, stderr gets bench.py's line (``segment_line``), the device
ms (differenced, and each run's in the order run: the same graph runs in
one of two modes, PERF.md §6, and a switch shows there), the graph's
nodes by type, and nvidia-smi's clocks, temperature and clock-event
reasons read before and after it. stdout gets one JSON line with
bench.py's keys plus ``device`` (``utils.profiling.device_record``),
after ``check`` holds the run to bench.py's asserts. Exits 2 when
``--device`` names a CUDA device that is not available, 1 when ``check``
fails.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional

import numpy as np
import torch

from ..config import VSLAMConfig
from ..datasets import synthetic
from ..mapping import point_map
from ..parallel import sharded_map
from ..pipeline import scan_driver, tracker
from ..utils import threefry
from ..utils.profiling import (clocks, device_record, synchronize,
                               use_graph_stream)
from . import device_arg

# bench.py's workload
SCENE = dict(num_points=12000, extent=(80, 15, 160), z_min=5.0)
STEP = 1.0
FILLS = {"map0": 0, "map51k": 51200, "map120k": 120000}
DISTRACTOR_EXTENT = (50, 10)
DISTRACTOR_Z = (2.0, 180.0)
FAR_FUTURE = 1 << 20
BASELINE_FPS = 30.0
NOTE = ("steady-state: full association vs a 51k-point live map inside "
        "the timed region")


def distractors(n: int, extent=DISTRACTOR_EXTENT, z_range=DISTRACTOR_Z, *,
                generator: Optional[torch.Generator] = None,
                key: Optional[torch.Tensor] = None, device="cuda"):
    """bench.py's ``_distractors``: ``n`` landmarks in the corridor |x| <
    extent[0], |y| < extent[1], z in ``z_range``, with random descriptors.
    From ``key`` (a ``utils.threefry`` key) they are the reference's draws
    bit for bit (``split``, ``uniform``, ``bits``, then float32 arithmetic
    op by op, as bench.py's eager jax ops round it); else from
    ``generator``.
    Returns xyz (n, 3) float32 and the descriptors' uint32 words viewed as
    int32 (n, 8), made on ``device``."""
    if key is not None:
        k1, k2 = threefry.split(key.to(device))
        u = threefry.uniform(k1, (n, 3))
        words = threefry.bits(k2, (n, 8))
        desc = torch.where(words >= 1 << 31, words - (1 << 32),
                           words).to(torch.int32)
    else:
        u = torch.rand((n, 3), generator=generator, device=device)
        desc = torch.randint(-2 ** 31, 2 ** 31, (n, 8), generator=generator,
                             device=device, dtype=torch.int32)
    xyz = torch.stack([
        (u[:, 0] * 2 - 1) * extent[0],
        (u[:, 1] * 2 - 1) * extent[1],
        z_range[0] + u[:, 2] * (z_range[1] - z_range[0]),
    ], dim=1)
    return xyz, desc


def prepopulate(state: tracker.TrackerState, n: int, seed: int,
                rng: str = "torch") -> tracker.TrackerState:
    """bench.py's ``prepopulate``: ``n`` distractors drawn from seed
    ``seed + n`` inserted with ``frame_idx = 1 << 20``; rows past the map's
    capacity are dropped, as in the reference."""
    if n == 0:
        return state
    dev = state.pose.device
    if rng == "threefry":
        src = dict(key=threefry.key(seed + n, dev))
    else:
        src = dict(generator=torch.Generator(device=dev).manual_seed(seed + n))
    xyz, desc = distractors(n, device=dev, **src)
    m = point_map.insert_points(
        state.map, xyz, torch.zeros_like(xyz), desc,
        torch.ones((n,), dtype=torch.bool, device=dev), frame_idx=FAR_FUTURE)
    return state.replace(map=m)


def perturbed(state: tracker.TrackerState, rep: int):
    """bench.py's per-rep ``fold_in(key, rep)``: every timed run tracks on
    a fresh RANSAC stream."""
    if isinstance(state.key, torch.Generator):
        return state.replace(key=torch.Generator(
            device=state.key.device).manual_seed(
                state.key.initial_seed() + 1 + rep))
    return state.replace(key=threefry.fold_in(state.key, rep))


def timed(state: tracker.TrackerState, frames, cfg: VSLAMConfig,
          graph: Optional[scan_driver.ChunkGraph], n_timed: int) -> dict:
    """bench.py's ``timed``: min of 3 runs over ``n_timed // 2`` frames
    and over ``n_timed`` frames, the lengths in turn, differenced. Returns
    fps, the raw times (s), the last full run's rows (host
    ``ChunkScalars``) and, on a card, ``replay_ms``: device ms per frame
    from CUDA events, differenced the same way, and ``run_ms``: each run's
    own device ms per frame, in the order run (a change of the step's
    speed between runs shows there)."""
    dev = state.pose.device
    cuda = dev.type == "cuda"
    half = n_timed // 2

    def once(n, rep):
        s = perturbed(state, rep)
        synchronize(dev)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)] \
            if cuda else None
        t0 = time.perf_counter()
        if cuda:
            ev[0].record()
        _, rows = scan_driver.carried(s, frames[:n], cfg, graph)
        if cuda:
            ev[1].record()
        rows = rows.cpu()                  # the fetch waits for the work
        dt = time.perf_counter() - t0
        return dt, ev[0].elapsed_time(ev[1]) if cuda else None, rows

    runs = [once(n, r) for r, n in enumerate([half, n_timed] * 3)]
    halves, fulls = runs[0::2], runs[1::2]
    t_half = min(h[0] for h in halves)
    t_full = min(f[0] for f in fulls)
    # a collapsed difference would explode the rate silently
    if not t_full - t_half > 0.2 * t_half:
        raise AssertionError(("degenerate batch-count differencing",
                              t_full, t_half))
    out = dict(fps=half / (t_full - t_half), t_half=t_half, t_full=t_full,
               rows=scan_driver.ChunkScalars.unpack(fulls[-1][2].numpy()),
               replay_ms=None, run_ms=None)
    if cuda:
        out["replay_ms"] = (min(f[1] for f in fulls)
                            - min(h[1] for h in halves)) / half
        out["run_ms"] = [r[1] / n for r, n in zip(runs, [half, n_timed] * 3)]
    return out


def segment_line(label: str, seg: dict) -> str:
    """bench.py's per-segment stderr line."""
    return (f"{label}: fps={seg['fps']:.2f} success={seg['success']}/"
            f"{seg['frames']} median_inliers={seg['median_inliers']} "
            f"final_map={seg['final_map']}")


def _clock_text(c: dict) -> str:
    return ", ".join(f"{k} {v}" for k, v in c.items())


def sequence(device, cfg: VSLAMConfig, seed: int, traj_seed: int,
             n_frames: int, rng: str = "torch"):
    """bench.py's scene of ``seed`` seen along the trajectory of
    ``traj_seed``: (the bootstrapped state of its first frame, the other
    ``n_frames - 1`` frames as a (T, H, W) tensor on ``device``)."""
    scene = synthetic.make_scene(seed=seed, **SCENE)
    fr = synthetic.render_sequence(
        cfg.camera.K(), synthetic.make_trajectory(n_frames, step=STEP,
                                                  seed=traj_seed),
        scene, cfg.camera.width, cfg.camera.height)
    return (tracker.bootstrap(fr[0], cfg, device, rng=rng),
            torch.from_numpy(fr[1:]).to(device))


def capture_modes(device, captures: int, seed: int = 17,
                  n_map: int = FILLS["map51k"], replays: int = 24,
                  cfg: Optional[VSLAMConfig] = None, mesh=None) -> list:
    """Read the mode of ``captures`` fresh captures of the carried step
    (``scan_driver.step_graph(span=True)``) on a card: bench's scene of
    ``seed``, a live map of ``n_map`` points, ``replays`` frames replayed
    one by one from the same state and RANSAC draws for each capture.
    With ``mesh`` (capturable, carrying ``cfg.mesh.axis_map``) the step is
    the sharded one, on this rank's block of that map. Returns one dict
    per capture: ``nodes`` (the graph's nodes by type), ``capture_s``,
    ``span_ms`` (each replay's device ms, CUDA events inside the graph)
    and their ``median_ms``."""
    use_graph_stream(device)
    cfg = cfg or VSLAMConfig()
    axis = cfg.mesh.axis_map
    state, frames = sequence(device, cfg, seed, seed, replays + 1)
    state = prepopulate(state, n_map, seed)
    if mesh is not None:
        state = state.replace(map=sharded_map.shard_map_state(
            mesh, axis, state.map))
    draws = state.key.get_state()
    out = []
    for _ in range(captures):
        g = scan_driver.step_graph(cfg, span=True, mesh=mesh, map_axis=axis)
        spans = []
        state.key.set_state(draws)
        s = state
        for t in range(replays):
            s, rows = scan_driver.carried(s, frames[t:t + 1], cfg, g,
                                          mesh=mesh, map_axis=axis)
            rows.cpu()
            spans.append(g.span_ms())
        out.append(dict(nodes=g.nodes, capture_s=g.capture_s,
                        span_ms=spans, median_ms=float(np.median(spans))))
        del g
    return out


def run(device, seed: int, rng: str = "torch", n_timed: int = 40,
        cfg: Optional[VSLAMConfig] = None, fills=None, log=None):
    """bench.py's three segments on ``device``. Returns (report, segments,
    graph): the JSON line's dict, {label: segment} with each segment's
    fps, success count, frames, median inliers, final map size, raw times,
    device ms (differenced, and each run's), the graph's nodes by type and
    the clocks, and the ``scan_driver.step_graph`` (None on the CPU).
    ``cfg`` and ``fills`` ({label: distractors}, ``FILLS``'s labels)
    shrink the run for tests; the per-segment lines go to ``log`` (stderr
    when None)."""
    log = log or sys.stderr
    device = torch.device(device)
    use_graph_stream(device)
    cfg = cfg or VSLAMConfig()
    fills = FILLS if fills is None else fills
    state0, frames = sequence(device, cfg, seed, seed, n_timed + 2, rng)
    # the warm-up (and the capture) on a different sequence
    st_w, warm = sequence(device, cfg, seed, seed + 1, n_timed + 2, rng)
    graph = scan_driver.step_graph(cfg) if device.type == "cuda" else None
    for n in (n_timed // 2, n_timed):
        scan_driver.carried(st_w, warm[:n], cfg, graph)[1].cpu()
    del st_w, warm

    segments = {}
    for label, n_pre in fills.items():
        state = prepopulate(state0, n_pre, seed, rng)
        synchronize(device)
        c0 = clocks(device)
        r = timed(state, frames, cfg, graph, n_timed)
        c1 = clocks(device)
        rows = r["rows"]
        seg = dict(fps=r["fps"], success=int(rows.success.sum()),
                   frames=n_timed,
                   median_inliers=int(np.median(rows.num_inliers)),
                   final_map=int(rows.map_size[-1]), t_half=r["t_half"],
                   t_full=r["t_full"], replay_ms=r["replay_ms"],
                   run_ms=r["run_ms"], clocks_before=c0, clocks_after=c1,
                   nodes=graph.nodes if graph is not None else None)
        segments[label] = seg
        print(segment_line(label, seg), file=log)
        if seg["replay_ms"] is not None:
            print(f"{label}: replay {seg['replay_ms']:.4f} device ms/frame "
                  f"(CUDA events, differenced), host "
                  f"{1e3 / seg['fps']:.4f} ms/frame; each run's device "
                  f"ms/frame (half, full, ...): "
                  + ", ".join(f"{m:.4f}" for m in seg["run_ms"]), file=log)
            print(f"{label}: graph nodes {seg['nodes']}", file=log)
        if c0:
            print(f"{label}: clocks before: {_clock_text(c0)}; after: "
                  f"{_clock_text(c1)}", file=log)
        del state

    s51, s0, s120 = (segments[k] for k in ("map51k", "map0", "map120k"))
    report = {
        "metric": "frames_per_sec_per_chip",
        "value": round(s51["fps"], 3),
        "unit": "frames/s",
        "vs_baseline": round(s51["fps"] / BASELINE_FPS, 3),
        "note": NOTE,
        "final_map": s51["final_map"],
        "raw_t_half_s": round(s51["t_half"], 4),
        "raw_t_full_s": round(s51["t_full"], 4),
        "fps_from_scratch": round(s0["fps"], 3),
        "fps_map120k": round(s120["fps"], 3),
        "final_map_120k": s120["final_map"],
        "device": device_record(device),
    }
    return report, segments, graph


def check(report: dict, segments: dict) -> None:
    """bench.py's asserts: in each segment more than 80% of frames tracked
    and a median inlier count above 50; the headline's map holds at least
    50000 points. Raises AssertionError."""
    bad = []
    for label, s in segments.items():
        if not s["success"] / s["frames"] > 0.8:
            bad.append(f"{label}: success {s['success']}/{s['frames']}")
        if not s["median_inliers"] > 50:
            bad.append(f"{label}: median inliers {s['median_inliers']}")
    if not report["final_map"] >= 50000:
        bad.append(f"final_map {report['final_map']} < 50000")
    if bad:
        raise AssertionError("; ".join(bad))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=None,
                    help="scene seed (default: the clock's, as bench.py)")
    ap.add_argument("--rng", choices=tracker.RNGS, default="torch")
    ap.add_argument("--n-timed", type=int, default=40)
    ap.add_argument("--device", default="cuda",
                    help="cuda, cuda:N or cpu (default cuda)")
    args = ap.parse_args(argv)
    dev = device_arg("bench", args.device)
    if dev is None:
        return 2
    seed = int(time.time()) % 100000 if args.seed is None else args.seed
    print(f"run_seed={seed}", file=sys.stderr)
    report, segments, _ = run(dev, seed, args.rng, args.n_timed)
    try:
        check(report, segments)
    except AssertionError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 1
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
