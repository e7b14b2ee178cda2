#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``vslam_tpu_torch``) on one GPU.

Run from the repository root: ``python3 chip_smoke.py``. Phases, in order
(any failure exits nonzero):

  1. the card: torch's device name, and nvidia-smi's name and power limit;
  2. build the CUDA kernels from ``vslam_tpu_torch/csrc`` (nvcc, first use);
  3. kernel K1 (Hamming matrix) vs its plain torch version: random
     descriptors at 3072 x 3072 and at ragged shapes, exact; its time with
     the L2 cache warm and flushed, its bound, and torch.cdist(p=0) on the
     bit planes as the library yardstick (checked equal);
     kernel, plain and library times are of single calls, each between
     two CUDA events after a spin that hides the host's enqueue
     (``_time_each_ms``); the kernels' back-to-back mean (``_time_ms``,
     earlier records' timer) is printed beside them;
  4. kernel K2 (search-by-projection) vs its plain version: capacity
     131072 holding 51200, then 120000, corridor distractors plus planted
     near-duplicates (hits in both tiers), 3072 keypoints, exact; its time
     and bound at each size; then a flood (every pair inside the gate) that
     overflows the kernel's queues in every block, exact;
  5. the tracking step on CUDA vs on the CPU (plain versions), small
     config, the same injected RANSAC samples, per-frame tolerances;
  6. the tracking step: bootstrap + 11 ``track_step`` of the default config
     (1248x384, 3072 keypoints, 1024 hypotheses, map capacity 131072) on
     CUDA, after a warm-up. Launch counters are reset just before and read
     just after; the steps must not synchronize with the host; at least 80%
     of frames must succeed, the median inlier count must exceed 50 and the
     map must grow. Prints ms/frame.
  7. map maintenance (``evict_lru``, ``compact``, ``remap_ids``) on phase
     4's map, CUDA against the CPU, exact;
  8. the main path: ``SLAMSystem.process`` of the default config over 31
     frames (6 keyframes, the window-BA attempt at keyframe 5), then
     ``run_global_ba``. Counters reset just before, read just after; at
     most 2 host syncs per ordinary frame, >= 80% of frames tracked,
     ATE < 0.5, global BA lowers its cost with nothing truncated, and the
     whole state stays float32 on the card. Prints ms/frame by frame kind
     and the BA event's outcome;
  9. the full-width window BA problem (20 cameras x 8192 points x 16
     observation slots) solved on CUDA and on the CPU: costs within 1e-4
     (initial) and 1e-3 (final) relative, equal accept flags. Prints ms per
     solve and per LM iteration, window and global (CUDA events);
 10. the bounded-map scenario of tests/test_map_lifecycle.py on CUDA
     (capacity 512, 24 frames): maintenance runs, no insert drops;
 11. the chunked driver at full width: ``SLAMSystem.process_chunk`` over
     phase 8's frames (bootstrap + 25, then 5), the frame body one CUDA
     graph replayed per frame. Held to phase 8 frame by frame (flags equal,
     inliers and map size within 2, poses to 1e-3 / 5e-3, the BA event's
     outcome); no host sync inside the replay loop (``"error"`` mode); K1
     and K2 captured once per frame body. Prints capture seconds, the graph
     pool's peak, chunked ms/frame beside phase 8's, the graph's device
     ms per replay and maintenance's cost inside a graph;
 12. maintenance and rendering inside the graph: phase 10's run through
     chunks (maintenance at phase 10's frames, no drops), 12 frames drawn
     by ``render_frame_device`` inside the graph (>= 9 of 11 tracked), and
     the renderer on the card against its CPU run;
 13. the front-end variants at full width (the default config with
     ``oriented`` and ``track_carry`` on) on phase 8's frames:
     ``detect_with_carry``, ``orientation_map`` and steered ``describe``
     on the card against the CPU (masks equal, angles to 1e-5 rad where
     the moment is not tiny, descriptor bits equal except at detected
     rounding ties, whose count it prints); ``process`` over the 31
     frames held as phase 8 is; ``process_chunk`` over them held to that
     run frame by frame as phase 11 holds phase 8 (0 syncs in the replay
     loop); ``ops.bench_kernels``' Hamming formulations equal to K1 on
     the card.

Each phase prints its seconds. The line before the last but one is one
JSON object per kernel (route, source, the TPU kernel it replaces, launches
on the main path of phase 8, on the tracking step of phase 6, in phase
11's chunks (captured launches times replays) and in phase 13's two runs,
max |error|
vs the plain version, kernel, plain and library times, and the bound with
what bounds it); then the nvidia-smi line; the
last line is ``{"ok": true, "device": {...}}``. No GPU: exits 2 and prints
no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import warnings

import numpy as np


def _smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else \
        f"nvidia-smi failed: {r.stderr.strip()}"


def _count_sass(lib, opcode: str):
    """How often ``opcode`` appears in the SASS of a built library
    (cuobjdump from the CUDA toolkit); None where cuobjdump is missing."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        r = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                           text=True, timeout=120)
    except OSError:
        return None
    return r.stdout.count(opcode) if r.returncode == 0 else None


def _time_ms(torch, fn, reps: int = 20) -> float:
    """Mean device time of fn() over reps launches (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _time_each_ms(torch, fn, reps: int = 20, before=None) -> float:
    """Mean device time of single calls of fn(), each between two CUDA
    events. Before each call runs ``before()`` (if given), then a ~0.2 ms
    spin that touches no memory keeps the card busy while the host
    enqueues, so the wrapper's host overhead never enters the timed
    window."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        if before is not None:
            before()
        torch.cuda._sleep(400_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.mean([a.elapsed_time(b) for a, b in pairs]))


# The card's peaks (NVIDIA's H100 SXM data sheet, dense, at 700 W): the
# bounds below are the larger of bytes / HBM rate and operations / peak.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
INT8_OPS_PER_S = 1979e12


def _bound(n_bytes, n_ops, ops_per_s):
    """(bound_ms, what bounds it)."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _flip_bits(rng, words_i32, n_bits):
    """Flip n distinct random bits of one (8,) int32 descriptor."""
    bits = np.unpackbits(words_i32.view(np.uint8), bitorder="little")
    pos = rng.choice(256, n_bits, replace=False)
    bits[pos] ^= 1
    return np.packbits(bits, bitorder="little").view(np.int32)


def check_k1(torch, dev, failures):
    """Phase 3: K1 exact against its plain version at the main path's 3072
    x 3072 and at ragged shapes (edges of the 16 x 8 mma tile, of the 16 x
    128 block tile and of the 16-byte store); its time with the L2 cache
    warm (repeated launches) and flushed, its bound, and torch.cdist(p=0)
    on the {0,1} bit planes as the library yardstick."""
    from vslam_tpu_torch.frontend.descriptors import unpack_bits
    from vslam_tpu_torch.ops import hamming

    rng = np.random.RandomState(0)
    err, big = 0, None
    for n1, n2 in ((3072, 3072), (100, 300), (1, 129), (17, 9), (3071, 3073),
                   (16, 3072)):
        d1 = torch.from_numpy(rng.randint(-2**31, 2**31, (n1, 8),
                                          dtype=np.int64).astype(np.int32))
        d2 = torch.from_numpy(rng.randint(-2**31, 2**31, (n2, 8),
                                          dtype=np.int64).astype(np.int32))
        d1, d2 = d1.to(dev), d2.to(dev)
        got = hamming.hamming_cuda(d1, d2)
        want = hamming.hamming_plain(d1, d2)
        torch.cuda.synchronize()
        e = int((got - want).abs().max())
        err = max(err, e)
        print(f"K1 {n1}x{n2}: max|kernel - plain| = {e}")
        if e != 0:
            failures.append(f"K1 disagrees at {n1}x{n2}")
        if big is None:
            big = (d1, d2)
    n1, n2 = (t.shape[0] for t in big)
    kernel = lambda: hamming.hamming_cuda(*big)
    ms = _time_each_ms(torch, kernel)
    ms_b2b = _time_ms(torch, kernel)
    # reading 256 MB leaves the L2 holding other, clean lines: the output's
    # lines miss, and no write-back of someone else's data is charged to K1
    scrub = torch.ones(256 * 2**20 // 4, dtype=torch.int32, device=dev)
    ms_flushed = _time_each_ms(torch, kernel, before=scrub.sum)
    del scrub
    plain_ms = _time_each_ms(torch, lambda: hamming.hamming_plain(*big))
    out_bytes, in_bytes = 4 * n1 * n2, 32 * (n1 + n2)
    bound_ms, bound_by = _bound(out_bytes + in_bytes, 2 * 256 * n1 * n2,
                                INT8_OPS_PER_S)
    l2 = getattr(torch.cuda.get_device_properties(dev), "L2_cache_size", 0)
    print(f"K1 {n1}x{n2}: kernel {ms:.4f} ms with the L2 warm, "
          f"{ms_flushed:.4f} ms with it flushed (256 MB read before each "
          f"launch), plain {plain_ms:.4f} ms (single calls); kernel "
          f"{ms_b2b:.4f} ms back to back")
    print(f"K1 bound {bound_ms:.4f} ms ({bound_by}: "
          f"{(out_bytes + in_bytes) / 1e6:.2f} MB at 3.35 TB/s; the bit "
          f"product {2 * 256 * n1 * n2 / 1e9:.2f} G ops at 1979 TOP/s takes "
          f"{2 * 256 * n1 * n2 / INT8_OPS_PER_S * 1e3:.4f} ms); share "
          f"{bound_ms / ms:.2f} warm, {bound_ms / ms_flushed:.2f} flushed")
    print(f"K1 output {out_bytes / 1e6:.2f} MB, L2 {l2 / 1e6:.2f} MB: "
          + ("repeated launches beat the HBM bound, so they find the output "
             "resident in L2" if ms < bound_ms else
             "repeated launches do not beat the HBM bound (the output is "
             "not served from L2)"))
    a = unpack_bits(big[0]).to(torch.float32)
    b = unpack_bits(big[1]).to(torch.float32)
    lib = torch.cdist(a, b, p=0)
    same = bool(torch.equal(lib.to(torch.int32), hamming.hamming_cuda(*big)))
    library_ms = _time_each_ms(torch, lambda: torch.cdist(a, b, p=0), reps=5)
    print(f"K1 library: torch.cdist(p=0) on (3072, 256) f32 bit planes "
          f"{library_ms:.4f} ms (unpacking outside the window), equal to "
          f"K1: {same}")
    if not same:
        failures.append("torch.cdist(p=0) disagrees with K1")
    return dict(max_abs_err=err, ms=ms, ms_l2_flushed=ms_flushed,
                ms_back_to_back=ms_b2b, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


def k2_inputs(torch, dev, cfg, n_map=51200, seed=1):
    """Kernel K2's inputs at the main path's shapes: capacity 131072 with
    ``n_map`` random-descriptor distractors along the corridor (as bench.py
    builds them) and 600 points with planted near-duplicate keypoints."""
    from vslam_tpu_torch.core import camera as cam
    from vslam_tpu_torch.core.types import empty_map
    from vslam_tpu_torch.mapping import point_map

    rng = np.random.RandomState(seed)
    C, K = cfg.map.capacity, cfg.map.obs_per_point
    N = cfg.frontend.max_keypoints
    W, H = cfg.camera.width, cfg.camera.height
    n_plant, frame = 600, 20
    xyz = np.stack([rng.uniform(-50, 50, n_map), rng.uniform(-10, 10, n_map),
                    rng.uniform(2.0, 180.0, n_map)], 1).astype(np.float32)
    desc = rng.randint(-2**31, 2**31, (n_map, 8), dtype=np.int64)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    m = empty_map(C, K, dev)
    m = point_map.insert_points(
        m, t(xyz), torch.zeros((n_map, 3), device=dev),
        t(desc.astype(np.int32)), torch.ones(n_map, dtype=torch.bool,
                                             device=dev),
        frame_idx=torch.zeros((), dtype=torch.int32, device=dev))
    Kc = torch.from_numpy(cfg.camera.K()).to(dev)
    P = cam.projection_matrix(Kc, torch.eye(4, device=dev))
    muv, vis = point_map.project_map(m, P, W, H)
    vis_idx = np.flatnonzero(vis.cpu().numpy())
    plant = rng.choice(vis_idx, n_plant, replace=False)
    # two later observations of every planted point: slots 1 and 2 in use
    for _ in range(2):
        obs = rng.randint(-2**31, 2**31, (n_plant, 8), dtype=np.int64)
        m = point_map.add_observations(
            m, t(plant.astype(np.int32)), t(obs.astype(np.int32)),
            torch.ones(n_plant, dtype=torch.bool, device=dev),
            torch.zeros((), dtype=torch.int32, device=dev))
    last = np.zeros(C, np.int32)
    last[:n_map] = frame - rng.randint(0, 16, n_map)     # ages 0..15
    m = m.replace(last_seen=t(last))

    arch = m.desc.cpu().numpy()
    uv_map = muv.cpu().numpy()
    kp_uv = np.stack([rng.uniform(0, W, N), rng.uniform(0, H, N)],
                     1).astype(np.float32)
    kp_desc = rng.randint(-2**31, 2**31, (N, 8),
                          dtype=np.int64).astype(np.int32)
    for j, p in enumerate(plant):
        kp_uv[j] = uv_map[p] + rng.randn(2).astype(np.float32) * 3.0
        src = arch[p * K + rng.randint(0, 3)]
        kp_desc[j] = _flip_bits(rng, src, int(rng.randint(0, 110)))
    kp_free = rng.uniform(size=N) < 0.9
    return dict(muv=muv, vis=vis, last_seen=m.last_seen, dcount=m.desc_count,
                desc=m.desc, size=m.size,
                frame_idx=torch.tensor(frame, dtype=torch.int32, device=dev),
                kp_uv=t(kp_uv), kp_free=t(kp_free), kp_desc=t(kp_desc)), m


# map sizes K2 is held and timed at: phase 4's map (bench.py's 51k-point
# cell) and the largest map bench.py reports (120k)
K2_SIZES = (51200, 120000)


def _scenes():
    """tests/torch_scenes.py (numpy only): the tests' adversarial scenes and
    the steered-BRIEF tie detector."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent / "tests" / "torch_scenes.py"
    spec = importlib.util.spec_from_file_location("torch_scenes", path)
    scenes = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(scenes)
    return scenes


def check_k2_flood(torch, dev, cfg, failures):
    """Phase 4, K2's queues: tests/torch_scenes.py's flood at capacity
    131072 (120000 points and 1000 keypoints in one 4 px disk, every pair
    inside the gate). From the kernel's own grid, each block's range holds
    more than twice the map points a warp's queue holds, and a full queue
    brings more pairs than a warp's candidate list holds, so both drain
    mid-sweep. Exact against the plain version, with hits in both tiers.
    Returns max |kernel - plain| of the packed keys."""
    from vslam_tpu_torch.mapping import point_map
    from vslam_tpu_torch.ops import associate as k2

    scenes = _scenes()
    geo = k2.geometry(dev)
    C, size, n_kp = cfg.map.capacity, 120000, 1000
    rows = size * -(-n_kp // geo["tile"]) / geo["blocks"]
    pairs = geo["queue_points"] * geo["warp_keypoints"]
    sc = scenes.k2_flood(C, size, n_kp, cfg.map.obs_per_point)
    muv, vis = scenes.k2_pixels(sc)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)
    args = dict(muv=t(muv), vis=t(vis), last_seen=t(sc["last_seen"]),
                dcount=t(sc["dcount"]), desc=t(sc["desc"]), size=i32(size),
                frame_idx=i32(sc["frame"]), kp_uv=t(sc["kp_uv"]),
                kp_free=t(sc["kp_free"]), kp_desc=t(sc["kp_desc"]))
    kw = point_map.gates(cfg.matching)
    got = k2.associate_cuda(**args, **kw)
    want = k2.associate_plain(**args, **kw)
    same = bool(torch.equal(got, want))
    err = int((got.long() - want.long()).abs().max())
    pid, d = k2.decode(want)
    hit = pid >= 0
    strict = int((hit & (d < cfg.matching.hamming_max)).sum())
    band = int((hit & (d >= cfg.matching.hamming_max)).sum())
    print(f"K2 flood C={C} size={size} N={n_kp}: {geo['blocks']} blocks, "
          f"{rows:.0f} map rows per block against a warp queue of "
          f"{geo['queue_points']} points; a full queue brings up to {pairs} "
          f"pairs against a list of {geo['queue_pairs']}; equal={same}, hits "
          f"strict={strict} reacq-band={band}")
    if not same:
        failures.append("K2 disagrees with its plain version on the flood")
    if rows <= 2 * geo["queue_points"] or pairs <= geo["queue_pairs"]:
        failures.append("K2 flood does not overflow the kernel's queues")
    if strict == 0 or band == 0:
        failures.append("K2 flood did not exercise both tiers")
    return err


def check_k2(torch, dev, cfg, failures):
    """Phase 4: K2 exact against its plain version on two maps (sizes
    K2_SIZES, capacity 131072, 3072 keypoints), with hits in both tiers;
    its time and bound at each size. Returns K2's numbers (``ms`` at the
    first size) and the first map (phase 7 reuses it)."""
    from vslam_tpu_torch.mapping import point_map
    from vslam_tpu_torch.ops import associate as k2

    kw = dict(point_map.gates(cfg.matching), block=cfg.map.block_size)
    res, first = {}, None
    for seed, n_map in enumerate(K2_SIZES, start=1):
        args, m = k2_inputs(torch, dev, cfg, n_map, seed)
        got = k2.associate_cuda(**args, **kw)
        want = k2.associate_plain(**args, **kw)
        torch.cuda.synchronize()
        pid_g, d_g = k2.decode(got)
        pid_w, d_w = k2.decode(want)
        same = bool(torch.equal(pid_g, pid_w) and torch.equal(d_g, d_w))
        err = int((got.long() - want.long()).abs().max())
        hit = pid_w >= 0
        strict = int((hit & (d_w < cfg.matching.hamming_max)).sum())
        band = int((hit & (d_w >= cfg.matching.hamming_max)).sum())
        N, C = args["kp_uv"].shape[0], cfg.map.capacity
        size = int(args["size"])
        print(f"K2 C={C} size={size} N={N}: ids+distances equal={same}, "
              f"hits strict={strict} reacq-band={band}")
        if not same:
            failures.append(f"K2 disagrees with its plain version at size "
                            f"{size}")
        if strict == 0 or band == 0:
            failures.append(f"K2 check at size {size} did not exercise both "
                            "tiers")
        kernel = lambda: k2.associate_cuda(**args, **kw)
        ms = _time_each_ms(torch, kernel)
        ms_b2b = _time_ms(torch, kernel)
        # the same call with both pixel gates closed: the sweep alone
        shut = dict(kw, r_sq=-1.0, reacq_r_sq=-1.0)
        sweep_ms = _time_each_ms(torch,
                                 lambda: k2.associate_cuda(**args, **shut))
        plain_ms = _time_each_ms(
            torch, lambda: k2.associate_plain(**args, **kw), reps=5)
        K = cfg.map.obs_per_point
        n_bytes = size * (8 + 1 + 4 + 4 + 32 * K) + N * (8 + 1 + 32 + 4)
        bound_ms, bound_by = _bound(n_bytes, 5 * N * size, F32_OPS_PER_S)
        print(f"K2 size {size}: kernel {ms:.4f} ms (with the wrapper's "
              f"12 KB output fill; {sweep_ms:.4f} ms with the pixel gates "
              f"closed, the sweep alone), plain {plain_ms:.4f} ms (single "
              f"calls); kernel {ms_b2b:.4f} ms back to back; bound "
              f"{bound_ms:.4f} ms ({bound_by}: 5 x {N} x {size} f32 ops at "
              f"67 TFLOP/s; {n_bytes / 1e6:.2f} MB at 3.35 TB/s takes "
              f"{n_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms); share "
              f"{bound_ms / ms:.2f}")
        res[size] = dict(max_abs_err=err, ms=ms, ms_back_to_back=ms_b2b,
                         sweep_ms=sweep_ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by)
        if first is None:
            first = m
        del args, m
    flood_err = check_k2_flood(torch, dev, cfg, failures)
    print("K2 library: none (no single PyTorch call computes "
          "search-by-projection)")
    main = res[K2_SIZES[0]]
    by_size = lambda key: {str(k): r[key] for k, r in res.items()}
    return dict(max_abs_err=max([flood_err]
                                + [r["max_abs_err"] for r in res.values()]),
                ms=main["ms"], plain_ms=main["plain_ms"],
                ms_back_to_back=main["ms_back_to_back"],
                bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                library_ms=None, ms_by_size=by_size("ms"),
                sweep_ms_by_size=by_size("sweep_ms"),
                bound_ms_by_size=by_size("bound_ms"),
                plain_ms_by_size=by_size("plain_ms")), first


def _render(cfg, n_frames, scene_kw, step, seed, **traj_kw):
    from vslam_tpu_torch.datasets import synthetic

    K = cfg.camera.K()
    W, H = cfg.camera.width, cfg.camera.height
    scene = synthetic.make_scene(seed=seed, **scene_kw)
    poses = synthetic.make_trajectory(n_frames, step=step, seed=seed,
                                      **traj_kw)
    return synthetic.render_sequence(K, poses, scene, W, H), poses


# bench.py's scene: the main path's (phases 6 and 8)
BENCH_SCENE = dict(num_points=12000, extent=(80, 15, 160), z_min=5.0)


def _moved(state, dev):
    """A copy of a dataclass of tensors on another device."""
    import dataclasses
    return type(state)(**{f.name: getattr(state, f.name).to(dev)
                          for f in dataclasses.fields(state)})


def _tensors(obj, path):
    """(path, tensor) of every tensor in nested dataclasses / tuples."""
    import dataclasses

    import torch
    if isinstance(obj, torch.Tensor):
        yield path, obj
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name), f"{path}.{f.name}")
    elif isinstance(obj, tuple):
        for i, v in enumerate(obj):
            yield from _tensors(v, f"{path}[{i}]")


def check_step_vs_cpu(torch, dev, failures):
    """Small config, 4 frames: the CUDA step against the CPU step (whose
    plain versions the CPU tests hold to the JAX reference), with the same
    RANSAC samples injected on both."""
    from vslam_tpu_torch.config import small_config
    from vslam_tpu_torch.geometry import ransac
    from vslam_tpu_torch.pipeline import tracker

    cfg = small_config()
    frames, _ = _render(cfg, 5, dict(num_points=600, extent=(14, 6, 40),
                                     z_min=6.0), 0.6, 0)
    W, H = cfg.camera.width, cfg.camera.height
    ops = tracker.default_map_ops(cfg, W, H)
    masks = {}

    def pose_fn(tag, fi):
        def fn(gen, uv1, uv2, mask, K, num_hypotheses, inlier_threshold,
               min_inliers):
            m = mask.cpu().numpy()
            masks[tag, fi] = m
            valid = np.flatnonzero(m)
            rng = np.random.RandomState(fi)
            pos = rng.randint(0, max(len(valid), 1), (num_hypotheses, 8))
            idx = valid[pos] if len(valid) else np.zeros_like(pos)
            return ransac.ransac_pose_from_samples(
                torch.from_numpy(idx).to(mask.device), uv1, uv2, mask, K,
                inlier_threshold=inlier_threshold, min_inliers=min_inliers)
        return fn

    st = {d: tracker.bootstrap(frames[0], cfg, d) for d in ("cpu", dev)}
    worst = 0.0
    for i in range(1, len(frames)):
        out = {}
        for d in st:
            st[d], out[d] = tracker._step_impl(st[d], frames[i], cfg, ops,
                                               pose_fn=pose_fn(str(d), i))
        a, b = out["cpu"], out[dev]
        dpose = float((a.pose - b.pose.cpu()).abs().max())
        worst = max(worst, dpose)
        if not np.array_equal(masks["cpu", i], masks[str(dev), i]):
            failures.append(f"step parity: match mask differs, frame {i}")
        if (abs(int(a.num_inliers) - int(b.num_inliers)) > 2
                or abs(int(a.map_size) - int(b.map_size)) > 2
                or dpose > 1e-3):
            failures.append(f"step parity frame {i}: inliers "
                            f"{int(a.num_inliers)}/{int(b.num_inliers)} map "
                            f"{int(a.map_size)}/{int(b.map_size)} "
                            f"pose {dpose:.2e}")
    print(f"step cuda vs cpu (small config, 4 frames): max |pose diff| "
          f"{worst:.2e}")


def run_main_path(torch, dev, failures):
    from vslam_tpu_torch.config import VSLAMConfig
    from vslam_tpu_torch.ops import associate as k2
    from vslam_tpu_torch.ops import hamming
    from vslam_tpu_torch.pipeline import tracker
    from vslam_tpu_torch.utils import evaluate

    cfg = VSLAMConfig()
    n_frames = 12
    t0 = time.perf_counter()
    frames_np, poses = _render(cfg, n_frames, BENCH_SCENE, 1.0, 0)
    frames = torch.from_numpy(np.stack(frames_np)).to(dev)
    print(f"rendered {n_frames} frames of {cfg.camera.width}x"
          f"{cfg.camera.height} in {time.perf_counter() - t0:.1f} s")

    # warm-up: first-call costs (cuBLAS handles, allocator) off the clock
    st = tracker.bootstrap(frames[0], cfg, dev)
    for i in range(1, 3):
        st, _ = tracker.track_step(st, frames[i], cfg)
    torch.cuda.synchronize()

    hamming.launches = 0
    k2.launches = 0
    outs = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        st = tracker.bootstrap(frames[0], cfg, dev)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        t0 = time.perf_counter()
        for i in range(1, n_frames):
            st, out = tracker.track_step(st, frames[i], cfg)
            outs.append(out)
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    launches = {"hamming": hamming.launches, "associate": k2.launches}
    syncs = sorted({f"{w.filename}:{w.lineno}: {w.message}" for w in caught
                    if "called a synchronizing" in str(w.message)})
    ms_frame = 1e3 * dt / (n_frames - 1)

    ok = np.array([bool(o.success) for o in outs])
    inl = np.array([int(o.num_inliers) for o in outs])
    sizes = [int(o.map_size) for o in outs]
    est = np.stack([np.eye(4, dtype=np.float32)]
                   + [o.pose.cpu().numpy() for o in outs])
    ate = evaluate.ate_rmse(est, poses.astype(np.float64))[0]
    print(f"main path: {n_frames - 1} steps, {ms_frame:.2f} ms/frame "
          f"(host clock, synchronized), success {int(ok.sum())}/{len(ok)}, "
          f"median inliers {int(np.median(inl))}, map {sizes[0]} -> "
          f"{sizes[-1]}, ATE {ate:.4f}, launches {launches}")
    for s in syncs:
        print(f"host sync inside the step: {s}")
    if syncs:
        failures.append(f"{len(syncs)} host-sync sites inside track_step")
    if ok.mean() < 0.8:
        failures.append(f"only {int(ok.sum())}/{len(ok)} frames succeeded")
    if not np.median(inl) > 50:
        failures.append(f"median inliers {np.median(inl)} <= 50")
    if not (sizes[-1] > sizes[0] > 0):
        failures.append(f"map did not grow: {sizes}")
    if not np.isfinite(est).all() or not ate < 0.5:
        failures.append(f"trajectory off: ATE {ate}")
    for name, n in launches.items():
        if n < n_frames - 1:
            failures.append(f"{name} kernel launched {n} times in "
                            f"{n_frames - 1} steps")
    return launches, ms_frame


def check_lifecycle(torch, dev, m, failures):
    """Phase 7: evict_lru, compact and remap_ids on phase 4's map (capacity
    131072, size 51200, last_seen ages 0..15: heavy ties), CUDA against the
    CPU, every field exact. min_free = capacity // 8 leaves the map as it
    is (51200 alive fit); capacity - size // 2 evicts half of it, the order
    among equal ages decided by slot index."""
    import dataclasses

    from vslam_tpu_torch.mapping import point_map

    C, size = m.capacity, int(m.size)
    rng = np.random.RandomState(7)
    # id holders as the pipeline remaps them: the keyframe ring's obs_pid
    ids = torch.from_numpy(rng.randint(-1, size, (40, 3072))
                           .astype(np.int32))
    m_cpu, ids_dev = _moved(m, "cpu"), ids.to(dev)
    n_alive = int(m_cpu.alive[:size].sum())

    def run(mm, ii, min_free):
        ev = point_map.evict_lru(mm, min_free)
        m2, remap = point_map.compact(ev)
        return ev.alive, m2, remap, point_map.remap_ids(ii, remap)

    for min_free in (C // 8, C - size // 2):
        got = run(m, ids_dev, min_free)
        want = run(m_cpu, ids, min_free)
        torch.cuda.synchronize()
        bad = [f.name for f in dataclasses.fields(want[1])
               if not torch.equal(getattr(got[1], f.name).cpu(),
                                  getattr(want[1], f.name))]
        for name, g, w in (("evicted", got[0], want[0]),
                           ("remap", got[2], want[2]),
                           ("remap_ids", got[3], want[3])):
            if not torch.equal(g.cpu(), w):
                bad.append(name)
        n_ev = int((m_cpu.alive & ~want[0]).sum())
        ms = _time_ms(torch, lambda: run(m, ids_dev, min_free), reps=5)
        print(f"lifecycle C={C} size={size} min_free={min_free}: evicted "
              f"{n_ev}, size after {int(want[1].size)}, CUDA == CPU: "
              f"{not bad}; evict+compact+remap {ms:.3f} ms")
        if bad:
            failures.append(f"lifecycle min_free={min_free}: {bad} differ")
        want_ev = max(n_alive - (C - min_free), 0)
        if n_ev != want_ev or int(want[1].size) != n_alive - n_ev:
            failures.append(f"lifecycle: evicted {n_ev}, want {want_ev}")
    if want_ev == 0:
        failures.append("lifecycle: the second min_free evicted nothing")


def _process_run(torch, s, frames, gt, label, failures):
    """``s.process`` over ``frames``, launch counters reset just before and
    read just after. Each ``process`` runs under
    ``set_sync_debug_mode("warn")`` and its host syncs are counted; the
    host clock per frame is taken between two ``synchronize()``. Holds the
    run to >= 80% tracked, ATE < 0.5, <= 2 syncs per ordinary frame, a
    window-BA attempt and one launch of each kernel per tracked frame.
    Returns (run record, launches, ms/frame by frame kind)."""
    from vslam_tpu_torch.ops import associate as k2
    from vslam_tpu_torch.ops import hamming
    from vslam_tpu_torch.utils import evaluate

    n_frames = frames.shape[0]
    hamming.launches = 0
    k2.launches = 0
    infos, wall, syncs, sites = [], [], [], []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for i in range(n_frames):
            torch.cuda.synchronize()
            n0 = len(caught)
            t0 = time.perf_counter()
            torch.cuda.set_sync_debug_mode("warn")
            infos.append(s.process(frames[i]))
            torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            wall.append(time.perf_counter() - t0)
            mine = [f"{w.filename}:{w.lineno}" for w in caught[n0:]
                    if "called a synchronizing" in str(w.message)]
            syncs.append(len(mine))
            sites.append(mine)
    launches = {"hamming": hamming.launches, "associate": k2.launches}

    kinds = ["bootstrap"] + ["ba" if x["ran_ba"] else
                             "keyframe" if x["keyframe"] else "ordinary"
                             for x in infos[1:]]
    ms = {}
    for k in ("ordinary", "keyframe", "ba"):
        sel = [1e3 * w for w, kk in zip(wall, kinds) if kk == k]
        ms[k] = (float(np.mean(sel)) if sel else None, len(sel))
        print(f"process {k} frames: {len(sel)}, "
              + (f"{ms[k][0]:.2f} ms/frame (host clock, synchronized)"
                 if sel else "none"))
    ord_syncs = [n for n, k in zip(syncs, kinds) if k == "ordinary"]
    print(f"host syncs per ordinary frame: max {max(ord_syncs)}, "
          f"mean {np.mean(ord_syncs):.2f}; per frame {syncs}")
    for n, k, site in zip(syncs, kinds, sites):
        if k == "ordinary" and n > 2:
            print(f"  ordinary frame with {n} syncs: {site}")
    events = [r for r in s.metrics.records if r.get("kind") == "ba"]
    for e in events:
        outcome = (f"skipped ({e['skipped']})" if "skipped" in e else
                   "solved, " + ("accepted" if e["ba_result_accepted"]
                                 else "rejected by the trust region"))
        print(f"window BA at frame {e['frame']}: {outcome}; "
              + ", ".join(f"{k}={v}" for k, v in e.items()
                          if k not in ("kind", "frame", "t", "skipped")))
    ok = np.array([bool(x["success"]) for x in infos[1:]])
    est = s.poses()
    ate = evaluate.ate_rmse(est, gt.astype(np.float64))[0]
    print(f"{label}: {n_frames} frames, tracked {int(ok.sum())}/{len(ok)}, "
          f"keyframes {int(s.kf_store.count)}, ATE {ate:.4f}, map "
          f"{infos[-1]['map_size']}, launches {launches}")
    if ok.mean() < 0.8:
        failures.append(f"{label} tracked only {int(ok.sum())}/{len(ok)}")
    if not np.isfinite(est).all() or not ate < 0.5:
        failures.append(f"{label} trajectory off: ATE {ate}")
    if max(ord_syncs) > 2:
        failures.append(f"{label}: {max(ord_syncs)} host syncs in an "
                        "ordinary frame")
    if not any(x["ran_ba"] for x in infos[1:]) or not events:
        failures.append(f"{label}: window BA was never attempted")
    for name, n in launches.items():
        if n < n_frames - 1:
            failures.append(f"{label}: {name} kernel launched {n} times "
                            f"in {n_frames - 1} tracked frames")
    rec = dict(frames=frames, gt=gt, infos=infos, poses=est, events=events,
               ms=[1e3 * w for w, k in zip(wall, kinds) if k != "bootstrap"])
    return rec, launches, ms


def run_slam_path(torch, dev, failures):
    """Phase 8, the slice's main path: ``SLAMSystem.process`` of the default
    config on bench.py's scene, 31 frames at 1 m steps (keyframes every 5th
    frame; the window-BA attempt at keyframe 5, frame 25), then
    ``run_global_ba``. Launch counters reset just before, read just after.
    Each ``process`` runs under ``set_sync_debug_mode("warn")`` and its
    host syncs are counted; the host clock per frame is taken between two
    ``synchronize()``."""
    from vslam_tpu_torch.config import VSLAMConfig
    from vslam_tpu_torch.core.types import empty_map
    from vslam_tpu_torch.optimizer import ba
    from vslam_tpu_torch.pipeline import keyframes, tracker
    from vslam_tpu_torch.pipeline.slam import SLAMSystem
    from vslam_tpu_torch.utils import evaluate

    cfg = VSLAMConfig()
    n_frames = 31
    t0 = time.perf_counter()
    frames_np, gt = _render(cfg, n_frames, BENCH_SCENE, 1.0, 0)
    frames = torch.from_numpy(np.stack(frames_np)).to(dev)
    print(f"rendered {n_frames} frames in {time.perf_counter() - t0:.1f} s")
    # warm-up: the solver's first-call costs (cuSOLVER, allocator) at the
    # window's shapes, off the clock (phase 6 warmed the step)
    wp0 = keyframes.build_window_problem(
        keyframes.empty_store(40, cfg.frontend.max_keypoints, dev),
        empty_map(cfg.map.capacity, cfg.map.obs_per_point, dev), cfg,
        free_tail=cfg.ba.free_cams, prov_min_obs=99)
    ba.solve_robust(wp0.problem, tracker._K(cfg, dev), cfg.ba)
    torch.cuda.synchronize()

    s = SLAMSystem(cfg, dev)
    p8, launches, ms = _process_run(torch, s, frames, gt, "SLAM path",
                                    failures)

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    stats = s.run_global_ba()
    end.record()
    torch.cuda.synchronize()
    ms_global = start.elapsed_time(end)
    cov = s.last_global_ba_coverage
    init, fin = float(stats.initial_cost), float(stats.final_cost)
    kf_frames = s.kf_store.kf_frame.cpu().numpy()
    kf_ate = evaluate.ate_rmse(
        s.keyframe_poses(),
        gt[np.sort(kf_frames[kf_frames >= 0])].astype(np.float64))[0]
    print(f"global BA: {ms_global:.2f} ms (CUDA events, whole call), cost "
          f"{init:.2f} -> {fin:.2f}, accepted "
          f"{int(stats.accepted.sum())}/{stats.accepted.numel()} in the last "
          f"round, coverage {cov}, keyframe ATE after {kf_ate:.4f}")
    if not fin < init:
        failures.append(f"global BA did not reduce its cost: {init} -> {fin}")
    if cov["dropped_points"] or cov["dropped_obs"]:
        failures.append(f"global BA truncated its problem: {cov}")
    if not (np.isfinite(s.poses()).all()
            and np.isfinite(s.keyframe_poses()).all()):
        failures.append("non-finite poses after global BA")
    held = list(_tensors(s.state, "state")) + list(
        _tensors(s.kf_store, "kf_store")) + list(
        _tensors(s.last_ba_stats, "stats"))
    off = [p for p, t in held if not t.is_cuda]
    if off:
        failures.append(f"state left the card: {off}")
    wide = [p for p, t in held if t.dtype == torch.float64]
    if wide:
        failures.append(f"float64 in the state: {wide}")
    return s, launches, ms, ms_global, p8


def check_ba(torch, dev, s, failures):
    """Phase 9: the full-width window problem from phase 8's final store
    and map, built with ``_run_window_ba``'s call; ``solve_robust`` on
    CUDA and on the CPU from the same inputs. Then ms per solve and per LM
    iteration (CUDA events) for the window and the global problem."""
    import dataclasses

    from vslam_tpu_torch.optimizer import ba
    from vslam_tpu_torch.pipeline import keyframes

    cfg = s.cfg
    wp = keyframes.build_window_problem(
        s.kf_store, s.state.map, cfg, free_tail=cfg.ba.free_cams,
        prov_min_obs=99)
    p = wp.problem
    Kd = s._K
    got_p, got = ba.solve_robust(p, Kd, cfg.ba, reject_px=5.0, rounds=2)
    t0 = time.perf_counter()
    want_p, want = ba.solve_robust(_moved(p, "cpu"), Kd.cpu(), cfg.ba,
                                   reject_px=5.0, rounds=2)
    cpu_ms = 1e3 * (time.perf_counter() - t0)
    gi, gf = float(got.initial_cost), float(got.final_cost)
    wi, wf = float(want.initial_cost), float(want.final_cost)
    same_acc = torch.equal(got.accepted.cpu(), want.accepted)
    dT = float((got_p.T_cw.cpu() - want_p.T_cw).abs().max())
    C, P, K = p.num_cams, *p.obs_cam.shape
    print(f"window BA {C}x{P}x{K} (valid cams {int(wp.win_valid.sum())}, "
          f"live points {int(p.point_mask.sum())}, obs "
          f"{int(p.obs_mask.sum())}): cost CUDA {gi:.4f} -> {gf:.4f}, CPU "
          f"{wi:.4f} -> {wf:.4f}; accepted CUDA "
          f"{got.accepted.cpu().tolist()} CPU {want.accepted.tolist()}; max "
          f"|T_cw diff| {dT:.2e}; CPU solve_robust {cpu_ms:.1f} ms (host)")
    if not abs(gi - wi) <= 1e-4 * abs(wi):
        failures.append(f"window BA initial cost CUDA {gi} vs CPU {wi}")
    if not abs(gf - wf) <= 1e-3 * abs(wf):
        failures.append(f"window BA final cost CUDA {gf} vs CPU {wf}")
    if not same_acc:
        failures.append("window BA accept flags differ CUDA vs CPU")
    if not gf < gi:
        failures.append(f"window BA did not reduce its cost: {gi} -> {gf}")

    it = cfg.ba.iterations
    ms_solve = _time_ms(torch, lambda: ba.solve(p, Kd, cfg.ba), reps=3)
    ms_robust = _time_ms(torch, lambda: ba.solve_robust(
        p, Kd, cfg.ba, reject_px=5.0, rounds=2), reps=3)
    print(f"window BA {C}x{P}x{K} on CUDA: {ms_solve:.2f} ms/solve "
          f"({ms_solve / it:.3f} ms/iteration, {it} iterations), "
          f"solve_robust (2 rounds) {ms_robust:.2f} ms (CUDA events)")

    cov = s.last_global_ba_coverage
    gcfg = dataclasses.replace(cfg.ba, huber_delta=1.5,
                               max_obs_per_point=cov["obs_slots"])
    gwp = keyframes.build_window_problem(
        s.kf_store, s.state.map, cfg.replace(ba=gcfg),
        window=s.kf_store.ring_size, max_points=cov["max_points"])
    gp = gwp.problem
    ms_g = _time_ms(torch, lambda: ba.solve(gp, Kd, gcfg), reps=3)
    Cg, Pg, Kg = gp.num_cams, *gp.obs_cam.shape
    assembly = "onehot" if Cg <= gcfg.onehot_max_cams else "scatter"
    print(f"global BA {Cg}x{Pg}x{Kg} ({assembly} assembly) on CUDA: "
          f"{ms_g:.2f} ms/solve ({ms_g / it:.3f} ms/iteration) (CUDA events)")
    return dict(window_ms_solve=ms_solve, window_ms_iter=ms_solve / it,
                window_ms_robust=ms_robust, global_ms_solve=ms_g,
                global_ms_iter=ms_g / it)


def run_bounded_map(torch, dev, failures):
    """Phase 10: tests/test_map_lifecycle.py's bounded-map scenario on
    CUDA: small config, capacity 512, 24 frames, BA off. Maintenance must
    run, no insert may drop, the map stays within capacity and tracking
    survives the id remap."""
    from vslam_tpu_torch.config import MapConfig, small_config
    from vslam_tpu_torch.pipeline.slam import SLAMSystem

    cfg = small_config().replace(map=MapConfig(capacity=512, obs_per_point=4,
                                               block_size=32))
    frames, _ = _render(cfg, 24, dict(num_points=3000, extent=(40, 10, 80),
                                      z_min=5.0), 0.6, 3, yaw_rate=0.01)
    s = SLAMSystem(cfg, dev, enable_ba=False)
    infos = [s.process(torch.from_numpy(f).to(dev)) for f in frames]
    sizes = [x["map_size"] for x in infos[1:]]
    print(f"bounded map: maintenance runs {s.maintenance_runs}, dropped "
          f"inserts {s.dropped_inserts_total}, map size max {max(sizes)}, "
          f"last 5 tracked {[x['success'] for x in infos[-5:]]}, last "
          f"inliers {infos[-1]['num_inliers']}")
    if s.maintenance_runs < 1:
        failures.append("bounded map: maintenance never ran")
    if s.dropped_inserts_total:
        failures.append(f"bounded map: {s.dropped_inserts_total} inserts "
                        "dropped")
    if max(sizes) > 512:
        failures.append(f"bounded map: size {max(sizes)} > capacity 512")
    if not all(x["success"] for x in infos[-5:]) \
            or not infos[-1]["num_inliers"] > 30:
        failures.append("bounded map: tracking lost after maintenance")
    return cfg, frames, infos


def _frame_rows(s):
    return [r for r in s.metrics.records
            if r.get("kind") == "frame" and "success" in r]


def _chunks(torch, s, inputs, sizes, render_fn=None):
    """``s.process_chunk`` over consecutive slices of ``inputs``; each call
    under ``set_sync_debug_mode("warn")`` (the replay loop itself runs
    under "error"), its syncs counted. Returns the calls' results and
    sync counts."""
    out, syncs, lo = [], [], 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for k in sizes:
            torch.cuda.synchronize()
            n0 = len(caught)
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out.append(s.process_chunk(inputs[lo:lo + k],
                                           render_fn=render_fn))
            finally:
                torch.cuda.set_sync_debug_mode("default")
            syncs.append(sum("called a synchronizing" in str(w.message)
                             for w in caught[n0:]))
            lo += k
    return out, syncs


def _chunked_run(torch, dev, cfg, ref, label, failures):
    """``process_chunk`` of ``cfg`` over ``ref``'s frames (a ``_process_run``
    record), bootstrap + 25 then the rest (25 = keyframe_every *
    local_ba_every: the window-BA event lands on frame 25 as in the
    per-frame run), held to ``ref`` frame by frame: flags equal, inliers
    and map size within 2, poses to 1e-3 / 5e-3, the BA events' outcomes.
    The frame body is one captured graph replayed per frame: K1 and K2 are
    captured once each and launch on every replay; the replay loop runs
    with ``set_sync_debug_mode("error")``. Returns (system, graph, numbers:
    launches (captured times replays), chunked ms/frame (host clock over
    each chunk's replays through the one fetch of its rows, capture
    excluded), capture seconds, graph pool peak)."""
    from vslam_tpu_torch.ops import associate as k2
    from vslam_tpu_torch.ops import hamming
    from vslam_tpu_torch.pipeline.slam import SLAMSystem

    frames = ref["frames"]
    n = frames.shape[0]
    align = cfg.pipeline.keyframe_every * cfg.pipeline.local_ba_every
    s = SLAMSystem(cfg, dev)
    hamming.launches = 0
    k2.launches = 0
    res, syncs = _chunks(torch, s, frames, (align + 1, n - align - 1))
    counted = {"hamming": hamming.launches, "associate": k2.launches}
    g = s.chunk_graphs[None]
    launches = {k: v * g.replays for k, v in g.captured_launches.items()}
    print(f"{label}: capture {g.capture_s:.2f} s (eager warm-up + capture), "
          f"graph pool peak {g.pool_peak_bytes / 2 ** 20:.1f} MiB; kernels "
          f"captured per frame {g.captured_launches}, replays {g.replays}, "
          f"launches {launches} (wrapper counters {counted}: one eager "
          f"warm-up and one capture); host syncs per process_chunk call "
          f"{syncs} (the rows' fetch, BA's own; 0 inside the replay loop, "
          f"enforced)")
    if g.captured_launches != {"hamming": 1, "associate": 1}:
        failures.append(f"{label}: kernels captured {g.captured_launches}, "
                        "want one of each per frame")
    if g.replays != n - 1:
        failures.append(f"{label}: {g.replays} replays for {n - 1} frames")

    rows, want = _frame_rows(s), ref["infos"][1:]
    est = s.poses()
    err = np.abs(est - ref["poses"]).max(axis=(1, 2))
    bad = []
    for i, (x, y) in enumerate(zip(want, rows), 1):
        if (x["keyframe"] and x["success"]) != y["keyframe"] or any(
                x[k] != y[k] for k in ("success", "ran_maintenance")):
            bad.append(f"frame {i} flags")
        if any(abs(x[k] - y[k]) > 2 for k in ("num_inliers", "map_size")):
            bad.append(f"frame {i} inliers {x['num_inliers']}/"
                       f"{y['num_inliers']} map {x['map_size']}/"
                       f"{y['map_size']}")
    if len(rows) != len(want):
        bad.append(f"{len(rows)} rows for {len(want)} frames")
    if err[:align + 1].max() > 1e-3 or err.max() > 5e-3:
        bad.append(f"poses off by {err.max():.2e}")
    outcome = lambda ev: [(e.get("skipped"), e["ba_result_accepted"])
                          for e in ev]
    events = [r for r in s.metrics.records if r.get("kind") == "ba"]
    if outcome(events) != outcome(ref["events"]) or not res[0]["ran_ba"]:
        bad.append(f"BA events {outcome(events)} vs "
                   f"{outcome(ref['events'])}")
    ok = sum(r["success"] for r in rows)
    print(f"{label} vs process: tracked {ok}/{len(rows)}, max |pose diff| "
          f"{err[:align + 1].max():.2e} to frame {align}, {err.max():.2e} "
          f"after; BA events {outcome(events)}; disagreements {bad}")
    failures.extend(f"{label} vs process: {b}" for b in bad)

    per = [r["track_s"] / r["frames"] for r in res]
    ms_frame = 1e3 * sum(r["track_s"] for r in res) / (n - 1)
    ref_ms = float(np.mean(ref["ms"]))
    print(f"{label} ms/frame {ms_frame:.3f} (host clock, chunks "
          f"{[round(1e3 * x, 3) for x in per]}; the bootstrap and BA "
          f"excluded); process {ref_ms:.3f} ms/frame over its "
          f"{len(ref['ms'])} tracked frames, {ref_ms / ms_frame:.2f}x")
    return s, g, dict(launches=launches, ms_frame=ms_frame,
                      process_ms_frame=ref_ms, capture_s=g.capture_s,
                      pool_mib=g.pool_peak_bytes / 2 ** 20,
                      max_pose_diff=float(err.max()))


def run_chunked_path(torch, dev, p8, failures):
    """Phase 11: the chunked driver at full width, ``_chunked_run`` of the
    default config held to phase 8. Then the graph's device ms per replay
    and maintenance's cost inside a graph (computed on every frame, kept
    where it fires)."""
    from vslam_tpu_torch.config import VSLAMConfig
    from vslam_tpu_torch.pipeline import scan_driver
    from vslam_tpu_torch.utils.profiling import graph_ms

    cfg = VSLAMConfig()
    s, g, out = _chunked_run(torch, dev, cfg, p8, "chunked", failures)
    replay_ms = _time_ms(torch, g.graph.replay, reps=10)
    st, sr = s.state, s.kf_store

    def maintenance():
        need = st.map.size >= s._maint_high_water
        m2, pid2, obs2 = scan_driver._maintenance(
            st.map, st.prev_map_id, sr.obs_pid, s._maint_min_free)
        return (scan_driver._select(need, m2, st.map),
                torch.where(need, pid2, st.prev_map_id),
                torch.where(need, obs2, sr.obs_pid))
    maint_ms = graph_ms(maintenance, reps=20)
    print(f"chunked: graph replay {replay_ms:.3f} ms/frame (CUDA events), "
          f"maintenance in a graph {maint_ms:.3f} ms/frame at capacity "
          f"{cfg.map.capacity}")
    return dict(out, replay_ms=replay_ms)


def run_chunked_bounded(torch, dev, p10, failures):
    """Phase 12, first run: phase 10's capacity-512 run through chunks of
    9, 8 and 7 frames; maintenance fires inside the graph. Held to phase
    10: equal ``ran_maintenance`` per frame, no dropped inserts, the last 5
    frames tracked."""
    from vslam_tpu_torch.pipeline.slam import SLAMSystem

    cfg, frames, infos = p10
    s = SLAMSystem(cfg, dev, enable_ba=False)
    _, syncs = _chunks(torch, s, torch.from_numpy(np.stack(frames)).to(dev),
                       (9, 8, 7))
    rows = _frame_rows(s)
    flags = [r["ran_maintenance"] for r in rows]
    want = [x["ran_maintenance"] for x in infos[1:]]
    print(f"chunked bounded map: maintenance at frames "
          f"{[i for i, f in enumerate(flags, 1) if f]} (phase 10: "
          f"{[i for i, f in enumerate(want, 1) if f]}), dropped inserts "
          f"{s.dropped_inserts_total}, last 5 tracked "
          f"{[r['success'] for r in rows[-5:]]}, syncs per call {syncs}")
    if flags != want or not any(flags):
        failures.append("chunked bounded map: maintenance flags differ from "
                        "phase 10's")
    if s.dropped_inserts_total:
        failures.append(f"chunked bounded map: {s.dropped_inserts_total} "
                        "inserts dropped")
    if not all(r["success"] for r in rows[-5:]):
        failures.append("chunked bounded map: tracking lost")


def run_rendered_chunks(torch, dev, failures):
    """Phase 12, second run: tests/test_scan_driver.py's renderer case, 12
    frames that ``render_frame_device`` draws inside the graph from device
    poses (a corridor scene made on the card), in chunks of 6; at least 9
    of the 11 tracked frames succeed. Then the renderer on the card against
    its CPU run on the same arrays: the no-overlap scene of
    tests/test_loaders.py to 2e-5 on every pixel, the corridor (1200 and
    3000 landmarks, overlapping splats) to 2e-5 on >= 99.9% of pixels."""
    from vslam_tpu_torch.config import small_config
    from vslam_tpu_torch.datasets import synthetic, synthetic_device
    from vslam_tpu_torch.pipeline.slam import SLAMSystem

    cfg = small_config()
    W, H = cfg.camera.width, cfg.camera.height
    poses = torch.from_numpy(synthetic.make_trajectory(12, step=0.6, seed=3)
                             .astype(np.float32))
    gen = torch.Generator(device=dev).manual_seed(3)
    xyz, patches = synthetic_device.make_corridor_scene_device(
        gen, poses.to(dev), 1200)
    Kd = torch.from_numpy(cfg.camera.K()).to(dev)

    def render(pose):
        return synthetic_device.render_frame_device(xyz, patches, Kd, pose,
                                                    W, H)
    s = SLAMSystem(cfg, dev, enable_ba=False)
    _, syncs = _chunks(torch, s, poses.to(dev), (6, 6), render_fn=render)
    rows = _frame_rows(s)
    ok = sum(r["success"] for r in rows)
    g = s.chunk_graphs[render]
    print(f"rendered in the graph: tracked {ok}/{len(rows)}, replays "
          f"{g.replays}, kernels captured {g.captured_launches}, syncs per "
          f"call {syncs}")
    if ok < 9 or len(rows) != 11:
        failures.append(f"rendered chunks: tracked {ok}/{len(rows)}")

    gx, gy = np.meshgrid(np.linspace(-4, 4, 4), np.linspace(-2.5, 2.5, 3))
    grid = np.stack([gx.ravel(), gy.ravel(), np.full(12, 20.0)],
                    axis=1).astype(np.float32)
    grid_K = np.array([[200.0, 0, 128], [0, 200.0, 96], [0, 0, 1]],
                      np.float32)
    scenes = [("no-overlap", torch.from_numpy(grid),
               torch.from_numpy(synthetic.make_scene(num_points=12, seed=5)
                                .patches),
               torch.from_numpy(grid_K), torch.from_numpy(
                   synthetic.make_trajectory(3, step=0.5, seed=5)
                   .astype(np.float32)), 256, 192, 1.0)]
    for n_pts in (1200, 3000):
        x, p = synthetic_device.make_corridor_scene_device(
            torch.Generator().manual_seed(n_pts), poses, n_pts)
        scenes.append((f"corridor {n_pts}", x, p,
                       torch.from_numpy(cfg.camera.K()), poses, W, H, 0.999))
    for name, x, p, Km, ps, w, h, need in scenes:
        worst, frac = 0.0, 1.0
        for pose in ps:
            want = synthetic_device.render_frame_device(x, p, Km, pose, w, h)
            got = synthetic_device.render_frame_device(
                x.to(dev), p.to(dev), Km.to(dev), pose.to(dev), w,
                h).cpu()
            d = (got - want).abs()
            worst = max(worst, float(d.max()))
            frac = min(frac, float((d <= 2e-5).float().mean()))
        print(f"render_frame_device CUDA vs CPU, {name}: max |diff| "
              f"{worst:.3e}, least share of pixels within 2e-5 {frac:.6f}")
        if frac < need:
            failures.append(f"render_frame_device CUDA vs CPU, {name}: "
                            f"{frac:.6f} of pixels within 2e-5")


def variant_config():
    """Phase 13's configuration: the default with both front-end variants
    (steered BRIEF on the dense orientation map, mapped-track carry)."""
    import dataclasses

    from vslam_tpu_torch.config import VSLAMConfig

    cfg = VSLAMConfig()
    return cfg.replace(frontend=dataclasses.replace(
        cfg.frontend, oriented=True, track_carry=True))


# phase 13's tolerances: orientation where the centroid moment's magnitude
# exceeds ORIENT_FLOOR (the moments are bit-equal CUDA vs CPU, so atan2's
# ulps remain); a descriptor bit may differ only where a rotated sample
# lies within TIE_SLACK px (plus an f32 ulp) of a half-integer
ORIENT_FLOOR, ORIENT_TOL, TIE_SLACK = 1e-2, 1e-5, 1e-5


def check_variant_ops(torch, dev, cfg, frames, failures):
    """Phase 13 (a): the variants' front-end ops at full width, CUDA
    against the CPU on the same inputs: ``detect_with_carry`` (frame 1,
    carrying frame 0's keypoints moved by (1, 0.5) px) with equal masks
    and coordinates to 2 ulps; ``orientation_map`` to ORIENT_TOL where the
    moment exceeds ORIENT_FLOOR; steered ``describe`` on the 3072
    keypoints with one angle tensor fed to both devices, bits equal except
    at rounding ties."""
    from vslam_tpu_torch.frontend import descriptors, features

    fe, H, W = cfg.frontend, cfg.camera.height, cfg.camera.width
    img0, img1 = frames[0].cpu(), frames[1].cpu()
    uv0, _, ok0 = features.detect(img0, fe, H, W)
    carry = uv0 + torch.tensor([1.0, 0.5])
    want = features.detect_with_carry(img1, fe, H, W, carry, ok0)
    got = [t.cpu() for t in features.detect_with_carry(
        frames[1], fe, H, W, carry.to(dev), ok0.to(dev))]
    mask = want[2].numpy()
    ref_uv = want[0].numpy()[mask]
    uv_err = np.abs(got[0].numpy()[mask] - ref_uv)
    near = bool((uv_err <= 2 * np.spacing(np.abs(ref_uv))).all())
    print(f"detect_with_carry CUDA vs CPU ({mask.size} keypoints, "
          f"{int(ok0.sum())} carried): masks equal "
          f"{torch.equal(got[2], want[2])}, valid {int(mask.sum())}, max "
          f"|uv diff| {float(uv_err.max()):.3e} (within 2 ulps: {near})")
    if not torch.equal(got[2], want[2]) or not near:
        failures.append("detect_with_carry CUDA vs CPU")

    blur = features.gaussian_blur(img1, fe.blur_sigma)
    blur_dev = features.gaussian_blur(frames[1], fe.blur_sigma)
    m01, m10 = descriptors.centroid_moments(blur, fe.patch_radius)
    a_cpu = torch.atan2(m01, m10)
    a_dev = descriptors.orientation_map(blur_dev, fe.patch_radius).cpu()
    dth = torch.remainder(a_dev - a_cpu + np.pi, 2 * np.pi) - np.pi
    strong = torch.hypot(m01, m10) > ORIENT_FLOOR
    worst = float(dth.abs()[strong].max())
    print(f"orientation_map CUDA vs CPU ({W}x{H}): max |dtheta| {worst:.3e} "
          f"rad where |m| > {ORIENT_FLOOR} ({float(strong.float().mean()):.4f}"
          f" of pixels), {float(dth.abs().max()):.3e} anywhere")
    if not worst <= ORIENT_TOL:
        failures.append(f"orientation_map CUDA vs CPU: {worst}")

    uv = want[0]
    angle = descriptors.orientations_at(blur, uv, fe.patch_radius)
    bits = descriptors.unpack_bits(descriptors.describe(blur, uv, angle, fe))
    bits_dev = descriptors.unpack_bits(descriptors.describe(
        blur_dev, uv.to(dev), angle.to(dev), fe)).cpu()
    tied, live = _scenes().describe_ties(
        blur.numpy(), uv.numpy(), angle.numpy(),
        descriptors.brief_pattern(fe.descriptor_bits, fe.patch_radius),
        TIE_SLACK)
    flips = (bits != bits_dev).numpy()
    print(f"describe CUDA vs CPU ({uv.shape[0]} keypoints x "
          f"{fe.descriptor_bits} pairs): {int(flips.sum())} bits differ, "
          f"{int((flips & ~tied).sum())} of them away from ties; ties "
          f"within {TIE_SLACK} px + 1 ulp of a half-integer: "
          f"{int(tied.sum())} pairs, {int(live.sum())} of them able to flip")
    if (flips & ~tied).any():
        failures.append("describe CUDA vs CPU: bits differ away from ties")


def run_variants(torch, dev, p8, failures):
    """Phase 13: the full-width front-end variants (``variant_config``) on
    phase 8's scene and frames: (a) ``check_variant_ops``; (b)
    ``SLAMSystem.process`` over the 31 frames, held as phase 8 is
    (``_process_run``); (c) ``process_chunk`` over the same frames held to
    (b) frame by frame (``_chunked_run``); (d) ``ops.bench_kernels``'
    Hamming agreement at 3072 x 3072 on the card: ``hamming_matmul``,
    ``hamming_popcount`` and ``torch.cdist(p=0)`` equal K1."""
    from vslam_tpu_torch.ops import bench_kernels
    from vslam_tpu_torch.pipeline.slam import SLAMSystem

    cfg = variant_config()
    check_variant_ops(torch, dev, cfg, p8["frames"], failures)
    ref, launches, ms = _process_run(torch, SLAMSystem(cfg, dev),
                                     p8["frames"], p8["gt"], "variants",
                                     failures)
    _, _, chunk = _chunked_run(torch, dev, cfg, ref, "variants chunked",
                               failures)
    rng = np.random.RandomState(13)
    d1, d2 = (bench_kernels.random_descriptors(rng, 3072, dev)
              for _ in range(2))
    equal = bench_kernels.hamming_agreement(d1, d2)
    print(f"bench_kernels Hamming agreement on the card, 3072 x 3072: "
          f"equal to K1 {equal}")
    if not all(equal.values()):
        failures.append(f"Hamming formulations disagree with K1: {equal}")
    return dict(launches=launches, ms=ms, chunk=chunk)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = _smi()
    print(f"device: {name} (count {torch.cuda.device_count()}); "
          f"nvidia-smi: {smi}")
    print("torch", torch.__version__, "cuda", torch.version.cuda)

    from vslam_tpu_torch.config import VSLAMConfig
    from vslam_tpu_torch.ops import _build

    failures = []
    kern = _build.load()
    print(f"built {kern.path.name} in {kern.seconds:.1f} s")
    for line in kern.log.splitlines():
        if any(w in line for w in ("entry function", "registers", "spill",
                                   "error")):
            print("  ptxas:", line.strip())
    n_bmma = _count_sass(kern.path, "BMMA")
    print(f"SASS of {kern.path.name}: {n_bmma} BMMA (b1 tensor-core mma) "
          "instructions")
    if n_bmma == 0:
        failures.append("K1 has no b1 tensor-core mma in its SASS")

    clock = [time.perf_counter()]

    def phase_done(n):
        now = time.perf_counter()
        print(f"phase {n}: {now - clock[0]:.1f} s")
        clock[0] = now

    phase_done(2)
    k1 = check_k1(torch, dev, failures)
    phase_done(3)
    k2, k2_map = check_k2(torch, dev, VSLAMConfig(), failures)
    phase_done(4)
    check_step_vs_cpu(torch, dev, failures)
    phase_done(5)
    step_launches, ms_frame = run_main_path(torch, dev, failures)
    phase_done(6)
    check_lifecycle(torch, dev, k2_map, failures)
    del k2_map
    phase_done(7)
    system, launches, ms_kind, ms_global, p8 = run_slam_path(torch, dev,
                                                             failures)
    phase_done(8)
    ba_ms = check_ba(torch, dev, system, failures)
    del system
    phase_done(9)
    p10 = run_bounded_map(torch, dev, failures)
    phase_done(10)
    chunked = run_chunked_path(torch, dev, p8, failures)
    phase_done(11)
    run_chunked_bounded(torch, dev, p10, failures)
    run_rendered_chunks(torch, dev, failures)
    phase_done(12)
    variants = run_variants(torch, dev, p8, failures)
    del p8
    phase_done(13)

    # launches: the SLAM path's (phase 8); the tracking step's own run
    # (phase 6) is kept beside it
    kernels = [
        dict(name="hamming", route="cuda",
             source="vslam_tpu_torch/csrc/hamming.cu",
             replaces="vslam_tpu/ops/pallas_hamming.py:50",
             launches=launches["hamming"],
             launches_track_step=step_launches["hamming"],
             launches_chunked=chunked["launches"]["hamming"],
             launches_variants=variants["launches"]["hamming"],
             launches_variants_chunked=variants["chunk"]["launches"][
                 "hamming"], **k1),
        dict(name="associate", route="cuda",
             source="vslam_tpu_torch/csrc/associate.cu",
             replaces="vslam_tpu/ops/pallas_associate.py:71",
             launches=launches["associate"],
             launches_track_step=step_launches["associate"],
             launches_chunked=chunked["launches"]["associate"],
             launches_variants=variants["launches"]["associate"],
             launches_variants_chunked=variants["chunk"]["launches"][
                 "associate"], **k2),
    ]
    for f in failures:
        print("FAIL:", f)
    if failures:
        return 1
    print(f"main path ms/frame: track_step {ms_frame:.3f}; process "
          + ", ".join(f"{k} {v[0]:.3f} (n={v[1]})" for k, v in ms_kind.items()
                      if v[0] is not None)
          + f"; global BA {ms_global:.3f} ms; "
          + ", ".join(f"{k} {v:.3f}" for k, v in ba_ms.items())
          + f"; chunked (phase 11) {chunked['ms_frame']:.3f} ms/frame, graph "
          f"replay {chunked['replay_ms']:.3f} ms (device), capture "
          f"{chunked['capture_s']:.2f} s, pool peak "
          f"{chunked['pool_mib']:.1f} MiB; variants (phase 13) process "
          + ", ".join(f"{k} {v[0]:.3f} (n={v[1]})"
                      for k, v in variants["ms"].items() if v[0] is not None)
          + f", chunked {variants['chunk']['ms_frame']:.3f} ms/frame, "
          f"capture {variants['chunk']['capture_s']:.2f} s, pool peak "
          f"{variants['chunk']['pool_mib']:.1f} MiB ({name}; {smi})")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
