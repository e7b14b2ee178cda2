#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``vslam_tpu_torch``) on one GPU.

Run from the repository root: ``python3 chip_smoke.py``. Phases, in order
(any failure exits nonzero):

  1. the card: torch's device name, and nvidia-smi's name and power limit;
  2. build the CUDA kernels from ``vslam_tpu_torch/csrc`` (nvcc, first use);
  3. kernel K1 (Hamming matrix) vs its plain torch version: random
     descriptors at 3072 x 3072 and 100 x 300 (ragged edges), exact;
  4. kernel K2 (search-by-projection) vs its plain version: capacity
     131072 holding 51200 corridor distractors plus planted near-duplicates
     (hits in both tiers), 3072 keypoints, exact;
  5. the tracking step on CUDA vs on the CPU (plain versions), small
     config, the same injected RANSAC samples, per-frame tolerances;
  6. the main path: bootstrap + 11 ``track_step`` of the default config
     (1248x384, 3072 keypoints, 1024 hypotheses, map capacity 131072) on
     CUDA, after a warm-up. Launch counters are reset just before and read
     just after; the steps must not synchronize with the host; at least 80%
     of frames must succeed, the median inlier count must exceed 50 and the
     map must grow. Prints ms/frame.

The line before the last is one JSON object per kernel (route, source,
the TPU kernel it replaces, launches on the main path, max |error| vs the
plain version, kernel and plain times); then the nvidia-smi line; the last
line is ``{"ok": true, "device": {...}}``. No GPU: exits 2 and prints no
result.
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


def _flip_bits(rng, words_i32, n_bits):
    """Flip n distinct random bits of one (8,) int32 descriptor."""
    bits = np.unpackbits(words_i32.view(np.uint8), bitorder="little")
    pos = rng.choice(256, n_bits, replace=False)
    bits[pos] ^= 1
    return np.packbits(bits, bitorder="little").view(np.int32)


def check_k1(torch, dev, failures):
    from vslam_tpu_torch.ops import hamming

    rng = np.random.RandomState(0)
    err, shapes = 0, ((3072, 3072), (100, 300))
    big = None
    for n1, n2 in shapes:
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
    ms = _time_ms(torch, lambda: hamming.hamming_cuda(*big))
    plain_ms = _time_ms(torch, lambda: hamming.hamming_plain(*big))
    print(f"K1 3072x3072: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def k2_inputs(torch, dev, cfg):
    """Kernel K2's inputs at the main path's shapes: capacity 131072 with
    51200 random-descriptor distractors along the corridor (as bench.py
    builds them) and 600 points with planted near-duplicate keypoints."""
    from vslam_tpu_torch.core import camera as cam
    from vslam_tpu_torch.core.types import empty_map
    from vslam_tpu_torch.mapping import point_map

    rng = np.random.RandomState(1)
    C, K = cfg.map.capacity, cfg.map.obs_per_point
    N = cfg.frontend.max_keypoints
    W, H = cfg.camera.width, cfg.camera.height
    n_map, n_plant, frame = 51200, 600, 20
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
                kp_uv=t(kp_uv), kp_free=t(kp_free), kp_desc=t(kp_desc))


def check_k2(torch, dev, cfg, failures):
    from vslam_tpu_torch.mapping import point_map
    from vslam_tpu_torch.ops import associate as k2

    args = k2_inputs(torch, dev, cfg)
    kw = dict(point_map.gates(cfg.matching), block=cfg.map.block_size)
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
    print(f"K2 C={cfg.map.capacity} size={int(args['size'])} "
          f"N={args['kp_uv'].shape[0]}: ids+distances equal={same}, "
          f"hits strict={strict} reacq-band={band}")
    if not same:
        failures.append("K2 disagrees with its plain version")
    if strict == 0 or band == 0:
        failures.append("K2 check did not exercise both tiers")
    ms = _time_ms(torch, lambda: k2.associate_cuda(**args, **kw))
    plain_ms = _time_ms(torch, lambda: k2.associate_plain(**args, **kw),
                        reps=5)
    print(f"K2: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def _render(cfg, n_frames, scene_kw, step, seed):
    from vslam_tpu_torch.datasets import synthetic

    K = cfg.camera.K()
    W, H = cfg.camera.width, cfg.camera.height
    scene = synthetic.make_scene(seed=seed, **scene_kw)
    poses = synthetic.make_trajectory(n_frames, step=step, seed=seed)
    return synthetic.render_sequence(K, poses, scene, W, H), poses


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
    frames_np, poses = _render(cfg, n_frames, dict(
        num_points=12000, extent=(80, 15, 160), z_min=5.0), 1.0, 0)
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
        if "registers" in line or "spill" in line or "error" in line:
            print("  ptxas:", line.strip())

    k1 = check_k1(torch, dev, failures)
    k2 = check_k2(torch, dev, VSLAMConfig(), failures)
    check_step_vs_cpu(torch, dev, failures)
    launches, ms_frame = run_main_path(torch, dev, failures)

    kernels = [
        dict(name="hamming", route="cuda",
             source="vslam_tpu_torch/csrc/hamming.cu",
             replaces="vslam_tpu/ops/pallas_hamming.py:50",
             launches=launches["hamming"], **k1),
        dict(name="associate", route="cuda",
             source="vslam_tpu_torch/csrc/associate.cu",
             replaces="vslam_tpu/ops/pallas_associate.py:71",
             launches=launches["associate"], **k2),
    ]
    for f in failures:
        print("FAIL:", f)
    if failures:
        return 1
    print(f"main path ms/frame: {ms_frame:.3f} ({name}; {smi})")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
