"""Per-stage time of the tracking step on one GPU.

    python -m vslam_tpu_torch.ops.bench_stages [--device cuda:0] [--map-size N]

Port of ``vslam_tpu/ops/bench_stages.py``. The default config (1248x384,
3072 keypoints, 1024 RANSAC hypotheses) on a rendered synthetic pair, with
a live map of ``--map-size`` random points (51200 by default, bench.py's
cell). Each stage is timed two ways:

  * ``device_ms``: the stage captured once as a CUDA graph and replayed
    10 times (``utils.profiling.graph_times_ms``; the mean, and the least
    and most of one replay): its kernels' device time without the host's
    launch cost, what the chunked driver pays;
  * ``host_ms``: eager calls, host clock through a synchronize
    (``utils.profiling.host_ms``): what the per-frame driver pays.

Stages: feature extraction (upright; oriented; oriented with a carry of
every previous keypoint), matching (kernel K1), RANSAC pose, triangulation,
search-by-projection (kernel K2), map insert + cull, observation archive,
PnP; then the whole ``track_step`` of the default config (A) and of the
config with ``oriented`` and ``track_carry`` on (B), in the order A B B A,
each from its own capture. Prints one line per stage and one
JSON line with nvidia-smi's name and power limit; exits 2 without a CUDA
device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

from ..config import VSLAMConfig
from ..core import camera as cam
from ..core.types import empty_map
from ..datasets import synthetic
from ..frontend.frame import extract_features
from ..geometry import pnp, ransac, triangulation
from ..mapping import point_map
from ..matching import matcher
from ..pipeline import tracker
from ..utils.profiling import graph_times_ms, host_ms, nvidia_smi


def variants(cfg: VSLAMConfig) -> dict:
    """The default config and the one with both front-end variants on."""
    both = dataclasses.replace(cfg.frontend, oriented=True, track_carry=True)
    return {"default": cfg, "oriented+carry": cfg.replace(frontend=both)}


def stages(dev, map_size: int, cfg: VSLAMConfig = None):
    """[(name, fn, generators)] of the step's stages on realistic inputs,
    and the whole steps (``cfg``: the default config unless given). Every
    tensor a stage reads is made here, so each ``fn`` can be captured."""
    cfg = cfg or VSLAMConfig()
    K = cfg.camera.K()
    W, H = cfg.camera.width, cfg.camera.height
    scene = synthetic.make_scene(num_points=8000, seed=0,
                                 extent=(60, 12, 120), z_min=5.0)
    poses = synthetic.make_trajectory(2, step=1.0, seed=0)
    img0, img1 = (torch.from_numpy(f).to(dev) for f in
                  synthetic.render_sequence(K, poses, scene, W, H))
    Kd = torch.from_numpy(K).to(dev)
    fe = cfg.frontend
    oriented = dataclasses.replace(fe, oriented=True)
    f0 = extract_features(img0, fe, H, W)
    f1 = extract_features(img1, fe, H, W)
    mres = matcher.match(f0.desc, f0.mask, f1.desc, f1.mask, cfg.matching,
                         uv1=f0.uv, uv2=f1.uv)
    uv1, uv2 = f0.uv, f1.uv[mres.idx2.long()]

    rng = np.random.RandomState(7)
    xyz = torch.from_numpy((rng.randn(map_size, 3) * [20.0, 8.0, 30.0]
                            + [0.0, 0.0, 40.0]).astype(np.float32)).to(dev)
    desc = torch.from_numpy(rng.randint(-2 ** 31, 2 ** 31, (map_size, 8),
                                        dtype=np.int64).astype(np.int32)
                            ).to(dev)
    ones = lambda n: torch.ones(n, dtype=torch.bool, device=dev)
    frame0, frame3, frame100 = (torch.tensor(i, dtype=torch.int32,
                                             device=dev) for i in (0, 3, 100))
    eye = torch.eye(4, device=dev)
    m = point_map.insert_points(
        empty_map(cfg.map.capacity, cfg.map.obs_per_point, dev), xyz,
        torch.zeros((map_size, 3), device=dev), desc, ones(map_size),
        frame_idx=frame0)
    P1 = cam.projection_matrix(Kd, eye)
    P2 = cam.projection_matrix(Kd, torch.from_numpy(poses[1]).to(dev))
    gen = torch.Generator(device=dev).manual_seed(0)
    n = fe.max_keypoints
    ids = (torch.arange(n, dtype=torch.int32, device=dev) * 4) % map_size
    rc = cfg.ransac

    out = [
        ("features upright", lambda: extract_features(img1, fe, H, W), ()),
        ("features oriented",
         lambda: extract_features(img1, oriented, H, W), ()),
        ("features oriented+carry", lambda: extract_features(
            img1, oriented, H, W, f0.uv, f0.mask), ()),
        ("match (K1 + ratio + cross-check)", lambda: matcher.match(
            f0.desc, f0.mask, f1.desc, f1.mask, cfg.matching, uv1=f0.uv,
            uv2=f1.uv), ()),
        (f"ransac_pose ({rc.num_hypotheses} hypotheses)",
         lambda: ransac.ransac_pose(
             gen, uv1, uv2, mres.mask, Kd, num_hypotheses=rc.num_hypotheses,
             inlier_threshold=rc.inlier_threshold,
             min_inliers=rc.min_inliers), (gen,)),
        (f"triangulate_dlt ({n} points)",
         lambda: triangulation.triangulate_dlt(P1, P2, uv1, uv2), ()),
        (f"associate (K2, map {map_size})", lambda: point_map.associate(
            m, P2, f1.uv, f1.desc, f1.mask, cfg.map, cfg.matching, W, H,
            frame_idx=frame3), ()),
        ("insert + cull", lambda: point_map.cull_stale(
            point_map.insert_points(m, xyz[:n], torch.zeros((n, 3),
                                                            device=dev),
                                    desc[:n], ones(n), frame_idx=frame3),
            frame100), ()),
        ("observe (archive scatter)", lambda: point_map.add_observations(
            m, ids, f1.desc, f1.mask, frame3), ()),
        ("pnp refine (8 GN iterations)", lambda: pnp.refine_pose(
            eye, xyz[:n], f1.uv, f1.mask, Kd,
            iters=8), ()),
    ]
    for name, c in variants(cfg).items():
        st = tracker.bootstrap(img0, c, dev).replace(map=m)
        out.append((f"track_step {name}",
                    lambda st=st, c=c: tracker.track_step(st, img1, c),
                    (st.key,)))
    return out


def _row(name, fn, gens) -> dict:
    """Host ms, and device ms of 10 replays of one capture: their mean and
    spread (a spread shows replays that do unequal work)."""
    host = host_ms(fn)
    times = graph_times_ms(fn, generators=gens)
    row = dict(stage=name, host_ms=host, device_ms=sum(times) / len(times),
               device_ms_min=min(times), device_ms_max=max(times))
    print(f"stage {name:42s} device {row['device_ms']:9.3f} ms "
          f"({min(times):.3f}-{max(times):.3f})   host {host:9.3f} ms")
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="a CUDA device")
    ap.add_argument("--map-size", type=int, default=51200)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        print(f"bench_stages: {args.device} is not an available CUDA device",
              file=sys.stderr)
        return 2
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    torch.cuda.set_device(dev)
    rows, steps = [], []
    for name, fn, gens in stages(dev, args.map_size):
        if name.startswith("track_step"):
            steps.append((name, fn, gens))
            continue
        rows.append(_row(name, fn, gens))
    # the whole steps in the order A B B A, each reading a fresh capture:
    # a drift between captures shows as a gap between a config's readings
    rows += [_row(*s) for s in steps + steps[::-1]]
    print(json.dumps(dict(device=torch.cuda.get_device_name(dev),
                          smi=nvidia_smi(), map_size=args.map_size,
                          stages=rows)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
