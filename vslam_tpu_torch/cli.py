"""Command-line interface of the port.

Port of ``vslam_tpu/cli.py`` with the same subcommands, flags and outputs;
``--platform`` becomes ``--device {cuda,cpu}`` (default cuda):

    python -m vslam_tpu_torch.cli run --synthetic
    python -m vslam_tpu_torch.cli run --video clip.mp4 --focal 525
    python -m vslam_tpu_torch.cli run --kitti /data/kitti --sequence 00
    python -m vslam_tpu_torch.cli run --tum /data/tum/fr1_xyz
    python -m vslam_tpu_torch.cli eval --est traj.txt --gt gt.txt

Outputs: TUM + KITTI trajectories, PNG/HTML/PLY map renders, JSONL metrics,
and ATE/RPE against ground truth when available.

``run --mesh N`` shards the map across N ranks (BASELINE config 4). Under
torchrun (``torchrun --nproc-per-node N -m vslam_tpu_torch.cli run --mesh
N ...``) each rank joins the group from torchrun's environment; otherwise
the command spawns the N ranks itself, on one host. NCCL needs one GPU per
rank; ``--device cpu`` runs the ranks on gloo. Rank 0 writes the outputs.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def _build_cfg(args, camera=None):
    """Precedence (lowest to highest): defaults/--small < --config JSON <
    dataset-derived camera calibration. The dataset knows its own intrinsics;
    a JSON config must not silently discard them."""
    from .config import VSLAMConfig, small_config
    cfg = small_config() if args.small else VSLAMConfig()
    if args.config:
        with open(args.config) as f:
            cfg = VSLAMConfig.from_json(f.read())
    if camera is not None:
        cfg = cfg.replace(camera=camera)
    return cfg


def cmd_run(args):
    if not args.mesh:
        return _run(args)
    if "WORLD_SIZE" in os.environ:
        from .parallel import multihost
        multihost.initialize(device_type=args.device)
        return _run_meshed(args)
    if args.device == "cuda":
        import torch
        n = torch.cuda.device_count()
        if n < args.mesh:
            print(f"--mesh {args.mesh} needs {args.mesh} devices, have {n}",
                  file=sys.stderr)
            return 2
    return _spawn(args) if args.mesh > 1 else _run_meshed(args)


def _spawn(args):
    """Run ``args`` on ``args.mesh`` spawned ranks of this host."""
    from .parallel import multihost

    codes = multihost.spawn(_rank_main, args.mesh, (args,))
    if any(codes):
        print(f"--mesh {args.mesh}: the ranks exited with {codes}",
              file=sys.stderr)
        return 1
    return 0


def _rank_main(rank: int, init_method: str, args):
    """One spawned rank: join the group, run, leave."""
    import torch

    from .parallel import multihost
    if args.device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // args.mesh))
    multihost.initialize(init_method, world_size=args.mesh, rank=rank,
                         local_rank=rank, device_type=args.device)
    sys.exit(_run_meshed(args))


def _run_meshed(args):
    """``_run`` on the mesh, then leave the group, also when it raises
    (``multihost.shutdown``: NCCL's teardown waits for the captured
    graphs, which it frees first)."""
    from .parallel import multihost
    try:
        return _run(args)
    finally:
        multihost.shutdown()


def _run(args):
    from .pipeline.slam import SLAMSystem
    from .utils import evaluate, trajectory
    from .viz import render

    mesh = None
    if args.mesh:
        from .parallel import multihost
        mesh = multihost.global_mesh(_build_cfg(args).mesh.axis_map,
                                     device_type=args.device)
        if mesh.size() != args.mesh:
            print(f"--mesh {args.mesh}: the process group has "
                  f"{mesh.size()} ranks", file=sys.stderr)
            return 2
    rank0 = mesh is None or mesh.get_rank() == 0
    if rank0:
        os.makedirs(args.out, exist_ok=True)
    gt_poses = None

    if args.synthetic:
        from .datasets import synthetic
        cfg = _build_cfg(args)
        K = cfg.camera.K()
        if args.corridor:
            # landmarks along the whole path — required for endurance runs
            # that walk out of a fixed scene box. Anchors extend past the
            # run's end so feature density stays constant to the last frame.
            ext_poses = synthetic.make_trajectory(args.frames + 80, step=0.6,
                                                  yaw_rate=0.01,
                                                  seed=args.seed)
            gt_poses = ext_poses[: args.frames]
            scene = synthetic.make_corridor_scene(
                ext_poses, num_points=args.synthetic_points, seed=args.seed)
        else:
            gt_poses = synthetic.make_trajectory(args.frames, step=0.6,
                                                 yaw_rate=0.01,
                                                 seed=args.seed)
            scene = synthetic.make_scene(
                num_points=args.synthetic_points, seed=args.seed,
                extent=(40, 10, 80), z_min=5.0,
            )
        source = (
            (i, synthetic.render_frame(K, gt_poses[i], scene,
                                       cfg.camera.width, cfg.camera.height))
            for i in range(args.frames)
        )
        n_total = args.frames
    else:
        if args.kitti:
            from .datasets.loaders import KittiOdometry
            ds = KittiOdometry(args.kitti, args.sequence,
                               target=(args.width, args.height)
                               if args.width else None)
            if ds.gt_poses is not None:
                gt_poses = ds.gt_poses
        elif args.tum:
            from .datasets.loaders import TumRgbdMono
            ds = TumRgbdMono(args.tum, target=(args.width, args.height)
                             if args.width else None)
        elif args.video:
            from .datasets.loaders import VideoFile
            ds = VideoFile(args.video, focal=args.focal,
                           target=(args.width, args.height)
                           if args.width else None)
        else:
            print("choose an input: --synthetic | --kitti | --tum | --video",
                  file=sys.stderr)
            return 2
        cfg = _build_cfg(args, camera=ds.camera)
        source = iter(ds)
        n_total = len(ds)

    sys_ = SLAMSystem(cfg, args.device,
                      metrics_path=os.path.join(args.out, "metrics.jsonl")
                      if rank0 else None,
                      enable_ba=not args.no_ba, seed=args.seed, mesh=mesh,
                      rng=args.rng)
    if args.save_frames and rank0:
        os.makedirs(os.path.join(args.out, "frames"), exist_ok=True)
    stream = None
    limit = args.frames if args.frames else n_total
    for i, img in source:
        if i >= limit:
            break
        info = sys_.process(img)
        if args.save_frames and rank0 and sys_.last_output is not None:
            from .viz.frames import annotate_frame
            o = sys_.last_output
            host = lambda t: t.detach().cpu().numpy()
            annotate_frame(
                np.asarray(img),
                kp_uv=host(o.kp_uv), kp_mask=host(o.kp_mask),
                match_uv1=host(o.uv1), match_uv2=host(o.uv2),
                match_mask=host(o.match_mask),
                path=os.path.join(args.out, "frames", f"{i:06d}.png"),
            )
        if args.snapshot_every and i > 0 and i % args.snapshot_every == 0:
            snap = sys_.snapshot()           # every rank: it gathers the map
            if rank0:
                if stream is None:
                    from .viz.stream import MapStream
                    stream = MapStream(args.out)
                stream.update(snap, frame=i)
        if args.verbose and rank0 and "num_matches" in info:
            print(f"frame {info['frame']:4d}: matches={info['num_matches']:4d} "
                  f"inliers={info['num_inliers']:4d} map={info['map_size']:6d} "
                  f"{'KF' if info.get('keyframe') else '  '}"
                  f"{' BA' if info.get('ran_ba') else ''}")

    if args.global_ba and sys_._kf_count >= 3:
        stats = sys_.run_global_ba()
        if rank0:
            print(f"global BA: cost {float(stats.initial_cost):.1f} -> "
                  f"{float(stats.final_cost):.1f}")

    snap = sys_.snapshot()
    if not rank0:
        return 0
    poses = sys_.poses()
    trajectory.save_tum(os.path.join(args.out, "trajectory_tum.txt"), poses)
    trajectory.save_kitti(os.path.join(args.out, "trajectory_kitti.txt"), poses)
    try:
        render.render_png(snap, os.path.join(args.out, "map.png"))
    except ImportError as e:            # matplotlib is optional
        print(f"map.png not written: {e}", file=sys.stderr)
    render.save_html(snap, os.path.join(args.out, "map.html"))
    render.save_ply(snap, os.path.join(args.out, "map.ply"))

    summary = sys_.metrics.summary()
    if gt_poses is not None and len(gt_poses) >= len(poses):
        rmse, _, _ = evaluate.ate_rmse(poses, gt_poses[: len(poses)].astype(np.float64))
        summary["ate_rmse"] = rmse
        t_rpe, r_rpe = evaluate.rpe(poses, gt_poses[: len(poses)])
        summary["rpe_trans"] = t_rpe
        summary["rpe_rot_deg"] = r_rpe
    summary["map_points"] = int(snap["points"].shape[0])
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary, indent=2))
    return 0


def cmd_eval(args):
    from .utils import evaluate, trajectory
    _, est = trajectory.load_tum(args.est)
    _, gt = trajectory.load_tum(args.gt)
    n = min(len(est), len(gt))
    rmse, _, _ = evaluate.ate_rmse(est[:n], gt[:n])
    t_rpe, r_rpe = evaluate.rpe(est[:n], gt[:n])
    print(json.dumps({"ate_rmse": rmse, "rpe_trans": t_rpe,
                      "rpe_rot_deg": r_rpe}, indent=2))
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(prog="vslam_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("run", help="run SLAM on a sequence")
    r.add_argument("--synthetic", action="store_true")
    r.add_argument("--synthetic-points", type=int, default=4000)
    r.add_argument("--corridor", action="store_true",
                   help="distribute synthetic landmarks along the whole "
                        "trajectory (for long endurance runs)")
    r.add_argument("--kitti", help="KITTI odometry root dir")
    r.add_argument("--sequence", default="00")
    r.add_argument("--tum", help="TUM RGB-D sequence dir")
    r.add_argument("--video", help="video file (reference-compatible input)")
    r.add_argument("--focal", type=float, default=525.0,
                   help="focal length for --video (reference env var F)")
    r.add_argument("--frames", type=int, default=0, help="limit frame count")
    r.add_argument("--width", type=int, default=0)
    r.add_argument("--height", type=int, default=0)
    r.add_argument("--out", default="out")
    r.add_argument("--config", help="JSON config file")
    r.add_argument("--small", action="store_true", help="small/fast config")
    r.add_argument("--no-ba", action="store_true")
    r.add_argument("--mesh", type=int, default=0,
                   help="shard the map's point axis across N ranks "
                        "(BASELINE config 4; association runs shard-local "
                        "with a cross-shard arg-best): joins torchrun's "
                        "group, or spawns N ranks on this host")
    r.add_argument("--global-ba", action="store_true",
                   help="run global BA over all keyframes at end of sequence")
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--rng", choices=["torch", "threefry"], default="torch",
                   help="RANSAC stream: a torch.Generator, or the "
                        "reference's jax.random Threefry stream (the same "
                        "samples as the JAX package with the same --seed)")
    r.add_argument("--verbose", "-v", action="store_true")
    r.add_argument("--save-frames", action="store_true",
                   help="write annotated PNG per frame (keypoints + match "
                   "lines; the reference's live window, offline)")
    r.add_argument("--snapshot-every", type=int, default=0,
                   help="append a map delta to out/stream.jsonl every N "
                        "frames; out/live.html tails it (serve the out dir "
                        "with `python -m http.server` for a live view)")
    r.set_defaults(fn=cmd_run)

    e = sub.add_parser("eval", help="ATE/RPE between TUM trajectories")
    e.add_argument("--est", required=True)
    e.add_argument("--gt", required=True)
    e.set_defaults(fn=cmd_eval)

    for sp in (r, e):
        sp.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="the torch device the system runs on")

    args = p.parse_args(argv)
    if args.cmd == "run" and args.synthetic and not args.frames:
        args.frames = 30
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
