"""Endurance: long-run correctness with asserted bounds, in three segments.

    python -m vslam_tpu_torch.tools.endurance [--frames 600] [--device cuda] \
        [--out out/endurance] [--chunk 10] [--rng threefry]
    python -m vslam_tpu_torch.tools.endurance --seeds 7,11,23,42 \
        --seed-frames 150

Counterpart of the repository's ``scripts/endurance.py``, on the device
``--device`` names (the reference runs on the host CPU). The config is
``small_config()`` with keyframes every 5th frame, a ring of 256 (so global
BA covers a 600-frame run), window BA every 5th keyframe and map capacity
1024 (so maintenance fires mid-run).

1. **Corridor**: ``frames`` frames through ``cli.main`` (``run --synthetic
   --corridor --global-ba --snapshot-every 50``, the CLI's per-frame
   ``process``), and the same sequence with ``--no-ba`` as the control.
   ``maintenance_runs`` counts this run's ``map_maintenance`` rows, which
   only ``process`` writes.
2. **Revisit**: a dense box scene (900 landmarks, 0.35 m steps) and
   keyframes every 2nd frame, for each scene seed, window BA on and off
   over the same frames: the regime window BA exists for.
3. **Seed sweep**: the 150-frame corridor for each seed of ``--seeds``.

``--chunk N`` runs segments 2 and 3 through ``process_chunk`` in chunks of
N frames (10 = the revisit config's ``keyframe_every * local_ba_every``)
instead of ``process`` per frame. The corridor always runs the CLI.

``--rng threefry`` (the default) draws every segment's RANSAC samples from
the reference's own ``jax.random`` stream (``utils.threefry``), so each run
sees the samples the reference's run with the same seed sees (the stream
the reference measured its bounds on); ``--rng torch`` draws them from a
``torch.Generator``. On that stream the reference's own revisit breaks
its 1.05 bound on scene seeds 3 and 4 of the default four (PERF.md), and
the port breaks it on 3, so ``check`` fails there for both.

``endurance.json`` holds the reference's keys, with one rename:
``fps_vs_map_size_cpu_host`` becomes ``fps_vs_map_size`` and its rows'
``fps_cpu_host`` becomes ``fps`` (the rate on ``--device``, from the
corridor's per-frame ``wall_s``); ``device`` is added (the device's name
and, on a card, nvidia-smi's name and power limit). ``window_ba_accepted``
counts BA rows whose ``ba_result_accepted`` is true, as the reference
does; skipped events are ``window_ba_starved``. ``check`` holds a report
to the reference's asserts. Exits 2 when ``--device`` names a CUDA device
that is not available, 1 when ``check`` fails.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys

import numpy as np
import torch

from .. import cli
from ..config import VSLAMConfig, small_config
from ..datasets import synthetic
from ..pipeline import slam
from ..utils import evaluate
from ..utils.profiling import device_record
from . import device_arg


def config() -> VSLAMConfig:
    cfg = small_config()
    return cfg.replace(
        pipeline=dataclasses.replace(
            cfg.pipeline, keyframe_every=5, max_keyframes=256,
            local_ba_every=5),
        map=dataclasses.replace(cfg.map, capacity=1024))


def revisit_config(cfg: VSLAMConfig) -> VSLAMConfig:
    return cfg.replace(pipeline=dataclasses.replace(
        cfg.pipeline, keyframe_every=2, max_keyframes=96, local_ba_every=5))


def _drive(s, frames, chunk: int) -> None:
    """Feed ``frames`` to ``s``: ``process`` per frame, or ``process_chunk``
    in chunks of ``chunk`` (the first chunk is bootstrap + ``chunk``)."""
    if chunk <= 0:
        for f in frames:
            s.process(f)
        return
    stack = np.stack(frames)
    s.process_chunk(stack[:chunk + 1])
    for s0 in range(chunk + 1, len(frames), chunk):
        s.process_chunk(stack[s0:s0 + chunk])


def _frame_rows(s):
    return [r for r in s.metrics.records
            if r.get("kind") == "frame" and "success" in r]


def run_revisit(cfg, seed, out_dir, device, frames_n=100,
                scene_seeds=(2, 3, 4, 5), chunk=0, rng="threefry",
                events=None):
    """Dense-box revisit runs, window BA on and off over the same frames,
    for each scene seed. Writes ``revisit.json``; returns its report (the
    first seed's numbers also at the top level). A dict ``events`` gets
    each run's BA metric rows under (scene seed, "ba" or "no_ba")."""
    rcfg = revisit_config(cfg)
    K = rcfg.camera.K()
    W, H = rcfg.camera.width, rcfg.camera.height
    rows = []
    for ss in scene_seeds:
        poses = synthetic.make_trajectory(frames_n, step=0.35,
                                          yaw_rate=0.002, seed=ss)
        scene = synthetic.make_scene(num_points=900, seed=ss,
                                     extent=(16, 6, 60), z_min=6.0)
        frames = [synthetic.render_frame(K, poses[i], scene, W, H)
                  for i in range(frames_n)]
        out = {"scene_seed": ss}
        for label, ba_on in (("ba", True), ("no_ba", False)):
            s = slam.SLAMSystem(rcfg, device, seed=seed, enable_ba=ba_on,
                                rng=rng)
            _drive(s, frames, chunk)
            ba_rows = [r for r in s.metrics.records if r.get("kind") == "ba"]
            if events is not None:
                events[ss, label] = ba_rows
            fr = _frame_rows(s)
            ate, _, _ = evaluate.ate_rmse(s.poses(),
                                          poses.astype(np.float64))
            out.update({
                f"{label}_ate_rmse": float(ate),
                f"{label}_success_rate":
                    sum(r["success"] for r in fr) / len(fr),
                f"{label}_ba_events": len(ba_rows),
                f"{label}_ba_accepted": sum(
                    1 for r in ba_rows if r.get("ba_result_accepted")),
                f"{label}_ba_skipped": sum(
                    1 for r in ba_rows if r.get("skipped")),
            })
        rows.append(out)
        print("revisit:", json.dumps(out), flush=True)
    report = {"frames": frames_n, "seeds": rows,
              **{k: v for k, v in rows[0].items() if k != "scene_seed"}}
    with open(os.path.join(out_dir, "revisit.json"), "w") as f:
        json.dump(report, f, indent=2)
    return report


def run_seed_sweep(cfg, seeds, frames_n, out_dir, device, chunk=0,
                   rng="threefry"):
    """Corridor runs for each seed, with per-seed bounds (``check``).
    Writes ``seeds.json``; returns its report."""
    K = cfg.camera.K()
    W, H = cfg.camera.width, cfg.camera.height
    rows = []
    for seed in seeds:
        poses = synthetic.make_trajectory(frames_n, step=0.6, seed=seed)
        scene = synthetic.make_corridor_scene(
            poses, num_points=frames_n * 100, seed=seed)
        frames = [synthetic.render_frame(K, poses[i], scene, W, H)
                  for i in range(frames_n)]
        s = slam.SLAMSystem(cfg, device, seed=seed, enable_ba=True, rng=rng)
        _drive(s, frames, chunk)
        fr = _frame_rows(s)
        ate, _, _ = evaluate.ate_rmse(s.poses(), poses.astype(np.float64))
        med = lambda k: float(np.median([r[k] for r in fr]))
        rows.append({
            "seed": seed,
            "frames": len(fr),
            "ate_rmse": round(float(ate), 4),
            "success_rate": sum(r["success"] for r in fr) / len(fr),
            "med_tracked_map": med("num_tracked_map"),
            "med_associated": med("num_associated"),
        })
        print("seed sweep:", json.dumps(rows[-1]), flush=True)
    report = {"frames_per_seed": frames_n, "seeds": rows}
    with open(os.path.join(out_dir, "seeds.json"), "w") as f:
        json.dump(report, f, indent=2)
    return report


def _fresh(out_dir) -> None:
    """MetricsLogger appends: drop an earlier run's metrics."""
    path = os.path.join(out_dir, "metrics.jsonl")
    if os.path.exists(path):
        os.remove(path)


def run(device, out="out/endurance", frames=600, seed=7,
        seeds=(7, 11, 23, 42), seed_frames=150, chunk=0,
        revisit_frames=100, revisit_seeds=(2, 3, 4, 5), rng="threefry"):
    """The three segments on ``device``; writes and returns the report."""
    device = torch.device(device)
    cfg = config()
    os.makedirs(out, exist_ok=True)
    cfg_path = os.path.join(out, "config.json")
    with open(cfg_path, "w") as f:
        f.write(cfg.to_json())
    out_ctl = os.path.join(out, "no_ba_control")
    for d in (out, out_ctl):
        _fresh(d)

    common = ["run", "--synthetic", "--corridor", "--frames", str(frames),
              "--synthetic-points", str(frames * 100), "--config", cfg_path,
              "--seed", str(seed), "--device", device.type, "--rng", rng]
    rc = cli.main(common + ["--global-ba", "--snapshot-every", "50",
                            "--out", out])
    if rc != 0:
        raise RuntimeError(f"corridor run exited {rc}")
    rc = cli.main(common + ["--no-ba", "--out", out_ctl])
    if rc != 0:
        raise RuntimeError(f"corridor control run exited {rc}")

    revisit = run_revisit(cfg, seed, out, device, revisit_frames,
                          revisit_seeds, chunk, rng)
    seed_report = (run_seed_sweep(cfg, seeds, seed_frames, out, device,
                                  chunk, rng) if seeds else None)

    with open(os.path.join(out, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    frames_r = [r for r in rows if r.get("kind") == "frame"
                and "map_size" in r]
    maint = [r for r in rows if r.get("kind") == "map_maintenance"]
    ba_ev = [r for r in rows if r.get("kind") == "ba"]
    gba = [r for r in rows if r.get("kind") == "global_ba"]
    with open(os.path.join(out, "summary.json")) as f:
        summary = json.load(f)
    with open(os.path.join(out_ctl, "summary.json")) as f:
        summary_ctl = json.load(f)

    bucket = 50
    curve = []
    for b in range(0, len(frames_r), bucket):
        blk = frames_r[b:b + bucket]
        curve.append({
            "frame": blk[-1]["frame"],
            "map_size": blk[-1]["map_size"],
            "map_alive": blk[-1]["map_alive"],
            "fps": round(len(blk) / sum(r["wall_s"] for r in blk), 3),
        })
    med = lambda k: float(np.median([r.get(k, 0) for r in frames_r]))
    report = {
        "device": device_record(device),
        "frames": len(frames_r),
        "ate_rmse": summary.get("ate_rmse"),
        "rpe_trans": summary.get("rpe_trans"),
        "rpe_rot_deg": summary.get("rpe_rot_deg"),
        "ate_rmse_no_ba_control": summary_ctl.get("ate_rmse"),
        "success_rate": sum(r["success"] for r in frames_r) / len(frames_r),
        "med_associated": med("num_associated"),
        "med_tracked_map": med("num_tracked_map"),
        "med_tracked_prov": med("num_tracked_prov"),
        "med_pnp_inliers": med("num_pnp_inliers"),
        "maintenance_runs": len(maint),
        "dropped_inserts_total": sum(r["num_dropped_inserts"]
                                     for r in frames_r),
        "window_ba_events": len(ba_ev),
        "window_ba_accepted": sum(bool(r.get("ba_result_accepted"))
                                  for r in ba_ev),
        "window_ba_starved": sum(1 for r in ba_ev if r.get("skipped")),
        "global_ba": gba[-1] if gba else None,
        "revisit": revisit,
        "seed_sweep": seed_report,
        "fps_vs_map_size": curve,
        "note": (f"corridor through the CLI's per-frame driver on "
                 f"{device.type}; revisit and seed sweep through "
                 + (f"process_chunk in chunks of {chunk}" if chunk > 0
                    else "process per frame")
                 + f"; RANSAC stream {rng}"),
    }
    with open(os.path.join(out, "endurance.json"), "w") as f:
        json.dump(report, f, indent=2)
    return report


def check(report) -> None:
    """The reference's asserted bounds, the seed sweep's per-seed bounds
    included; raises AssertionError."""
    bad = []
    if report["success_rate"] != 1.0:
        bad.append(f"success_rate {report['success_rate']}")
    if not report["maintenance_runs"] >= 1:
        bad.append("maintenance never exercised")
    if report["dropped_inserts_total"] != 0:
        bad.append(f"dropped_inserts_total {report['dropped_inserts_total']}")
    g = report["global_ba"]
    if g is None or g["dropped_points"] != 0 or g["dropped_obs"] != 0 \
            or g["evicted_keyframes"] != 0:
        bad.append(f"global BA {g}")
    if report["rpe_trans"] is None or not math.isfinite(report["rpe_trans"]):
        bad.append(f"rpe_trans {report['rpe_trans']}")
    if not report["med_associated"] >= 20:
        bad.append(f"med_associated {report['med_associated']}")
    if not report["med_tracked_map"] >= 8:
        bad.append(f"med_tracked_map {report['med_tracked_map']}")
    ate, ctl = report["ate_rmse"], report["ate_rmse_no_ba_control"]
    if ate is None or not ate < 0.6:
        bad.append(f"ate_rmse {ate}")
    elif ctl is None or not ate <= 1.05 * ctl:
        bad.append(f"BA hurt the corridor: ate {ate} vs control {ctl}")
    # a report from before the multi-seed revisit holds its one seed at
    # the top level, where later reports repeat their first seed
    rows = report["revisit"].get("seeds") or [report["revisit"]]
    n_engaged = 0
    for row in rows:
        seed = row.get("scene_seed", "")
        if row["ba_success_rate"] != 1.0:
            bad.append(f"revisit seed {seed} lost tracking")
        if not row["ba_ate_rmse"] <= 1.05 * row["no_ba_ate_rmse"] + 1e-3:
            bad.append(f"revisit seed {seed}: BA on {row['ba_ate_rmse']} "
                       f"vs off {row['no_ba_ate_rmse']}")
        n_engaged += row["ba_ba_accepted"] >= 1
    if n_engaged < len(rows) // 2:
        bad.append(f"window BA engaged on {n_engaged} of {len(rows)} "
                   "revisit seeds")
    for r in (report["seed_sweep"] or {}).get("seeds", []):
        if (r["success_rate"] != 1.0 or not r["ate_rmse"] < 0.8
                or not r["med_associated"] >= 5
                or not r["med_tracked_map"] >= 5):
            bad.append(f"seed sweep {r}")
    if bad:
        raise AssertionError("; ".join(bad))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=600)
    ap.add_argument("--out", default="out/endurance")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--seeds", default="7,11,23,42",
                    help="comma-separated seeds for the seed sweep; an "
                         "empty string disables it")
    ap.add_argument("--seed-frames", type=int, default=150)
    ap.add_argument("--revisit-frames", type=int, default=100)
    ap.add_argument("--revisit-seeds", default="2,3,4,5")
    ap.add_argument("--chunk", type=int, default=0,
                    help="run the revisit and sweep segments through "
                         "process_chunk in chunks of N frames; 0 runs "
                         "process per frame")
    ap.add_argument("--rng", choices=["threefry", "torch"],
                    default="threefry",
                    help="RANSAC stream of every segment: the reference's "
                         "jax.random stream, or a torch.Generator")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dev = device_arg("endurance", args.device)
    if dev is None:
        return 2
    ints = lambda s: tuple(int(x) for x in s.split(",") if x.strip())
    report = run(dev, args.out, args.frames, args.seed, ints(args.seeds),
                 args.seed_frames, args.chunk, args.revisit_frames,
                 ints(args.revisit_seeds), args.rng)
    print(json.dumps(report, indent=2))
    try:
        check(report)
    except AssertionError as e:
        print(f"endurance: {e}", file=sys.stderr)
        return 1
    print("ENDURANCE OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
