"""Where the time of the port's tracking step goes, on one GPU.

Run from the repository root: ``python scripts/profile_torch_step.py``.
Tracks the default config (1248x384, 3072 keypoints, capacity 131072) over
the synthetic scene chip_smoke.py uses; after two warm-up steps it profiles
``--steps`` steps unprofiled for the wall time, then ``--steps`` more with
``torch.profiler`` (CPU + CUDA activity), every step eager
(``utils.jit.disable_jit``: a direct ``track_step`` on a card replays a
captured graph, whose stages no span can see). Each stage
of ``tracker._step_impl`` is wrapped, here only, in a ``record_function``
span, so the report gives per stage: host time (the span's CPU total) and
the number of operators it issued; and for the whole window: wall time,
the device's busy time (sum of kernel durations) and its idle share.
The top operators by host time follow. ``--out FILE`` also writes the
report to FILE.
"""
from __future__ import annotations

import argparse
import functools
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from vslam_tpu_torch.config import VSLAMConfig  # noqa: E402
from vslam_tpu_torch.datasets import synthetic  # noqa: E402
from vslam_tpu_torch.geometry import pnp, ransac, triangulation  # noqa: E402
from vslam_tpu_torch.mapping import point_map  # noqa: E402
from vslam_tpu_torch.matching import matcher  # noqa: E402
from vslam_tpu_torch.pipeline import tracker  # noqa: E402
from vslam_tpu_torch.utils.jit import disable_jit  # noqa: E402

# (module, attribute, span name): the stages of the step
STAGES = (
    (tracker, "extract_features", "1 features"),
    (matcher, "match", "2 match (K1)"),
    (ransac, "ransac_pose", "3 ransac pose"),
    (triangulation, "triangulate_dlt", "4/8 triangulate"),
    (point_map, "add_observations", "6/7 observe"),
    (point_map, "associate", "7 associate (K2)"),
    (pnp, "refine_pose", "7b pnp"),
    (point_map, "insert_points", "8 insert"),
)


def _wrap(fn, name):
    @functools.wraps(fn)
    def inner(*a, **k):
        with torch.profiler.record_function(name):
            return fn(*a, **k)
    return inner


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default=None, help="also write the report here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_step: no CUDA device", file=sys.stderr)
        return 2
    for mod, attr, name in STAGES:
        setattr(mod, attr, _wrap(getattr(mod, attr), name))

    cfg = VSLAMConfig()
    dev = torch.device("cuda", 0)
    n = 2 * args.steps + 3
    scene = synthetic.make_scene(num_points=12000, seed=0,
                                 extent=(80, 15, 160), z_min=5.0)
    poses = synthetic.make_trajectory(n, step=1.0, seed=0)
    frames = torch.from_numpy(np.stack(synthetic.render_sequence(
        cfg.camera.K(), poses, scene, cfg.camera.width,
        cfg.camera.height))).to(dev)
    st = tracker.bootstrap(frames[0], cfg, dev)
    for i in (1, 2):
        st, _ = tracker.track_step(st, frames[i], cfg)
    torch.cuda.synchronize()

    # unprofiled wall time first (the profiler inflates host time)
    t0 = time.perf_counter()
    for i in range(3, 3 + args.steps):
        st, _ = tracker.track_step(st, frames[i], cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(3 + args.steps, n):
            st, _ = tracker.track_step(st, frames[i], cfg)
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0

    events = prof.key_averages()
    # kernels only: user-annotation spans also get a device-side entry
    dev_us = sum(e.self_device_time_total for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False)
                 and e.key not in {name for _, _, name in STAGES})
    n_ops = sum(e.count for e in events
                if e.device_type == torch.autograd.DeviceType.CPU
                and e.key.startswith("aten::"))
    lines = [f"device: {torch.cuda.get_device_name(0)}",
             f"{args.steps} steps: wall {1e3 * wall / args.steps:.2f} "
             f"ms/step unprofiled ({1e3 * wall_prof / args.steps:.2f} "
             f"profiled), device busy {dev_us / 1e3 / args.steps:.2f} "
             f"ms/step, idle share {1 - dev_us / 1e6 / wall:.3f} "
             f"(of the unprofiled wall), {n_ops / args.steps:.0f} aten "
             f"ops/step (nested calls included)",
             "stage spans (host ms/step, calls/step):"]
    for _, _, name in STAGES:
        # a span has a host entry and a device-side entry; take the host one
        host = [e for e in events if e.key == name and e.cpu_time_total > 0]
        if host:
            ms = host[0].cpu_time_total / 1e3 / args.steps
            lines.append(f"  {name:20s} {ms:9.2f} ms  "
                         f"{host[0].count / args.steps:5.1f}")
    lines.append(events.table(sort_by="cpu_time_total", row_limit=30))
    lines.append(events.table(sort_by="self_device_time_total",
                              row_limit=15))
    report = "\n".join(lines)
    print(report)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(report)
    return 0


if __name__ == "__main__":
    with disable_jit():
        sys.exit(main())
