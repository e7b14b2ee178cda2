#!/usr/bin/env python3
"""Hold the port's drivers to each other on the card, bit for bit.

    python3 scripts/compare_drivers.py [--frames N]

On chip_smoke.py phase 8's scene (the default config, N frames, window BA
off) it runs:

  * one frame body from the same state twice eagerly, through
    ``track_step``, and through the captured graph twice, and names every
    field of the tracker state and keyframe store that differs;
  * the same body under ``torch.use_deterministic_algorithms`` (warnings
    only), listing the nondeterministic ops it warns of;
  * ``SLAMSystem.process`` twice and ``process_chunk`` (chunks of 13 and
    the rest) twice, with and without deterministic algorithms, and prints
    each pair's per-frame max |pose difference| and the frames whose
    counters differ.

Two runs of the same frames on the card must agree exactly, and the chunk
must equal ``process``. Prints the card's name and power limit; exits 1 if
any pair differs, 2 without a GPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

COUNTS = ("num_matches", "num_inliers", "num_new_points", "map_size",
          "num_pnp_inliers", "num_promoted")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=26)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from vslam_tpu_torch.config import VSLAMConfig
    from vslam_tpu_torch.pipeline import scan_driver, slam, tracker
    from vslam_tpu_torch.utils import jit

    dev = torch.device("cuda")
    cfg = VSLAMConfig()
    frames = torch.from_numpy(np.stack(cs._render(
        cfg, args.frames, cs.BENCH_SCENE, 1.0, 0)[0])).to(dev)
    differ = []

    def clone_state(st):
        g = torch.Generator(device=dev)
        g.set_state(st.key.get_state())
        return scan_driver._map(torch.clone, st).replace(key=g)

    def field_diffs(a, b, path=""):
        out = []
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if dataclasses.is_dataclass(x):
                out += field_diffs(x, y, path + f.name + ".")
            elif isinstance(x, torch.Tensor) and (x != y).any():
                out.append(f"{path}{f.name}: {int((x != y).sum())} differ")
        return out

    def report(name, diffs):
        print(f"{name}: {diffs or 'equal'}", flush=True)
        if diffs:
            differ.append(name)

    s = slam.SLAMSystem(cfg, dev, enable_ba=False)
    for f in frames[:3]:
        s.process(f)
    st0 = clone_state(s.state)
    sr0 = scan_driver._map(torch.clone, s.kf_store)
    hw, mf = s._maint_high_water, s._maint_min_free
    x = frames[3]
    body = lambda: scan_driver.frame_body(clone_state(st0), sr0, x, cfg, hw,
                                          mf)
    a, b = body(), body()
    report("one frame, eager vs eager", field_diffs(a[0], b[0])
           + field_diffs(a[1], b[1]))
    with jit.disable_jit():
        eager = tracker.track_step(clone_state(st0), x, cfg)[0]
    report("one frame, track_step vs body", field_diffs(eager, a[0]))
    g = scan_driver.frame_graph(cfg, hw, mf)
    c = g.run(clone_state(st0), sr0, x[None])
    report("one frame, graph vs eager", field_diffs(c[0], a[0])
           + field_diffs(c[1], a[1])
           + (["row"] if not torch.equal(c[2][0], a[2]) else []))
    report("one frame, graph vs graph",
           field_diffs(g.run(clone_state(st0), sr0, x[None])[0], c[0]))
    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        d = body()
        torch.cuda.synchronize()
    torch.use_deterministic_algorithms(False)
    print("nondeterministic ops warned of:",
          sorted({str(w.message)[:160] for w in caught
                  if "deterministic" in str(w.message)}) or "none")
    report("one frame, deterministic vs default", field_diffs(d[0], a[0]))

    def run(mode, det=False):
        torch.use_deterministic_algorithms(det, warn_only=True)
        s = slam.SLAMSystem(cfg, dev, enable_ba=False)
        t0 = time.perf_counter()
        if mode == "process":
            for f in frames:
                s.process(f)
        else:
            s.process_chunk(frames[:13])
            s.process_chunk(frames[13:])
        torch.cuda.synchronize()
        torch.use_deterministic_algorithms(False)
        rows = [r for r in s.metrics.records
                if r.get("kind") == "frame" and "success" in r]
        return dict(rows=rows, poses=s.poses(), s=time.perf_counter() - t0)

    def compare(name, p, q):
        err = np.abs(p["poses"] - q["poses"]).max(axis=(1, 2))
        rows = [(x["frame"], {k: (x[k], y[k]) for k in COUNTS
                              if x[k] != y[k]})
                for x, y in zip(p["rows"], q["rows"])]
        rows = [r for r in rows if r[1]]
        print(f"{name}: max |pose diff| {err.max():.3e}, per frame "
              + " ".join(f"{e:.1e}" for e in err), flush=True)
        for frame, d in rows:
            print(f"   frame {frame} {d}")
        if err.max() > 0 or rows:
            differ.append(name)

    p1, p2 = run("process"), run("process")
    compare("process vs process", p1, p2)
    c1, c2 = run("chunk"), run("chunk")
    compare("process vs chunk", p1, c1)
    compare("chunk vs chunk", c1, c2)
    d1, dc = run("process", True), run("chunk", True)
    compare("deterministic process vs default process", d1, p1)
    compare("deterministic process vs deterministic chunk", d1, dc)
    print(f"seconds: process {p1['s']:.2f}, chunk {c1['s']:.2f} (first "
          f"chunk includes the capture)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    print(f"differ: {differ}")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
