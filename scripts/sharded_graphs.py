#!/usr/bin/env python3
"""The parallel modes' captured steps on N ranks, one NCCL rank a card.

    python3 scripts/sharded_graphs.py [--ranks 4] [--out FILE]
        [--log-dir DIR]

Each of ``--ranks`` spawned ranks joins one NCCL group (a FileStore in a
temporary directory) and runs, on its own card:

  * the sharded ``process`` (BASELINE config 4): ``SLAMSystem(
    VSLAMConfig(), mesh=make_mesh("map", N))`` over chip_smoke.py's phase
    8 frames (bench.py's scene, 1 m steps), replaying its step graph (the
    sharded step and its NCCL collectives), then the same frames eagerly
    (the system's ``step_graph`` dropped): frame by frame bit-equal
    (poses and infos); ms/frame by frame kind of both (host clock between
    two ``synchronize()``); the graph's capture seconds, nodes by type
    and NCCL kernels by name; K1 and K2 captured per replay;
  * with ``shard_hypotheses=False`` the captured run against a
    single-device system on the same card over the same frames (the
    sharded map's collectives are exact: bit-equal at every mesh size);
  * 3 fresh captures of the sharded step at map 51200
    (``tools.bench.capture_modes(mesh=)``, as chip_smoke.py's phase 14a
    on one rank): nodes by type and median replay device ms of each, and
    their spread, which must stay within 3% (one mode: the graph's work
    forks onto NCCL's stream and joins back, and a graph whose work
    changed streams ran ~23% slower on the H100);
  * ``multi_sequence`` (config 5) with 2 full-width sequences a rank of 4
    frames each: ``batched_track_step`` replaying its graph against the
    same steps eager, bit-equal, ms per batched step;
  * ``multihost.shutdown`` with every system and graph still referenced:
    it frees the graphs itself (NCCL's teardown waits for them) and the
    group is left; its seconds.

Every rank's poses must agree. Each rank logs its progress (and, still
running after ``STACK_AFTER_S``, every thread's stack) under ``--log-dir``.
Rank 0 prints one JSON line (also written to ``--out``) with each rank's
record and the card's name and power limit; exits 1 when a check fails, 2
without enough cards.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import pickle
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[1]
# phase 8's frames; the multi-sequence run's sequences a rank and length
N_FRAMES, SEQUENCES_PER_RANK, MS_FRAMES = 31, 2, 4
N_MODES, MODE_SPREAD = 3, 0.03
STACK_AFTER_S, TIMEOUT_S = 420.0, 600.0


def _frames(cfg, n, seed):
    import chip_smoke

    return np.stack(chip_smoke._render(cfg, n, chip_smoke.BENCH_SCENE, 1.0,
                                       seed)[0])


def _timed(torch, s, frames, say):
    """``s.process`` over ``frames``; infos without host-clock keys, the
    poses, and ms/frame by frame kind (host clock)."""
    import chip_smoke

    infos, wall = [], []
    for i, f in enumerate(frames):
        say(f"frame {i}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        infos.append(s.process(f))
        torch.cuda.synchronize()
        wall.append(1e3 * (time.perf_counter() - t0))
    kinds = chip_smoke._kinds(infos)
    ms = {k: float(np.mean([w for w, kk in zip(wall, kinds) if kk == k]))
          for k in ("ordinary", "keyframe", "ba") if k in kinds}
    return chip_smoke._strip(infos), s.poses(), ms


def _checks(torch, n, dev, say):
    """Every check of one rank (see the module docstring). Returns (the
    record, what holds the graphs)."""
    from vslam_tpu_torch.config import VSLAMConfig
    from vslam_tpu_torch.parallel import mesh as mesh_mod
    from vslam_tpu_torch.parallel import multi_sequence
    from vslam_tpu_torch.pipeline.slam import SLAMSystem
    from vslam_tpu_torch.tools import bench
    from vslam_tpu_torch.utils import jit
    from vslam_tpu_torch.utils.profiling import graph_kernels

    cfg = VSLAMConfig()
    mesh = mesh_mod.make_mesh(cfg.mesh.axis_map, n)
    frames = torch.from_numpy(_frames(cfg, N_FRAMES, 0)).to(dev)
    rec = {"capturable": mesh_mod.capturable(mesh)}

    say(f"joined, capturable {rec['capturable']}")
    s = SLAMSystem(cfg, dev, mesh=mesh)
    infos, poses, ms = _timed(torch, s, frames, say)
    say(f"captured process: {ms}")
    e = SLAMSystem(cfg, dev, mesh=mesh)
    e.step_graph = None
    e_infos, e_poses, e_ms = _timed(torch, e, frames, say)
    say(f"eager process: {e_ms}")
    g = s.step_graph
    names = graph_kernels(g.graph)
    rec.update(poses=poses, ms=ms, eager_ms=e_ms,
               same_as_eager=bool(np.array_equal(poses, e_poses)
                                  and infos == e_infos),
               capture_s=g.capture_s, nodes=g.nodes, replays=g.replays,
               captured_launches=g.captured_launches,
               nccl={k: v for k, v in names.items() if "nccl" in k.lower()})
    say(f"NCCL kernels {rec['nccl']}")

    off = cfg.replace(mesh=dataclasses.replace(cfg.mesh,
                                               shard_hypotheses=False))
    s_off = SLAMSystem(off, dev, mesh=mesh)
    _, p_off, _ = _timed(torch, s_off, frames, say)
    _, p_one, _ = _timed(torch, SLAMSystem(off, dev), frames, say)
    rec["off_same_as_single"] = bool(np.array_equal(p_off, p_one))
    say(f"shard_hypotheses off vs one device: {rec['off_same_as_single']}")

    modes = bench.capture_modes(dev, N_MODES, mesh=mesh)
    med = [r["median_ms"] for r in modes]
    rec["modes"] = dict(median_ms=med, spread=max(med) / min(med) - 1,
                        nodes=[r["nodes"] for r in modes],
                        capture_s=[r["capture_s"] for r in modes])
    say(f"fresh captures: {rec['modes']}")

    dmesh = mesh_mod.make_mesh("data", n)
    S = SEQUENCES_PER_RANK * n
    seqs = torch.from_numpy(np.stack([
        _frames(cfg, MS_FRAMES, 5 + q) for q in range(S)])).to(dev)
    boot = lambda: multi_sequence.batched_bootstrap(
        seqs[:, 0], cfg, dmesh, "data", seeds=list(range(5, 5 + S)),
        device=dev)
    runs = {}
    for name, bst in (("graph", boot()),
                      ("eager", dataclasses.replace(boot(), graph=None))):
        outs, wall = [], []
        for fi in range(1, MS_FRAMES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            # eager: no graph of the batch, and no cached graph a step
            with (jit.disable_jit() if name == "eager"
                  else contextlib.nullcontext()):
                bst, o = multi_sequence.batched_track_step(
                    bst, seqs[:, fi], cfg, dmesh, "data")
            torch.cuda.synchronize()
            wall.append(1e3 * (time.perf_counter() - t0))
            outs.append(o)
        runs[name] = (bst, outs, wall)
        say(f"multi-sequence {name}: {wall}")
    (bg, og, wg), (_, oe, we) = runs["graph"], runs["eager"]
    rec["multiseq"] = dict(
        sequences=S, ms=float(np.mean(wg[1:])),
        eager_ms=float(np.mean(we[1:])),
        same_as_eager=all(torch.equal(x, y) for a, b in zip(og, oe)
                          for x, y in zip(a, b)),
        poses=og[-1].pose.cpu().numpy(), capture_s=bg.graph.capture_s,
        nodes=bg.graph.nodes, replays=bg.graph.replays)
    return rec, (s, e, s_off, bg)


def _rank(rank, init, n, out_dir, log_dir):
    import faulthandler

    import torch

    log = open(os.path.join(log_dir, f"rank{rank}.txt"), "w")
    faulthandler.dump_traceback_later(STACK_AFTER_S, file=log)
    t_start = time.perf_counter()

    def say(msg):
        log.write(f"{time.perf_counter() - t_start:8.2f} s {msg}\n")
        log.flush()

    sys.path.insert(0, str(HERE))
    from vslam_tpu_torch.parallel import multihost

    multihost.initialize(init, world_size=n, rank=rank, local_rank=rank)
    try:
        rec, held = _checks(torch, n, torch.device("cuda", rank), say)
    finally:
        # the systems stay referenced: shutdown frees their graphs itself
        t0 = time.perf_counter()
        multihost.shutdown()
        shutdown_s = time.perf_counter() - t0
        say(f"group left in {shutdown_s:.2f} s")
    rec.update(rank=rank, shutdown_s=shutdown_s)
    del held
    faulthandler.cancel_dump_traceback_later()
    log.close()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(rec, f)


def _failures(recs):
    bad = []
    for r in recs:
        i = r["rank"]
        if not r["same_as_eager"]:
            bad.append(f"rank {i}: the captured process differs from eager")
        if not r["off_same_as_single"]:
            bad.append(f"rank {i}: shard_hypotheses off differs from one "
                       "device")
        if not r["multiseq"]["same_as_eager"]:
            bad.append(f"rank {i}: the batched graph differs from eager")
        if not np.array_equal(r["poses"], recs[0]["poses"]):
            bad.append(f"rank {i}: poses differ from rank 0's")
        if not np.array_equal(r["multiseq"]["poses"],
                              recs[0]["multiseq"]["poses"]):
            bad.append(f"rank {i}: gathered multi-sequence poses differ")
        if not r["capturable"]:
            bad.append(f"rank {i}: the NCCL mesh is not capturable")
        if r["captured_launches"] != {"hamming": 1, "associate": 1,
                                      "jacobi": 8, "sampson_gn": 21}:
            bad.append(f"rank {i}: kernels captured "
                       f"{r['captured_launches']}")
        m = r["modes"]
        if m["spread"] > MODE_SPREAD:
            bad.append(f"rank {i}: fresh captures' medians "
                       f"{m['median_ms']}, spread {m['spread']:.4f}")
        if any(x != m["nodes"][0] for x in m["nodes"]):
            bad.append(f"rank {i}: captures of one step hold other nodes")
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--out", default=None)
    ap.add_argument("--log-dir", default="out/sharded_graphs",
                    help="each rank's progress and, on a hang, stacks")
    args = ap.parse_args(argv)
    os.makedirs(args.log_dir, exist_ok=True)
    sys.path.insert(0, str(HERE))
    import torch

    from vslam_tpu_torch.parallel import multihost
    from vslam_tpu_torch.utils.profiling import nvidia_smi

    if torch.cuda.device_count() < args.ranks:
        print(f"sharded_graphs: {args.ranks} ranks need as many cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory() as d:
        codes = multihost.spawn(_rank, args.ranks,
                                (args.ranks, d, args.log_dir),
                                timeout=TIMEOUT_S)
        if any(codes):
            print(f"sharded_graphs: ranks exited with {codes}",
                  file=sys.stderr)
            return 1
        recs = []
        for r in range(args.ranks):
            with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
                recs.append(pickle.load(f))
    bad = _failures(recs)
    for r in recs:
        r["poses"] = None
        r["multiseq"]["poses"] = None
    line = dict(ranks=args.ranks, card=nvidia_smi(), records=recs,
                failures=bad)
    text = json.dumps(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    print(text)
    for b in bad:
        print("FAIL:", b, file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
