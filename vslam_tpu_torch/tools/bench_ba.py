"""BA benchmark: LM iterations/s, the Schur assembly race, one LM iteration
stage by stage, and the scaling model.

    python -m vslam_tpu_torch.tools.bench_ba [--device cuda] \
        [--out out/bench_ba.json] [--skip-kitti-scale]
    python -m vslam_tpu_torch.tools.bench_ba --parity [--ranks 1,2,4]

Counterpart of the repository's ``bench_ba.py``. It prints and writes one
JSON object with that script's keys, plus ``device`` (the device's name
and, on a card, nvidia-smi's name and power limit):

  * measured: LM iterations/s on a 20 x 8192 x 16 problem (cameras x
    landmarks x observation slots), by iteration-count differencing,
    ``(t(2n) - t(n)) / n``, each run closed by a synchronize, for both
    Schur assemblies (``optimizer.ba``: one-hot and scatter);
    ``single_chip`` is the faster one. On a card ``ba.solve`` replays a
    captured graph (``utils.jit``), as the reference times a jitted
    solve: ``path`` is ``"captured"``; ``assembly_race_eager`` races the
    same solves under ``utils.jit.disable_jit`` (``path`` ``"eager"``,
    PyTorch's dispatch of every op), beside it. Each race row also
    carries the final solve's per-iteration ``accepted`` flags and costs
    (``path_disagreement`` compares two such rows).
  * measured: one LM iteration split into four stages (GN + Schur
    assembly, the dense camera solve, landmark back-substitution, cost
    evaluation), each with ``device_ms`` (the stage captured once as a CUDA
    graph and replayed, ``utils.profiling.graph_ms``) and ``host_ms``
    (eager calls through a synchronize, ``utils.profiling.host_ms``).
    ``ms``, which the scaling model reads, is ``device_ms``; on the CPU
    device time is not measured (None) and ``ms`` is ``host_ms``.
  * modeled: strong-scaling efficiency from that split, the reference's
    formula ``T(n) = T_parallel / n + T_replicated + T_psum`` with the
    reduced system's all-reduce over a link of ``link_bytes_per_sec``
    (default 450 GB/s per direction, the H100 SXM's NVLink 4 on NVIDIA's
    data sheet; the key replaces the reference's ``ici_bytes_per_sec``).
    Every row says ``"kind": "modeled"``.
  * measured: the KITTI-00-scale problem (256 x 65536 x 8, corridor
    scene) with the peak device memory of its race (on a card the
    captured solves: the warm-up and the graphs' pools; each
    ``measure_iters_per_sec`` frees its graphs) and, under ``spread``,
    the median,
    min and max of five more races at ``base_iters=16`` (one race at 4
    swings between runs), and the threshold race (16, 32, 64
    and 128 cameras x 16384 x 8), which reports the smallest camera count
    from which scatter wins at every larger count measured
    (``crossover_cams``; None when one-hot wins at 128) beside
    ``BAConfig.onehot_max_cams``.
  * ``--parity``: ``parallel.sharded_ba.solve_sharded`` on 1, 2 and 4
    gloo ranks on the CPU (spawned through ``parallel.multihost``) against
    the single-device solve, ``max |dT_cw| < 1e-3``. It needs no card.

Exits 2 when ``--device`` names a CUDA device that is not available, and
1 when a check fails.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from ..config import BAConfig
from ..core import lie
from ..datasets import synthetic
from ..optimizer import ba
from ..utils import jit
from ..utils.profiling import (device_record, graph_ms, host_ms, synchronize,
                               use_graph_stream)
from . import device_arg

LINK_BYTES_PER_S = 450e9        # H100 SXM NVLink 4, one direction
PSUM_HOPS = 2.0                 # ring all-reduce moves ~2x payload per device
KITTI_SCALE = (256, 65536, 8)
THRESHOLD_CAMS = (16, 32, 64, 128)


def make_problem(n_cams=20, n_pts=8192, k_obs=16, noise_px=0.5, seed=0,
                 corridor=False, device="cpu"):
    """The reference's problem, from the same ``RandomState`` draws in the
    same order: landmarks in a box every camera sees, or with
    ``corridor=True`` anchored along the trajectory (KITTI-00 shape), the
    first ``k_obs`` cameras that see a landmark observe it with pixel
    noise, and the cameras (but the first) and landmarks perturbed.
    Returns (BAProblem on ``device``, K (3, 3) float32 numpy)."""
    rng = np.random.RandomState(seed)
    K = np.array([[718.856, 0, 607.19], [0, 718.856, 185.22], [0, 0, 1.0]],
                 np.float32)
    poses = synthetic.make_trajectory(n_cams, step=1.0, seed=seed)
    if corridor:
        scene = synthetic.make_corridor_scene(
            poses, num_points=n_pts, seed=seed, lateral=20.0, vertical=6.0,
            ahead=(4.0, 60.0))
    else:
        scene = synthetic.make_scene(num_points=n_pts, seed=seed,
                                     extent=(60, 15, 120), z_min=4.0)
    xyz = scene.xyz
    obs_cam = np.zeros((n_pts, k_obs), np.int32)
    obs_uv = np.zeros((n_pts, k_obs, 2), np.float32)
    obs_mask = np.zeros((n_pts, k_obs), bool)
    for c in range(n_cams):
        T_cw = np.linalg.inv(poses[c])
        Xc = xyz @ T_cw[:3, :3].T + T_cw[:3, 3]
        uv = (Xc @ K.T)
        z = uv[:, 2]
        ok = z > 0.5
        uvp = uv[:, :2] / np.maximum(z[:, None], 1e-6)
        ok &= (uvp[:, 0] >= 0) & (uvp[:, 0] < 1248) \
            & (uvp[:, 1] >= 0) & (uvp[:, 1] < 384)
        slot = obs_mask.sum(1)
        can = ok & (slot < k_obs)
        idx = np.where(can)[0]
        obs_cam[idx, slot[idx]] = c
        obs_uv[idx, slot[idx]] = uvp[idx] + rng.randn(len(idx), 2) * noise_px
        obs_mask[idx, slot[idx]] = True

    cam_fixed = np.zeros(n_cams, bool)
    cam_fixed[0] = True
    T_cw_all = np.stack([np.linalg.inv(p) for p in poses]).astype(np.float32)
    xi = rng.randn(n_cams, 6).astype(np.float32) * 0.01
    xi[0] = 0
    T0 = lie.se3_exp(torch.from_numpy(xi)).numpy() @ T_cw_all
    pts0 = xyz + rng.randn(*xyz.shape).astype(np.float32) * 0.05
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    problem = ba.BAProblem(
        T_cw=t(T0), cam_fixed=t(cam_fixed), cam_mask=t(np.ones(n_cams, bool)),
        points=t(pts0), point_mask=t(obs_mask.sum(1) >= 2),
        obs_cam=t(obs_cam), obs_uv=t(obs_uv), obs_mask=t(obs_mask))
    return problem, K


def measure_iters_per_sec(problem, K, assembly, base_iters=8):
    """Seconds per LM iteration by iteration-count differencing, and the
    BAStats of a 2n-iteration solve. Each run is perturbed (points + seed *
    1e-6) as the reference's are, after an unperturbed warm-up run of the
    same length (which, on a card, captures that length's graph). Ends by
    dropping the solve graphs it cached in ``utils.jit``, so the next
    measurement's memory starts empty; other cached graphs stay."""
    dev = problem.T_cw.device
    Kt = torch.as_tensor(K).to(dev)

    def run(iters, seed):
        cfg = BAConfig(iterations=iters, schur_assembly=assembly)
        p = problem.replace(points=problem.points + seed * 1e-6)
        _, stats = ba.solve(p, Kt, cfg)
        synchronize(dev)
        return stats

    def timed(iters, seed):
        run(iters, 0)
        t0 = time.perf_counter()
        run(iters, seed)
        return time.perf_counter() - t0

    t_n = timed(base_iters, 1)
    t_2n = timed(2 * base_iters, 2)
    per_iter = max(t_2n - t_n, 1e-9) / base_iters
    stats = run(2 * base_iters, 3)
    jit.clear_cache(lambda k: k[0] is ba._solve_impl)
    return per_iter, stats


def race_assemblies(problem, K, assemblies=("scatter", "onehot"),
                    base_iters=8):
    """Each assembly's LM rate (``measure_iters_per_sec``) and last
    solve; ``path`` says whether the solves replayed captured graphs
    (``utils.jit.active``) or ran eagerly."""
    path = "captured" if jit.active(problem.T_cw.device) else "eager"
    race = {}
    for assembly in assemblies:
        per_iter, stats = measure_iters_per_sec(problem, K, assembly,
                                                base_iters=base_iters)
        accepted = stats.accepted.cpu().tolist()
        race[assembly] = {
            "path": path,
            "sec_per_lm_iteration": round(per_iter, 6),
            "lm_iterations_per_sec": round(1.0 / per_iter, 2),
            "initial_cost": float(stats.initial_cost),
            "final_cost": float(stats.final_cost),
            "accepted_steps": int(sum(accepted)),
            "accepted": accepted,
            "costs": stats.costs.cpu().tolist(),
        }
        print(f"assembly={assembly} ({path}): {per_iter * 1e3:.2f} "
              f"ms/LM-iter ({1.0 / per_iter:.1f} it/s)", flush=True)
    return race


def path_disagreement(a, b, tie=1e-6):
    """Where two solves' LM paths part (two race rows, or two rows of one
    assembly on two devices): the first iteration whose accept flags
    differ, unless the run that accepted there gained less than ``tie`` of
    its cost, a rounding tie of a converged solve. After a tie the damping
    differs, so the flags are no longer compared; instead both runs must
    stay converged: no later iteration of either gains ``tie`` or more.
    Returns None, or a description of the disagreement."""
    def gain(x, i):
        before = x["costs"][i - 1] if i else x["initial_cost"]
        return (before - x["costs"][i]) / before

    tied = None
    for i, (fa, fb) in enumerate(zip(a["accepted"], b["accepted"])):
        if tied is not None:
            for name, x in (("first", a), ("second", b)):
                if gain(x, i) >= tie:
                    return (f"iteration {i}: the {name} run gained "
                            f"{gain(x, i):.2e} of its cost after a rounding "
                            f"tie at iteration {tied}")
        elif fa != fb:
            g = gain(a if fa else b, i)
            if g >= tie:
                return (f"iteration {i}: accepted {fa} vs {fb}, the "
                        f"accepting run gained {g:.2e} of its cost")
            tied = i
    return None


def _winner(race):
    return min(race, key=lambda a: race[a]["sec_per_lm_iteration"])


def measure_breakdown(problem, K, assembly):
    """One LM iteration in four stages, each with device ms (one captured
    CUDA graph, replayed; None on the CPU) and host ms (eager calls):
    ``parallel`` stages work on the point axis (they divide under landmark
    sharding), the ``replicated`` dense solve does not."""
    dev = problem.T_cw.device
    Kt = torch.as_tensor(K).to(dev)
    delta = BAConfig().huber_delta
    lam = torch.full((), 1e-3, dtype=torch.float32, device=dev)

    def gn_schur():
        r, w, J_c, J_p, _ = ba._gn_quantities(problem.T_cw, problem.points,
                                              problem, Kt, delta)
        return ba._schur_reduce(r, w, J_c, J_p, problem, lam,
                                assembly=assembly)

    S, b, Hpp_inv, b_p, W_blk = gn_schur()
    dx_cam = ba._solve_dense(S, b)
    stages = [
        ("gn+schur_assembly", gn_schur, "parallel"),
        ("dense_camera_solve", lambda: ba._solve_dense(S, b), "replicated"),
        ("landmark_backsub", lambda: ba._backsub(dx_cam, Hpp_inv, b_p, W_blk,
                                                 problem), "parallel"),
        ("cost_eval", lambda: ba.compute_cost(problem, Kt, delta),
         "parallel"),
    ]
    out = []
    for name, fn, kind in stages:
        host = host_ms(fn, device=dev)
        device = graph_ms(fn) if dev.type == "cuda" else None
        out.append({"stage": name, "kind": kind,
                    "ms": round(host if device is None else device, 4),
                    "device_ms": device, "host_ms": host})
        print(f"ba stage [{assembly}] {name:22s} device "
              + ("not measured" if device is None else f"{device:9.3f} ms")
              + f"   host {host:9.3f} ms  ({kind})", flush=True)
    return out


def scaling_model(breakdown, n_cams, link_bytes_per_s=LINK_BYTES_PER_S):
    """Strong-scaling efficiency from the measured stage split (the
    reference's formula): T(n) = T_parallel / n + T_replicated + T_psum
    (n > 1), the psum of the reduced (C, C, 6, 6) + (C, 6) f32 system over
    the link; efficiency = T(1) / (n T(n))."""
    t_par = sum(s["ms"] for s in breakdown if s["kind"] == "parallel") / 1e3
    t_rep = sum(s["ms"] for s in breakdown if s["kind"] == "replicated") / 1e3
    psum_bytes = (n_cams * n_cams * 36 + 6 * n_cams) * 4.0
    t_comm = PSUM_HOPS * psum_bytes / link_bytes_per_s
    t1 = t_par + t_rep
    rows = []
    for n in (1, 2, 4, 8, 16):
        t_n = t_par / n + t_rep + (t_comm if n > 1 else 0.0)
        rows.append({"devices": n,
                     "modeled_iters_per_sec": round(1.0 / t_n, 2),
                     "modeled_efficiency": round(t1 / (n * t_n), 4),
                     "kind": "modeled"})
    return {"measured_parallel_s": round(t_par, 6),
            "measured_replicated_s": round(t_rep, 6),
            "psum_bytes_per_iter": psum_bytes,
            "psum_s": t_comm,
            "link_bytes_per_sec": link_bytes_per_s, "rows": rows}


def race_spread(problem, K, repeats, base_iters):
    """``repeats`` races of both assemblies on one problem: per assembly
    the LM iterations/s of each race, their median, min and max."""
    rates = {}
    for _ in range(repeats):
        for a, r in race_assemblies(problem, K, base_iters=base_iters).items():
            rates.setdefault(a, []).append(r["lm_iterations_per_sec"])
    return {a: {"lm_iterations_per_sec": v,
                "median": float(np.median(v)), "min": min(v), "max": max(v)}
            for a, v in rates.items()}


def kitti_scale(device, base_iters=4, breakdown=True, repeats=0,
                spread_iters=16):
    """The KITTI-00-scale race (and, with ``breakdown``, the winner's stage
    split and scaling model), with the peak device memory of the race;
    with ``repeats``, ``spread`` holds ``race_spread`` over that many more
    races at ``base_iters=spread_iters``."""
    gc, gp, gk = KITTI_SCALE
    gprob, gK = make_problem(gc, gp, gk, corridor=True, seed=1,
                             device=device)
    n_live = int(gprob.point_mask.sum())
    n_obs = int((gprob.obs_mask & gprob.point_mask[:, None]).sum())
    print(f"kitti00-scale problem: {gc} cams, {n_live} live landmarks, "
          f"{n_obs} observations", flush=True)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    grace = race_assemblies(gprob, gK, base_iters=base_iters)
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    gw = _winner(grace)
    out = {"problem": {"cams": gc, "points": gp, "obs_slots": gk,
                       "live_landmarks": n_live, "observations": n_obs},
           "assembly_race": grace,
           "single_chip": dict(grace[gw], assembly=gw),
           "peak_memory_bytes": peak}
    if repeats:
        out["spread"] = dict(race_spread(gprob, gK, repeats, spread_iters),
                             repeats=repeats, base_iters=spread_iters)
    if breakdown:
        out["breakdown"] = measure_breakdown(gprob, gK, gw)
        out["scaling_model"] = scaling_model(out["breakdown"], gc)
    return out


def threshold_race(device, cams=THRESHOLD_CAMS, base_iters=4):
    rows = []
    for c in cams:
        p, pk = make_problem(c, 16384, 8, corridor=True, seed=2,
                             device=device)
        r = race_assemblies(p, pk, base_iters=base_iters)
        rows.append({
            "cams": c,
            "onehot_ms": r["onehot"]["sec_per_lm_iteration"] * 1e3,
            "scatter_ms": r["scatter"]["sec_per_lm_iteration"] * 1e3,
            "winner": _winner(r),
        })
        print(f"threshold race cams={c}: {rows[-1]}", flush=True)
    crossover = None
    for r in reversed(rows):
        if r["winner"] != "scatter":
            break
        crossover = r["cams"]
    return {"fixed_points": 16384, "obs_slots": 8, "rows": rows,
            "config_threshold_cams": BAConfig().onehot_max_cams,
            "crossover_cams": crossover}


def run(device, skip_kitti_scale=False):
    """The single-device benchmark; returns the report."""
    n_cams, n_pts, k_obs = 20, 8192, 16
    # on a card all of this run's work on one stream from the first
    # (trap w, utils.profiling.use_graph_stream)
    use_graph_stream(device)
    problem, K = make_problem(n_cams, n_pts, k_obs, device=device)
    result = {
        "problem": {"cams": n_cams, "points": n_pts, "obs_slots": k_obs},
        "backend": torch.device(device).type,
        "device": device_record(device),
    }
    race = race_assemblies(problem, K)
    result["assembly_race"] = race
    if jit.active(device):
        with jit.disable_jit():
            result["assembly_race_eager"] = race_assemblies(problem, K)
    winner = _winner(race)
    result["single_chip"] = dict(race[winner], assembly=winner)
    result["speedup_vs_scatter"] = round(
        race["scatter"]["sec_per_lm_iteration"]
        / race[winner]["sec_per_lm_iteration"], 2)
    result["breakdown"] = measure_breakdown(problem, K, winner)
    result["scaling_model"] = scaling_model(result["breakdown"], n_cams)
    if not skip_kitti_scale:
        result["kitti00_scale"] = kitti_scale(device, repeats=5)
        result["assembly_threshold_race"] = threshold_race(device)
    return result


def _parity_rank(rank, init_method, n, problem, K, cfg, path):
    """One rank of ``parity``: join the n-rank gloo group, solve the
    problem's block, rank 0 writes the result."""
    import torch.distributed as dist

    from ..parallel import multihost, sharded_ba

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    multihost.initialize(init_method, world_size=n, rank=rank,
                         local_rank=rank, device_type="cpu")
    mesh = multihost.global_mesh("shard", device_type="cpu")
    try:
        out, stats = sharded_ba.solve_sharded(mesh, "shard", problem, K, cfg)
        if rank == 0:
            torch.save({"T_cw": out.T_cw,
                        "final_cost": float(stats.final_cost)}, path)
    finally:
        dist.destroy_process_group()


def parity(problem, K, ranks=(1, 2, 4), timeout=900.0):
    """``solve_sharded`` on n gloo CPU ranks for each n in ``ranks``
    against the single-device solve (6 iterations); raises AssertionError
    unless every max |dT_cw| < 1e-3."""
    from ..parallel import multihost

    cfg = BAConfig(iterations=6)
    problem = ba.BAProblem(**{k: v.cpu() for k, v in vars(problem).items()})
    ref, ref_stats = ba.solve(problem, K, cfg)
    rows = []
    with tempfile.TemporaryDirectory() as d:
        for n in ranks:
            path = os.path.join(d, f"rank0_of_{n}.pt")
            codes = multihost.spawn(_parity_rank, n,
                                    (n, problem, K, cfg, path),
                                    timeout=timeout)
            if any(codes):
                raise RuntimeError(f"parity on {n} ranks: exit codes {codes}")
            out = torch.load(path)
            dT = float((out["T_cw"] - ref.T_cw).abs().max())
            rows.append({"devices": n, "max_Tcw_diff_vs_single": dT,
                         "final_cost": out["final_cost"]})
            print(f"parity on {n} gloo ranks: max |dT_cw| {dT:.2e}",
                  flush=True)
            if not dT < 1e-3:
                raise AssertionError(f"parity on {n} ranks: {dT}")
    return {"single_final_cost": float(ref_stats.final_cost), "parity": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda, cuda:N or cpu (default cuda)")
    ap.add_argument("--out", default="out/bench_ba.json")
    ap.add_argument("--skip-kitti-scale", action="store_true")
    ap.add_argument("--parity", action="store_true",
                    help="sharded-solver parity on gloo CPU ranks instead "
                         "of timing")
    ap.add_argument("--ranks", default="1,2,4")
    args = ap.parse_args(argv)

    if args.parity:
        problem, K = make_problem()
        result = {"problem": {"cams": 20, "points": 8192, "obs_slots": 16},
                  "backend": "cpu", "device": device_record("cpu")}
        try:
            result["cpu_mesh_parity"] = parity(
                problem, K, tuple(int(x) for x in args.ranks.split(",")))
        except AssertionError as e:
            print(f"bench_ba: {e}", file=sys.stderr)
            return 1
        path = args.out.replace(".json", "_parity.json")
    else:
        dev = device_arg("bench_ba", args.device)
        if dev is None:
            return 2
        result = run(dev, args.skip_kitti_scale)
        path = args.out
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
