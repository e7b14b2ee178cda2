"""The comparison that decides a run's ``correct``.

The reference (``slam/``, a frozen plain-PyTorch copy of the tracking step
and the window bundle-adjustment solve) can only follow the program frame
by frame: a SLAM run is chaotic, and the program's state after hundreds of
frames cannot be recomputed in less time than the window. So:

* the start: the reference bootstraps from frame 0 and tracks frame 1 on
  its own, from the benchmark's images and the run's seed, and is held to
  what the program made of the same two frames;
* the step: before each sampled frame of the window the harness copies the
  program's tracker state (``snapshot``), and after the window the
  reference tracks that frame's image from the copy. Its pose, counts and
  map are held to the program's;
* window BA: on the first event after a seed-drawn frame that solves,
  the harness copies what the program built the window problem from (the
  keyframe ring and the map), the problem it built and what its solve
  returned. The reference builds the problem itself from the copies
  (``slam/pipeline/keyframes.py``), works out the event's gates and
  solves its own problem.

Each comparison gives gaps (``gaps``, ``ba_gaps``); ``judge`` holds the
widest of each against its limit (``limits.json``). ``precision(tf32=True)``
runs the reference with TF32 matmuls, the control that these limits must
fail; ``precision(linalg="magma")`` with MAGMA's factorizations in place
of cuSOLVER's, and ``reference_ba(f64=True)`` with the window solved in
float64: sound witnesses whose gaps show what a change of the order of
operations, or float32's own rounding, reads. Numbers without a limit
(the counters, the BA cost) are reported, not judged: the witnesses read
them as far apart as the control does.
"""
from __future__ import annotations

import dataclasses
import json
import os
from contextlib import contextmanager

import torch

from .slam.config import VSLAMConfig
from .slam.core import types as rtypes
from .slam.optimizer import ba as rba
from .slam.pipeline import keyframes as rkf
from .slam.pipeline import tracker as rtracker

HERE = os.path.dirname(os.path.abspath(__file__))

# counters of a frame that the program reports and the reference recomputes
COUNTS = ("num_matches", "num_inliers", "num_associated", "num_tracked_map",
          "num_tracked_prov", "num_pnp_inliers", "num_refined",
          "num_promoted", "num_new_points", "num_dropped_inserts",
          "map_size", "map_alive")

# the reference's classes by the name of the program's
_CLASSES = {"TrackerState": rtracker.TrackerState,
            "FrameFeatures": rtypes.FrameFeatures,
            "MapState": rtypes.MapState, "BAProblem": rba.BAProblem,
            "KeyframeStore": rkf.KeyframeStore}

# the window problem's fields as compared, the solver's problem first
PROBLEM = ("T_cw", "cam_fixed", "cam_mask", "points", "point_mask", "obs_cam",
           "obs_uv", "obs_mask")
WINDOW = ("win_slots", "win_valid", "sel_pid", "sel_prov", "n_dropped_points",
          "n_dropped_obs", "n_evicted_keyframes")


def config(vslam: dict) -> VSLAMConfig:
    """The reference's configuration from a configuration file's ``vslam``."""
    return VSLAMConfig.from_json(json.dumps(vslam))


def snapshot(obj):
    """A deep copy of a program's state as plain data: a dataclass as
    (class name, {field: copy}), a tensor cloned, a ``torch.Generator`` as
    its device and state."""
    if dataclasses.is_dataclass(obj):
        return (type(obj).__name__,
                {f.name: snapshot(getattr(obj, f.name))
                 for f in dataclasses.fields(obj)})
    if isinstance(obj, torch.Tensor):
        return obj.detach().clone()
    if isinstance(obj, torch.Generator):
        return ("Generator", obj.device, obj.get_state())
    if isinstance(obj, (tuple, list)):
        return type(obj)(snapshot(x) for x in obj)
    return obj


def build(snap):
    """The reference's object of a ``snapshot`` (fresh copies: a build can
    be run more than once)."""
    if isinstance(snap, tuple) and len(snap) == 3 and snap[0] == "Generator":
        g = torch.Generator(device=snap[1])
        g.set_state(snap[2])
        return g
    if (isinstance(snap, tuple) and len(snap) == 2 and isinstance(snap[0], str)
            and isinstance(snap[1], dict)):
        cls = _CLASSES[snap[0]]
        return cls(**{k: build(v) for k, v in snap[1].items()})
    if isinstance(snap, torch.Tensor):
        return snap.clone()
    if isinstance(snap, (tuple, list)):
        return type(snap)(build(x) for x in snap)
    return snap


@contextmanager
def precision(tf32: bool = False, linalg: str = "default"):
    """Matmuls and cuDNN in TF32 (the control) or in true float32; on a
    card, the factorizations and solves from ``linalg``'s library."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    lib = torch.backends.cuda.preferred_linalg_library() \
        if torch.cuda.is_available() else None
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    if lib is not None:
        torch.backends.cuda.preferred_linalg_library(linalg)
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
        if lib is not None:
            torch.backends.cuda.preferred_linalg_library(lib)


# the variants of the reference that ``compare`` can run besides float32;
# "f64" solves the window problem in float64 (a BA-only witness: the step
# stays float32)
VARIANTS = {"tf32": dict(tf32=True), "magma": dict(linalg="magma"),
            "f64": dict(f64=True)}
BA_ONLY = ("f64",)


def outcome(state_snap, counts: dict) -> dict:
    """A frame's outcome as compared: the pose (T_wc), the counters, and the
    map's landmark positions and founding pixels up to its insert
    cursor."""
    st = state_snap[1]
    m = st["map"][1]
    size = int(m["size"])
    return {"pose": st["pose"].double().cpu(),
            "counts": {k: int(counts[k]) for k in COUNTS},
            "xyz": m["pt"][:size, rtypes.PT_XYZ].double().cpu(),
            "first_uv": m["pt"][:size, rtypes.PT_FIRST_UV].cpu()}


def pre_map(state_snap):
    """The landmark positions of a snapshot's map, up to its cursor: the
    map a frame starts from."""
    m = state_snap[1]["map"][1]
    return m["pt"][:int(m["size"]), rtypes.PT_XYZ].double().cpu()


def reference_step(pre_snap, img, cfg: VSLAMConfig, **prec):
    """The reference's outcome of tracking ``img`` from a snapshot."""
    with precision(**prec), torch.no_grad():
        new, out = rtracker.track_step(build(pre_snap), img, cfg)
        counts = {k: int(getattr(out, k)) for k in COUNTS}
        return outcome(snapshot(new), counts)


def reference_start(img0, img1, cfg: VSLAMConfig, seed: int, device,
                    **prec):
    """The reference's own bootstrap on frame 0 and outcome of frame 1, and
    its pose before frame 1."""
    with precision(**prec), torch.no_grad():
        st = rtracker.bootstrap(img0, cfg, device, seed=seed)
        pre_pose = st.pose.double().cpu()
        new, out = rtracker.track_step(st, img1, cfg)
        counts = {k: int(getattr(out, k)) for k in COUNTS}
        return outcome(snapshot(new), counts), pre_pose


def _changed(out: dict, pre_xyz):
    """The landmarks a frame changed: {("old", row): xyz} of the rows below
    the frame's starting cursor that moved, {("new", u, v): xyz} of the rows
    it inserted, by their founding pixel (an insert that one side skips
    shifts the other inserts' rows, not their pixels)."""
    n = min(len(pre_xyz), len(out["xyz"]))
    moved = (out["xyz"][:n] != pre_xyz[:n]).any(dim=1).nonzero()[:, 0]
    rows = {("old", i): out["xyz"][i] for i in moved.tolist()}
    uv = out["first_uv"][len(pre_xyz):].tolist()
    rows.update({("new", u, v): x
                 for (u, v), x in zip(uv, out["xyz"][len(pre_xyz):])})
    return rows


def gaps(got: dict, want: dict, pre_pose, pre_xyz) -> dict:
    """How far an outcome lies from the reference's: ``pose`` the larger of
    the widest rotation-matrix entry gap and the translation gap over the
    frame's own motion; ``map`` the median, over the landmarks that either
    side changed and both hold, of the widest coordinate gap, over the
    median landmark's distance from the origin; ``count`` the widest
    counter gap (reported, not judged: a threshold that a sound change of
    the order of operations flips moves the counters as far as the TF32
    control does)."""
    dR = (got["pose"][:3, :3] - want["pose"][:3, :3]).abs().max()
    motion = torch.linalg.vector_norm(want["pose"][:3, 3] - pre_pose[:3, 3])
    dt = torch.linalg.vector_norm(got["pose"][:3, 3] - want["pose"][:3, 3])
    pose = max(float(dR), float(dt / torch.clamp(motion, min=1e-6)))
    count = max(abs(got["counts"][k] - want["counts"][k]) for k in COUNTS)
    a, b = _changed(got, pre_xyz), _changed(want, pre_xyz)
    per_row = []
    for k in set(a) | set(b):
        if k[0] == "old":
            i = k[1]
            if i < len(got["xyz"]) and i < len(want["xyz"]):
                per_row.append(float((got["xyz"][i] - want["xyz"][i])
                                     .abs().max()))
        elif k in a and k in b:
            per_row.append(float((a[k] - b[k]).abs().max()))
    b_all = want["xyz"]
    scale = float(torch.linalg.vector_norm(b_all, dim=1).median()) \
        if len(b_all) else 1.0
    dmap = float(torch.tensor(per_row).median()) / max(scale, 1e-9) \
        if per_row else 0.0
    if not all(map(lambda v: v == v, (pose, dmap))):   # NaN reads as far
        pose, dmap = float("inf"), float("inf")
    return {"step.pose_gap": pose, "step.count_gap": float(count),
            "step.map_gap": dmap}


def window_fields(wp) -> dict:
    """A window problem's compared fields as {name: tensor copy}."""
    out = {f"problem.{k}": getattr(wp.problem, k).detach().clone()
           for k in PROBLEM}
    out.update({k: getattr(wp, k).detach().clone() for k in WINDOW})
    return out


def reference_ba(rec: dict, vcfg: VSLAMConfig, device, f64=False,
                 **prec) -> dict:
    """The reference's window-BA event from a recorded one: its own build
    of the problem from the copied keyframe ring and map (``fields``), its
    gates (``solves``: whether they let the event solve) and its solve of
    its own problem (``solved``: T_cw, initial cost, final cost), with
    ``f64`` in float64."""
    cfg = rba.BAConfig(**dataclasses.asdict(rec["cfg"]))
    K = torch.as_tensor(vcfg.camera.K()).to(device)
    with precision(**prec), torch.no_grad():
        wp = rkf.build_window_problem(build(rec["store"]), build(rec["map"]),
                                      vcfg, free_tail=rec["free_tail"],
                                      prov_min_obs=rec["prov_min_obs"])
        _, solves = rkf.gate_stats(wp)
        problem = wp.problem
        if f64:
            problem = problem.replace(T_cw=problem.T_cw.double(),
                                      points=problem.points.double(),
                                      obs_uv=problem.obs_uv.double())
        solved, stats = rba.solve_robust(problem, K, cfg,
                                         reject_px=rec["reject_px"],
                                         rounds=rec["rounds"])
        return {"fields": window_fields(wp), "solves": solves,
                "solved": (solved.T_cw.double().cpu(),
                           float(stats.initial_cost),
                           float(stats.final_cost))}


def build_gap(got: dict, want: dict, solves: bool = True) -> float:
    """How far a built window problem lies from the reference's: the number
    of elements that differ over its fields but ``T_cw`` (indices, masks,
    and the positions and pixels it gathers, all exact; a field of another
    shape, or missing, differs whole), one more where the reference's gates
    would skip the event. ``T_cw``, the one field worked out by arithmetic,
    is held through the solve (``ba.pose_gap``)."""
    worst = 0.0 if solves else 1.0
    for k, b in want.items():
        if k == "problem.T_cw":
            continue
        a = got.get(k)
        if a is None or a.shape != b.shape:
            worst += float(b.numel())
        else:
            worst += float((a.cpu() != b.cpu()).sum())
    return worst


def ba_gaps(got: dict, want: dict) -> dict:
    """``build``: ``build_gap``; ``cost``: the solve's final-cost gap over
    the reference's initial cost; ``pose``: the larger of the widest
    rotation-entry gap of the solved world-to-camera transforms and their
    widest translation gap over the reference's largest translation."""
    T_a, _, fin_a = got["solved"]
    T_b, init_b, fin_b = want["solved"]
    cost = abs(fin_a - fin_b) / max(abs(init_b), 1e-12)
    if T_a.shape == T_b.shape:
        t_scale = max(float(T_b[:, :3, 3].abs().max()), 1e-9)
        pose = max(float((T_a[:, :3, :3] - T_b[:, :3, :3]).abs().max()),
                   float((T_a[:, :3, 3] - T_b[:, :3, 3]).abs().max())
                   / t_scale)
    else:
        pose = float("inf")
    if not (cost == cost and pose == pose):
        cost = pose = float("inf")
    return {"ba.build_gap": build_gap(got["fields"], want["fields"],
                                      want.get("solves", True)),
            "ba.cost_gap": cost, "ba.pose_gap": pose}


def limits() -> dict:
    """{number: limit} of ``limits.json``."""
    with open(os.path.join(HERE, "limits.json")) as f:
        return {k: float(v) for k, v in json.load(f)["limits"].items()}


def widest(readings):
    """{number: widest reading} over a list of gap dicts."""
    out = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, 0.0), v)
    return out


def judge(numbers: dict, lim: dict, required):
    """(correct, [(name, number, limit)]) over the numbers with a limit:
    every one at or under its limit, and every one that ``required`` names
    there (None where a run did not read it)."""
    rows = [(k, numbers.get(k), lim[k]) for k in sorted(lim)
            if k in numbers or k in required]
    return all(v is not None and v <= l for _, v, l in rows), rows
