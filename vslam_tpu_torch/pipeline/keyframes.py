"""Keyframe store + sliding-window BA problem construction.

Port of ``vslam_tpu/pipeline/keyframes.py``:

  * ``KeyframeStore`` — a fixed ring of keyframe slots; each records its
    pose and the tracker's per-keypoint (map-point-id, pixel) observations.
  * ``build_window_problem`` — picks the newest W keyframes, compacts the
    map points they observe into a dense local index (sort + first-
    occurrence ranking) and lays observations out point-major for the
    Schur solver (``optimizer/ba.py``).
  * ``apply_window_result`` / ``apply_structure_result`` — write optimized
    poses and landmarks back.

Like the tracking step, none of this reads a value back to the host:
shapes are static, "drop" scatters go through a dump row, and the three
tie-sensitive sorts are stable (the reference's ``lax.top_k`` and
``argsort`` put the lower index first among equals).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import VSLAMConfig
from ..core import lie
from ..core.types import MapState, Replace, pick, scatter_drop
from ..optimizer.ba import BAProblem

_BIGID = torch.iinfo(torch.int32).max


@dataclasses.dataclass
class KeyframeStore(Replace):
    poses: torch.Tensor      # (R, 4, 4) T_wc
    kf_frame: torch.Tensor   # (R,) i32 — source video frame index, -1 empty
    kf_order: torch.Tensor   # (R,) i32 — monotone keyframe number, -1 empty
    obs_pid: torch.Tensor    # (R, N) i32 map point id per keypoint (-1 none)
    obs_uv: torch.Tensor     # (R, N, 2) f32
    obs_mask: torch.Tensor   # (R, N) bool
    count: torch.Tensor      # () i32 total keyframes ever inserted

    @property
    def ring_size(self) -> int:
        return self.poses.shape[0]


def empty_store(ring_size: int, n_kp: int, device) -> KeyframeStore:
    i32 = dict(dtype=torch.int32, device=device)
    return KeyframeStore(
        poses=torch.eye(4, dtype=torch.float32, device=device).repeat(
            ring_size, 1, 1),
        kf_frame=torch.full((ring_size,), -1, **i32),
        kf_order=torch.full((ring_size,), -1, **i32),
        obs_pid=torch.full((ring_size, n_kp), -1, **i32),
        obs_uv=torch.zeros((ring_size, n_kp, 2), dtype=torch.float32,
                           device=device),
        obs_mask=torch.zeros((ring_size, n_kp), dtype=torch.bool,
                             device=device),
        count=torch.zeros((), **i32),
    )


def insert_keyframe(store: KeyframeStore, pose, frame_idx, kp_uv, map_id,
                    kp_mask) -> KeyframeStore:
    """Record a tracked frame as a keyframe (ring slot = count % R)."""
    dev = store.poses.device
    slot = (store.count % store.ring_size).long().reshape(1)
    ok = kp_mask & (map_id >= 0)
    frame = torch.as_tensor(frame_idx, dtype=torch.int32, device=dev)
    put = lambda a, v: a.index_copy(0, slot, v[None].to(a.dtype))
    return store.replace(
        poses=put(store.poses, pose),
        kf_frame=put(store.kf_frame, frame),
        kf_order=put(store.kf_order, store.count),
        obs_pid=put(store.obs_pid, torch.where(ok, map_id, -1)),
        obs_uv=put(store.obs_uv, kp_uv),
        obs_mask=put(store.obs_mask, ok),
        count=store.count + 1,
    )


class WindowProblem(NamedTuple):
    problem: BAProblem
    win_slots: torch.Tensor   # (W,) ring slots, oldest -> newest
    win_valid: torch.Tensor   # (W,) bool
    sel_pid: torch.Tensor     # (P,) global map point id per local landmark
    sel_prov: torch.Tensor    # (P,) bool — landmark provisional at build time
    n_dropped_points: torch.Tensor     # () unique landmarks beyond max_points
    n_dropped_obs: torch.Tensor        # () valid obs beyond max_obs_per_point
    n_evicted_keyframes: torch.Tensor  # () keyframes lost to the ring


def build_window_problem(store: KeyframeStore, m: MapState,
                         cfg: VSLAMConfig, window: Optional[int] = None,
                         max_points: Optional[int] = None,
                         free_tail: Optional[int] = None,
                         prov_min_obs: int = 3) -> WindowProblem:
    """A BA problem over the newest ``window`` keyframes (default
    ``cfg.ba.window``; the ring size makes it global BA).

    ``free_tail`` None: the two oldest valid cameras fix the gauge, the rest
    are free. An int k: only the newest k cameras are free (at least two
    stay fixed). Landmarks stay free either way; a provisional landmark
    needs ``prov_min_obs`` observations to enter (full ones need 2). The
    reference docstring gives the measurements behind each choice.
    """
    W = min(window or cfg.ba.window, store.ring_size)
    P = max_points or cfg.ba.max_points
    Kslots = cfg.ba.max_obs_per_point
    R = store.ring_size
    N = store.obs_pid.shape[1]
    cap = m.capacity
    dev = store.poses.device
    i32 = dict(dtype=torch.int32, device=dev)

    # --- the newest W keyframes, oldest -> newest (lower slot first among
    # equal orders, as lax.top_k) ------------------------------------------
    top = torch.sort(store.kf_order, descending=True, stable=True)
    win_slots = top.indices[:W].flip(0)
    win_valid = top.values[:W].flip(0) >= 0

    T_cw = lie.inv_T(store.poses[win_slots])
    vi = torch.cumsum(win_valid, 0, dtype=torch.int32)
    n_valid = win_valid.sum()
    if free_tail is None:
        cam_fixed = win_valid & (vi <= 2)
    else:
        n_fixed = torch.maximum(n_valid - free_tail,
                                torch.clamp(n_valid, max=2))
        cam_fixed = win_valid & (vi <= n_fixed)

    # --- flat observation list over the window ----------------------------
    pid = store.obs_pid[win_slots].reshape(-1)          # (W*N,)
    uv = store.obs_uv[win_slots].reshape(-1, 2)
    msk = (store.obs_mask[win_slots].reshape(-1)
           & win_valid.repeat_interleave(N) & (pid >= 0))
    cam_of = torch.arange(W, **i32).repeat_interleave(N)
    pid_m = torch.where(msk, pid, _BIGID)

    # --- unique map points -> dense local index ----------------------------
    sorted_pid = torch.sort(pid_m).values
    new_run = torch.ones_like(msk)
    new_run[1:] = sorted_pid[1:] != sorted_pid[:-1]
    first = new_run & (sorted_pid < _BIGID)
    rank = torch.cumsum(first, 0, dtype=torch.int32) - 1
    keep = first & (rank < P)
    lut = scatter_drop(torch.full((cap,), -1, **i32),
                       torch.where(keep, sorted_pid, cap).long(),
                       torch.where(keep, rank, -1))
    sel_pid = scatter_drop(torch.full((P,), -1, **i32),
                           torch.where(keep, rank, P).long(),
                           torch.where(keep, sorted_pid, -1))
    local = torch.where(msk, lut[torch.clamp(pid, 0, cap - 1).long()], -1)

    # --- point-major obs table: rank within each local group --------------
    local_m = torch.where(local >= 0, local, _BIGID)
    s_local, perm = torch.sort(local_m, stable=True)
    grp_start = torch.ones_like(msk)
    grp_start[1:] = s_local[1:] != s_local[:-1]
    pos = torch.arange(s_local.shape[0], **i32)
    start_pos = torch.cummax(torch.where(grp_start, pos, 0), 0).values
    within = pos - start_pos
    listed = s_local < _BIGID
    valid_o = listed & (within < Kslots)
    n_dropped_obs = (listed & (within >= Kslots)).sum()
    n_unique = first.sum()
    n_dropped_points = torch.clamp(n_unique - P, min=0)

    # flat (row, col) -> row*K + col; dropped rows land on P*K (dump row)
    flat = torch.where(valid_o, s_local * Kslots + within, P * Kslots).long()
    obs_cam = scatter_drop(torch.zeros((P * Kslots,), **i32), flat,
                           cam_of[perm]).reshape(P, Kslots)
    obs_uv = scatter_drop(torch.zeros((P * Kslots, 2), dtype=torch.float32,
                                      device=dev), flat,
                          uv[perm]).reshape(P, Kslots, 2)
    obs_mask = scatter_drop(torch.zeros((P * Kslots,), dtype=torch.bool,
                                        device=dev), flat,
                            valid_o).reshape(P, Kslots)

    sel = torch.clamp(sel_pid, 0, cap - 1).long()
    points = m.xyz[sel]
    sel_prov = m.prov[sel] & (sel_pid >= 0)
    nobs = obs_mask.sum(dim=1)
    point_mask = (sel_pid >= 0) & (nobs >= torch.where(sel_prov, prov_min_obs,
                                                       2))
    problem = BAProblem(
        T_cw=T_cw, cam_fixed=cam_fixed | ~win_valid, cam_mask=win_valid,
        points=points, point_mask=point_mask, obs_cam=obs_cam,
        obs_uv=obs_uv, obs_mask=obs_mask)
    return WindowProblem(
        problem=problem, win_slots=win_slots.to(torch.int32),
        win_valid=win_valid, sel_pid=sel_pid, sel_prov=sel_prov,
        n_dropped_points=n_dropped_points.to(torch.int32),
        n_dropped_obs=n_dropped_obs.to(torch.int32),
        n_evicted_keyframes=torch.clamp(store.count - R, min=0),
    )


def apply_structure_result(m: MapState, wp: WindowProblem,
                           solved: BAProblem, min_span_rad: float):
    """Write back a structure-only window solve (all cameras fixed).
    Provisional landmarks solved with >= 3 surviving observations whose
    rays span ``min_span_rad`` (2 observations: double the span) are
    promoted: position and confidence written, ``prov`` cleared. Returns
    (map, number promoted)."""
    cap = m.capacity
    valid = (wp.sel_pid >= 0) & solved.point_mask & wp.sel_prov

    # ray span: the max pairwise angle among surviving observations' rays
    W = solved.T_cw.shape[0]
    centers = lie.inv_T(solved.T_cw)[:, :3, 3]                  # (W, 3)
    ccam = centers[torch.clamp(solved.obs_cam, 0, W - 1).long()]
    rays = solved.points[:, None, :] - ccam
    rays = rays / torch.clamp(torch.linalg.vector_norm(rays, dim=-1,
                                                       keepdim=True), min=1e-9)
    dots = torch.einsum("pki,pli->pkl", rays, rays)
    pair_ok = solved.obs_mask[:, :, None] & solved.obs_mask[:, None, :]
    min_dot = torch.amin(torch.where(pair_ok, dots, 1.0), dim=(1, 2))
    cos1 = float(np.cos(np.float32(min_span_rad)))
    cos2 = float(np.cos(np.float32(2.0) * np.float32(min_span_rad)))
    nobs = solved.obs_mask.sum(dim=1)
    promote = valid & (((nobs >= 3) & (min_dot < cos1))
                       | ((nobs == 2) & (min_dot < cos2)))
    # positions of promoted landmarks only; xyz|conf are adjacent packed
    # columns, so one full-row scatter writes both
    pdst = torch.where(promote, wp.sel_pid, cap).long()
    span = torch.arccos(torch.clamp(min_dot, -1.0, 1.0))
    rows = m.pt[torch.clamp(pdst, 0, cap - 1)]
    rows = torch.cat([solved.points, span[:, None], rows[:, 4:]], dim=1)
    f = torch.zeros((), dtype=torch.bool, device=m.pt.device)
    return (m.replace(pt=scatter_drop(m.pt, pdst, rows),
                      prov=scatter_drop(m.prov, pdst, f)),
            promote.sum())


def apply_window_result(store: KeyframeStore, m: MapState,
                        wp: WindowProblem, solved: BAProblem):
    """Write optimized poses/landmarks back. Returns (store, map, T_corr),
    T_corr re-anchoring poses chained off the newest keyframe:
    T_wc_corrected = T_corr @ T_wc_old_chain. Landmarks solved with >= 3
    observations are promoted (``prov`` cleared); callers apply this only
    to accepted events."""
    cap = m.capacity
    T_wc_new = lie.inv_T(solved.T_cw)                    # (W, 4, 4)
    slots = torch.where(wp.win_valid, wp.win_slots, store.ring_size).long()
    new_poses = scatter_drop(store.poses, slots, T_wc_new)

    pid = torch.where((wp.sel_pid >= 0) & solved.point_mask, wp.sel_pid,
                      cap).long()
    prows = m.pt[torch.clamp(pid, 0, cap - 1)]
    prows = torch.cat([solved.points, prows[:, 3:]], dim=1)
    new_pt = scatter_drop(m.pt, pid, prows)
    nobs = solved.obs_mask.sum(dim=1)
    ppid = torch.where(solved.point_mask & (nobs >= 3), pid, cap)
    new_prov = scatter_drop(m.prov, ppid, torch.zeros(
        (), dtype=torch.bool, device=m.pt.device))

    # correction of the newest (last valid) window camera
    ar = torch.arange(wp.win_valid.shape[0], device=store.poses.device)
    last = torch.argmax(torch.where(wp.win_valid, ar, -1))
    T_old = pick(store.poses, pick(wp.win_slots, last).long())
    T_corr = pick(T_wc_new, last) @ lie.inv_T(T_old)
    return (store.replace(poses=new_poses),
            m.replace(pt=new_pt, prov=new_prov), T_corr)
