"""The keyframe ring and the window bundle-adjustment problem built from it.

Port of ``vslam_tpu/pipeline/keyframes.py``'s ``build_window_problem``:
the newest W keyframes, the map points they observe compacted into a dense
local index (sort + first-occurrence ranking), observations laid out
point-major for the Schur solver (``optimizer/ba.py``); and the gate
statistics that decide whether a window-BA event solves. The three
tie-sensitive sorts are stable (the reference's ``lax.top_k`` and
``argsort`` put the lower index first among equals).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..config import VSLAMConfig
from ..core import lie
from ..core.types import MapState, Replace, scatter_drop
from ..optimizer.ba import BAProblem

_BIGID = torch.iinfo(torch.int32).max


@dataclasses.dataclass
class KeyframeStore(Replace):
    poses: torch.Tensor      # (R, 4, 4) T_wc
    kf_frame: torch.Tensor   # (R,) i32 source video frame index, -1 empty
    kf_order: torch.Tensor   # (R,) i32 monotone keyframe number, -1 empty
    obs_pid: torch.Tensor    # (R, N) i32 map point id per keypoint (-1 none)
    obs_uv: torch.Tensor     # (R, N, 2) f32
    obs_mask: torch.Tensor   # (R, N) bool
    count: torch.Tensor      # () i32 total keyframes ever inserted

    @property
    def ring_size(self) -> int:
        return self.poses.shape[0]


class WindowProblem(NamedTuple):
    problem: BAProblem
    win_slots: torch.Tensor   # (W,) ring slots, oldest -> newest
    win_valid: torch.Tensor   # (W,) bool
    sel_pid: torch.Tensor     # (P,) global map point id per local landmark
    sel_prov: torch.Tensor    # (P,) bool: landmark provisional at build time
    n_dropped_points: torch.Tensor     # () unique landmarks beyond max_points
    n_dropped_obs: torch.Tensor        # () valid obs beyond max_obs_per_point
    n_evicted_keyframes: torch.Tensor  # () keyframes lost to the ring


def build_window_problem(store: KeyframeStore, m: MapState,
                         cfg: VSLAMConfig, free_tail: int,
                         prov_min_obs: int) -> WindowProblem:
    """A BA problem over the newest ``cfg.ba.window`` keyframes: only the
    newest ``free_tail`` cameras are free (at least two stay fixed);
    landmarks stay free; a provisional landmark needs ``prov_min_obs``
    observations to enter (full ones need 2)."""
    W = min(cfg.ba.window, store.ring_size)
    P = cfg.ba.max_points
    Kslots = cfg.ba.max_obs_per_point
    R = store.ring_size
    N = store.obs_pid.shape[1]
    cap = m.capacity
    dev = store.poses.device
    i32 = dict(dtype=torch.int32, device=dev)

    # the newest W keyframes, oldest -> newest
    top = torch.sort(store.kf_order, descending=True, stable=True)
    win_slots = top.indices[:W].flip(0)
    win_valid = top.values[:W].flip(0) >= 0

    T_cw = lie.inv_T(store.poses[win_slots])
    vi = torch.cumsum(win_valid, 0, dtype=torch.int32)
    n_valid = win_valid.sum()
    n_fixed = torch.maximum(n_valid - free_tail, torch.clamp(n_valid, max=2))
    cam_fixed = win_valid & (vi <= n_fixed)

    # flat observation list over the window
    pid = store.obs_pid[win_slots].reshape(-1)          # (W*N,)
    uv = store.obs_uv[win_slots].reshape(-1, 2)
    msk = (store.obs_mask[win_slots].reshape(-1)
           & win_valid.repeat_interleave(N) & (pid >= 0))
    cam_of = torch.arange(W, **i32).repeat_interleave(N)
    pid_m = torch.where(msk, pid, _BIGID)

    # unique map points -> dense local index
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

    # point-major obs table: rank within each local group
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
    n_dropped_points = torch.clamp(first.sum() - P, min=0)

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


def gate_stats(wp: WindowProblem):
    """The window-BA event's gate quantities (free-camera observations,
    free cameras, deep-revisit observations, solid bridge observations) and
    whether the event solves: at least 8 free-camera observations per free
    camera, and at least 120 deep-revisit observations."""
    p = wp.problem
    fixed = p.cam_fixed
    ofix = fixed[p.obs_cam.long()]
    ofree = ~ofix
    om, pm = p.obs_mask, p.point_mask
    n_obs = int((om & ofree & pm[:, None]).sum())
    n_free = int((p.cam_mask & ~fixed).sum())
    deep = pm & ((ofix & om).sum(dim=1) >= 2) & ((ofree & om).sum(dim=1) >= 1)
    deep_obs = int((om & deep[:, None]).sum())
    bridge = ((ofix & om).any(dim=1) & (ofree & om).any(dim=1) & pm
              & ~wp.sel_prov)
    solid_obs = int((ofix & om & bridge[:, None]).sum())
    solves = n_obs >= 8 * max(n_free, 1) and deep_obs >= 120
    return (n_obs, n_free, deep_obs, solid_obs), solves
