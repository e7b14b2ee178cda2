"""The per-frame tracking step: bootstrap + track_step.

Port of ``vslam_tpu/pipeline/tracker.py`` (no mesh; both front-end
variants, ``track_carry`` and ``oriented``): extract (with the mapped-track
carry when ``track_carry``) -> match (kernel K1) -> RANSAC pose -> scale ->
pose chain -> map-id propagation -> search-by-projection association
(kernel K2) -> PnP -> delayed triangulation -> map insert -> landmark
refine. The reference's comments on each step explain the why; this file
keeps the what.

On a CUDA device the step runs without host syncs: no ``.item()``, no
``nonzero``, no boolean indexing, no Python ``if`` on a tensor — masks with
``torch.where`` replace branches on data, and "drop" scatters go through a
dump row. The one piece of state mutated in place is ``key``, the
``torch.Generator`` RANSAC draws from.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..config import VSLAMConfig
from ..core import camera as cam
from ..core import lie
from ..core.types import (FrameFeatures, MapState, PT_CONF, PT_FIRST_C,
                          PT_FIRST_P, PT_FIRST_UV, PT_XYZ, Replace,
                          device_constant, empty_features, empty_map,
                          last_writes, scatter_drop)
from ..frontend.frame import extract_features
from ..geometry import pnp, ransac, triangulation
from ..mapping import point_map
from ..matching import matcher
from ..matching.hamming import hamming_pairwise


@dataclasses.dataclass
class TrackerState(Replace):
    pose: torch.Tensor          # (4, 4) T_wc of the latest tracked frame
    prev: FrameFeatures         # features of the latest frame
    prev_map_id: torch.Tensor   # (N,) i32 map point id per previous-frame kp
    map: MapState
    frame_idx: torch.Tensor     # () i32
    scale: torch.Tensor         # () f32 running translation scale estimate
    key: torch.Generator        # RANSAC sampling stream (advances per step)
    vel: torch.Tensor           # (4, 4) last successful relative motion
    pend_uv: torch.Tensor       # (N, 2) f32 pixel at first observation
    pend_P: torch.Tensor        # (N, 3, 4) f32 projection at first obs
    pend_C: torch.Tensor        # (N, 3) f32 camera center at first obs
    pend_desc: torch.Tensor     # (N, 8) i32 descriptor at first observation
    pend_par: torch.Tensor      # (N,) f32 best parallax (rad) so far
    pend_valid: torch.Tensor    # (N,) bool keypoint carries a live track
    prev_flow: torch.Tensor     # (N, 2) f32 per-keypoint flow of last hop


class TrackOutput(NamedTuple):
    pose: torch.Tensor
    num_matches: torch.Tensor
    num_inliers: torch.Tensor
    num_cheirality: torch.Tensor
    num_associated: torch.Tensor
    num_tracked_map: torch.Tensor
    num_tracked_prov: torch.Tensor
    num_pnp_inliers: torch.Tensor
    num_refined: torch.Tensor
    num_promoted: torch.Tensor
    num_new_points: torch.Tensor
    num_dropped_inserts: torch.Tensor
    map_size: torch.Tensor
    map_alive: torch.Tensor
    scale: torch.Tensor
    scale_med: torch.Tensor
    n_scale_support: torch.Tensor
    success: torch.Tensor
    uv1: torch.Tensor
    uv2: torch.Tensor
    match_mask: torch.Tensor
    kp_uv: torch.Tensor
    kp_mask: torch.Tensor


def _K(cfg: VSLAMConfig, device):
    return device_constant(tuple(map(tuple, cfg.camera.K().tolist())),
                           torch.float32, device)


def _rad(deg: float) -> float:
    """deg2rad in f32 arithmetic (as the reference's jnp.deg2rad), as a
    host scalar: comparing an f32 tensor with it uses the f32 value."""
    return float(np.deg2rad(np.float32(deg)))


def _cos_rad(deg: float) -> float:
    return float(np.cos(np.deg2rad(np.float32(deg))))


def init_state(cfg: VSLAMConfig, device="cuda",
               seed: int = 0) -> TrackerState:
    n = cfg.frontend.max_keypoints
    f32 = dict(dtype=torch.float32, device=device)
    return TrackerState(
        pose=torch.eye(4, **f32),
        prev=empty_features(n, device),
        prev_map_id=torch.full((n,), -1, dtype=torch.int32, device=device),
        map=empty_map(cfg.map.capacity, cfg.map.obs_per_point, device),
        frame_idx=torch.zeros((), dtype=torch.int32, device=device),
        scale=torch.ones((), **f32),
        key=torch.Generator(device=device).manual_seed(seed),
        vel=torch.eye(4, **f32),
        pend_uv=torch.zeros((n, 2), **f32),
        pend_P=torch.zeros((n, 3, 4), **f32),
        pend_C=torch.zeros((n, 3), **f32),
        pend_desc=torch.zeros((n, 8), dtype=torch.int32, device=device),
        pend_par=torch.zeros((n,), **f32),
        pend_valid=torch.zeros((n,), dtype=torch.bool, device=device),
        prev_flow=torch.zeros((n, 2), **f32),
    )


def pnp_commit_ok(prev_pose, T_pnp, scale, pose_ok, num_inliers, rmse,
                  min_inliers):
    """Whether the PnP-refined pose may be COMMITTED (step 7b): trust region
    on the step, relaxed support + strict convergence when relocalizing."""
    step_pnp = torch.linalg.vector_norm((lie.inv_T(prev_pose) @ T_pnp)[:3, 3])
    pnp_sane = step_pnp <= 2.0 * torch.clamp(scale, min=1e-2)
    need = torch.where(pose_ok, min_inliers, min(min_inliers, 8))
    converged = pose_ok | (rmse < 1.5)
    return (num_inliers >= need) & pnp_sane & converged


def _masked_medians(cols, masks, fallbacks):
    """Columnwise masked medians of cols (N, k) via one sort."""
    big = torch.where(masks, cols, torch.inf)
    s = torch.sort(big, dim=0)[0]
    n = masks.sum(dim=0)
    mid = torch.clamp(torch.clamp(n - 1, min=0) // 2, 0, cols.shape[0] - 1)
    med = torch.take_along_dim(s, mid[None, :], dim=0)[0]
    return torch.where(n > 0, med, fallbacks)


def bootstrap(img, cfg: VSLAMConfig, device="cuda",
              seed: int = 0) -> TrackerState:
    """Initialize from the first frame: every keypoint opens a
    delayed-triangulation track."""
    H, W = cfg.camera.height, cfg.camera.width
    img = torch.as_tensor(img, dtype=torch.float32, device=device)
    feats = extract_features(img, cfg.frontend, H, W)
    st = init_state(cfg, device, seed)
    P0 = cam.projection_matrix(_K(cfg, device), st.pose)
    n = cfg.frontend.max_keypoints
    return st.replace(
        prev=feats, frame_idx=torch.ones((), dtype=torch.int32, device=device),
        pend_uv=feats.uv,
        pend_P=P0[None].expand(n, 3, 4).clone(),
        pend_C=st.pose[:3, 3][None].expand(n, 3).clone(),
        pend_desc=feats.desc,
        pend_par=torch.zeros((n,), dtype=torch.float32, device=device),
        pend_valid=feats.mask,
    )


class MapOps(NamedTuple):
    """Map-operation interface the tracking step is written against (the
    reference's seam: a sharded map binds other functions here)."""
    observe: object          # (m, ids, desc, valid, frame) -> m
    associate: object        # (m, P2, uv, desc, free, frame) -> result
    gather_pt: object        # (m, ids) -> (N, PT_COLS) rows (0 if invalid)
    gather_prov: object      # (m, ids) -> (N,) bool (False if invalid)
    insert: object           # (m, xyz, color, desc, valid, frame, prov,
                             #  first_uv, first_P, first_C, conf) -> m
    update_xyz: object       # (m, ids, xyz, valid, promote, conf) -> m
    cull: object             # (m, frame) -> m
    alive_count: object      # (m) -> () count
    global_capacity: int


def default_map_ops(cfg: VSLAMConfig, W: int, H: int) -> MapOps:
    def _rows(m, ids):
        return m.pt[torch.clamp(ids, 0, m.capacity - 1).long()]

    def update_xyz(m, ids, xyz, valid, promote, conf):
        C = m.capacity
        dst = torch.where(valid, ids, C).long()
        pdst = torch.where(promote, ids, C).long()
        rows = torch.cat([xyz, conf[:, None], _rows(m, dst)[:, 4:]], dim=1)
        return m.replace(
            pt=scatter_drop(m.pt, last_writes(dst, C), rows),
            prov=scatter_drop(m.prov, pdst,
                              torch.zeros((), dtype=torch.bool,
                                          device=xyz.device)))

    def gather_pt(m, ids):
        return torch.where((ids >= 0)[:, None], _rows(m, ids), 0.0)

    def gather_prov(m, ids):
        return m.prov[torch.clamp(ids, 0, m.capacity - 1).long()] & (ids >= 0)

    def alive_count(m):
        in_cursor = torch.arange(m.capacity, device=m.pt.device) < m.size
        return (m.alive & in_cursor).sum()

    return MapOps(
        observe=point_map.add_observations,
        associate=lambda m, P2, uv, desc, free, frame: point_map.associate(
            m, P2, uv, desc, free, cfg.map, cfg.matching, W, H,
            frame_idx=frame),
        gather_pt=gather_pt,
        gather_prov=gather_prov,
        insert=point_map.insert_points,
        update_xyz=update_xyz,
        cull=point_map.cull_stale,
        alive_count=alive_count,
        global_capacity=cfg.map.capacity,
    )


def track_step(state: TrackerState, img, cfg: VSLAMConfig):
    """Track one new frame. Returns (new_state, TrackOutput)."""
    H, W = cfg.camera.height, cfg.camera.width
    return _step_impl(state, img, cfg, default_map_ops(cfg, W, H))


def _step_impl(state: TrackerState, img, cfg: VSLAMConfig, ops: MapOps,
               pose_fn=None):
    """The tracking step body, parameterized over the map backend.

    ``pose_fn``: optional replacement for the relative-pose stage, with the
    signature of ``ransac.ransac_pose`` (the parity tests inject the
    reference's RANSAC samples through it).
    """
    H, W = cfg.camera.height, cfg.camera.width
    dev = state.pose.device
    f32 = dict(dtype=torch.float32, device=dev)
    K = _K(cfg, dev)
    N = cfg.frontend.max_keypoints
    GC = ops.global_capacity
    img = torch.as_tensor(img, dtype=torch.float32, device=dev)

    # 1. features; 1b. with track_carry every valid keypoint is carried at
    # its flow-extrapolated pixel, mapped ones at their landmark's
    # projection through the constant-velocity pose
    if cfg.frontend.track_carry:
        carry_uv = state.prev.uv + state.prev_flow
        T_cw_pred = lie.inv_T(state.pose @ state.vel)
        Xm_prev = ops.gather_pt(state.map, state.prev_map_id)[:, PT_XYZ]
        Xc_pred = torch.einsum("ij,nj->ni", T_cw_pred[:3, :3], Xm_prev) \
            + T_cw_pred[:3, 3]
        zp = Xc_pred[:, 2]
        uvw = Xc_pred @ K.T
        uv_m = uvw[:, :2] / torch.where(torch.abs(zp) < 1e-6, 1e-6,
                                        zp)[:, None]
        use_m = (state.prev_map_id >= 0) & (zp > 0.1)
        carry_uv = torch.where(use_m[:, None], uv_m, carry_uv)
        carry_mask = (state.prev.mask
                      & (carry_uv[:, 0] >= 0) & (carry_uv[:, 0] < W)
                      & (carry_uv[:, 1] >= 0) & (carry_uv[:, 1] < H))
        feats = extract_features(img, cfg.frontend, H, W, carry_uv,
                                 carry_mask)
    else:
        feats = extract_features(img, cfg.frontend, H, W)

    # 2. frame-to-frame matching, guided by keypoint pixels
    mres = matcher.match(state.prev.desc, state.prev.mask, feats.desc,
                         feats.mask, cfg.matching, uv1=state.prev.uv,
                         uv2=feats.uv)
    idx2 = mres.idx2.long()
    uv1 = state.prev.uv
    uv2 = feats.uv[idx2]
    m_valid = mres.mask

    # 3. robust F -> E -> (R, t)
    rres = (pose_fn or ransac.ransac_pose)(
        state.key, uv1, uv2, m_valid, K,
        num_hypotheses=cfg.ransac.num_hypotheses,
        inlier_threshold=cfg.ransac.inlier_threshold,
        min_inliers=cfg.ransac.min_inliers,
    )
    R, t_unit, votes = rres.R, rres.t, rres.votes
    pose_ok = rres.success

    # 4. monocular scale from re-observed map points
    P1_rel = torch.cat([K, torch.zeros((3, 1), **f32)], dim=1)
    P2_rel = K @ torch.cat([R, t_unit[:, None]], dim=1)
    X_rel, _ = triangulation.triangulate_dlt(P1_rel, P2_rel, uv1, uv2)
    z_rel = X_rel[:, 2]
    pid_prev = state.prev_map_id
    has_map = ((pid_prev >= 0) & rres.inliers
               & ~ops.gather_prov(state.map, pid_prev))
    Xm = ops.gather_pt(state.map, pid_prev)[:, PT_XYZ]
    T_cw_prev = lie.inv_T(state.pose)
    Xm_c = torch.einsum("ij,nj->ni", T_cw_prev[:3, :3], Xm) + T_cw_prev[:3, 3]
    z_map = Xm_c[:, 2]
    ratio = z_map / torch.clamp(z_rel, min=1e-6)
    ratio_ok = (has_map & (z_rel > 0.05) & (z_map > 0.05)
                & torch.isfinite(ratio) & (ratio > 1e-3) & (ratio < 1e3))
    n_ratio = ratio_ok.sum()
    scale_ref = torch.linalg.vector_norm(state.vel[:3, 3])
    scale_ref = torch.where(scale_ref > 1e-6, scale_ref, state.scale)
    hop = feats.uv[idx2] - state.prev.uv
    zero = torch.zeros((), **f32)
    meds = _masked_medians(
        torch.stack([ratio, hop[:, 0], hop[:, 1]], dim=1),
        torch.stack([ratio_ok, m_valid, m_valid], dim=1),
        torch.stack([scale_ref, zero, zero]))
    med, med_fx, med_fy = meds[0], meds[1], meds[2]
    scale = torch.where(
        n_ratio >= 8,
        torch.minimum(torch.maximum(scale_ref, 0.5 * med), 2.0 * med),
        scale_ref)
    scale = torch.clamp(scale, 1e-3, 1e3)
    scale = torch.where(state.frame_idx <= 1, 1.0, scale)

    # 5. pose chain; on failure, constant-velocity extrapolation
    T_c2c1 = lie.make_T(R, scale * t_unit)
    T_c1c2 = lie.inv_T(T_c2c1)
    new_pose = torch.where(pose_ok, state.pose @ T_c1c2,
                           state.pose @ state.vel)

    # 6. map-id propagation along matches (idx2 is unique among valid rows:
    # the cross-check guarantees it, so the scatters below never collide)
    prop_src = torch.where(m_valid & (pid_prev >= 0), pid_prev, -1)
    tgt = torch.where(prop_src >= 0, idx2, N)
    map_id2 = scatter_drop(
        torch.full((N,), -1, dtype=torch.int32, device=dev), tgt, prop_src)
    pend_src = m_valid & state.pend_valid
    g = pend_src[:, None]
    ftgt = torch.where(m_valid, idx2, N)
    payload = torch.cat([
        torch.where(g, state.pend_uv, 0.0),                   # 0:2   pend_uv
        torch.where(g, state.pend_P.reshape(N, 12), 0.0),     # 2:14  pend_P
        torch.where(g, state.pend_C, 0.0),                    # 14:17 pend_C
        torch.where(g, state.pend_par[:, None], 0.0),         # 17    pend_par
        g.to(torch.float32),                                  # 18    pend_valid
        hop,                                                  # 19:21 flow
        (m_valid & rres.inliers)[:, None].to(torch.float32),  # 21    inlier
    ], dim=1)
    init = torch.cat([
        torch.zeros((N, 19), **f32),
        torch.stack([med_fx, med_fy]).expand(N, 2),
        torch.zeros((N, 1), **f32),
    ], dim=1)
    packed = scatter_drop(init, ftgt, payload)
    pend_uv = packed[:, 0:2]
    pend_P = packed[:, 2:14].reshape(N, 3, 4)
    pend_C = packed[:, 14:17]
    pend_par = packed[:, 17]
    pend_valid = packed[:, 18] > 0.5
    new_flow = packed[:, 19:21]
    inl_kp = packed[:, 21] > 0.5
    pend_desc = scatter_drop(
        torch.zeros((N, 8), dtype=torch.int32, device=dev), ftgt,
        torch.where(g, state.pend_desc, 0))

    new_map = ops.observe(state.map, map_id2, feats.desc, map_id2 >= 0,
                          state.frame_idx)

    # 7. search-by-projection association around the candidate pose
    P2 = cam.projection_matrix(K, new_pose)
    kp_free = feats.mask & (map_id2 < 0)
    assoc = ops.associate(new_map, P2, feats.uv, feats.desc, kp_free,
                          state.frame_idx)
    assoc_found = assoc.point_id >= 0

    # 7b. PnP map tracking, maturity-weighted; full authority when
    # relocalizing (pose_ok false)
    pnp_ids = torch.where(assoc_found, assoc.point_id, map_id2)
    pnp_prov = ops.gather_prov(new_map, pnp_ids)
    pnp_mask = (pnp_ids >= 0) & feats.mask & (~pnp_prov | ~pose_ok)
    rows_pnp = ops.gather_pt(new_map, pnp_ids)
    X_pnp = rows_pnp[:, PT_XYZ]
    conf0 = _rad(6.0)
    pnp_conf = rows_pnp[:, PT_CONF]
    pnp_w = pnp_conf * pnp_conf / (pnp_conf * pnp_conf + conf0 * conf0)
    pnp_w = torch.where(pose_ok, pnp_w, 1.0)
    pr = pnp.refine_pose(
        lie.inv_T(new_pose), X_pnp, feats.uv, pnp_mask, K, iters=8,
        inlier_px=cfg.triangulation.reproj_threshold_sq ** 0.5 * 1.5,
        weights=pnp_w)
    T_pnp = lie.inv_T(pr.T_cw)
    # scale factorization: PnP governs rotation and direction, the step
    # magnitude stays with the scale estimate (raw PnP when relocalizing)
    dT = lie.inv_T(state.pose) @ T_pnp
    t_mag = torch.linalg.vector_norm(dT[:3, 3])
    dT_scaled = dT.clone()
    dT_scaled[:3, 3] = dT[:3, 3] * torch.where(
        t_mag > 1e-6, scale / torch.clamp(t_mag, min=1e-6), 1.0)
    alpha = cfg.pipeline.pnp_blend
    if alpha < 1.0:
        xi_corr = lie.se3_log(lie.inv_T(new_pose) @ (state.pose @ dT_scaled))
        T_blend = new_pose @ lie.se3_exp(alpha * xi_corr)
        T_commit = torch.where(pose_ok, T_blend, T_pnp)
    else:
        T_commit = torch.where(pose_ok, state.pose @ dT_scaled, T_pnp)
    pnp_ok = pnp_commit_ok(state.pose, T_pnp, scale, pose_ok,
                           pr.num_inliers, pr.rmse, cfg.ransac.min_inliers)
    new_pose = torch.where(pnp_ok, T_commit, new_pose)
    track_ok = pose_ok | pnp_ok

    assoc_ok = assoc_found & track_ok
    map_id2 = torch.where(assoc_ok, assoc.point_id, map_id2)
    new_map = ops.observe(new_map, assoc.point_id, feats.desc, assoc_ok,
                          state.frame_idx)

    # 8. delayed triangulation against each track's first observation
    P2 = cam.projection_matrix(K, new_pose)
    C2 = new_pose[:3, 3]
    X_w, w_abs = triangulation.triangulate_dlt(pend_P, P2, pend_uv, feats.uv)
    ray1 = X_w - pend_C
    ray2 = X_w - C2[None, :]
    cos_par = torch.sum(ray1 * ray2, dim=1) / torch.clamp(
        torch.linalg.vector_norm(ray1, dim=1)
        * torch.linalg.vector_norm(ray2, dim=1), min=1e-9)
    tri = cfg.triangulation
    par_ok = cos_par < _cos_rad(tri.min_parallax_deg)
    if tri.prov_parallax_deg > 0:
        par_ok_ins = cos_par < _cos_rad(tri.prov_parallax_deg)
    else:
        par_ok_ins = par_ok
    id_dist = hamming_pairwise(pend_desc, feats.desc)
    id_ok = id_dist <= tri.track_id_hamming_max
    cand = (pend_valid & feats.mask & (map_id2 < 0) & inl_kp & track_ok
            & id_ok)
    quality = triangulation.triangulation_gate(
        pend_P, P2, pend_C, C2, X_w, pend_uv, feats.uv, w_abs,
        reproj_threshold_sq=tri.reproj_threshold_sq,
        min_depth=tri.min_depth, max_depth=tri.max_depth,
        min_parallax_cos=2.0)
    insert = cand & par_ok_ins & quality
    ins_prov = insert & ~par_ok
    restart = cand & par_ok_ins & ~quality
    xi = torch.clamp(feats.uv[:, 0].to(torch.int32), 0, W - 1).long()
    yi = torch.clamp(feats.uv[:, 1].to(torch.int32), 0, H - 1).long()
    gray = img[yi, xi]
    color = torch.stack([gray, gray, gray], dim=1)
    parallax_ins = torch.arccos(torch.clamp(cos_par, -1.0, 1.0))
    new_map = ops.insert(new_map, X_w, color, feats.desc, insert,
                         state.frame_idx, ins_prov, pend_uv, pend_P, pend_C,
                         parallax_ins)

    # 8b. one-shot widest-baseline refine and supply-adaptive promotion
    FROZEN = 1e3
    parallax = parallax_ins
    mapped_ok = (pend_valid & feats.mask & (map_id2 >= 0) & track_ok
                 & quality & id_ok)
    prov_id = ops.gather_prov(new_map, map_id2)
    n_full_anchors = pnp_mask.sum()
    promote_bar = torch.where(
        n_full_anchors < tri.anchor_target,
        _rad(tri.promote_parallax_lo_deg), _rad(tri.promote_parallax_deg))
    promote = mapped_ok & prov_id & (parallax > promote_bar)
    refine = (mapped_ok & ~prov_id & (pend_par < FROZEN)
              & (parallax > 2.0 * pend_par)
              & (parallax > 2.0 * _rad(tri.min_parallax_deg)))
    new_map = ops.update_xyz(new_map, map_id2, X_w, refine | promote,
                             promote, parallax)
    new_map = ops.cull(new_map, state.frame_idx)

    # newly inserted points: give their keypoints the new map ids
    offs = torch.cumsum(insert, 0, dtype=torch.int32) - 1
    new_ids = torch.where(insert, state.map.size + offs, -1)
    new_ids = torch.where(new_ids < GC, new_ids, -1)
    map_id2 = torch.where(insert & (new_ids >= 0), new_ids, map_id2)
    n_dropped = (insert & (state.map.size + offs >= GC)).sum()
    n_alive = ops.alive_count(new_map)

    # pending-track refresh (with the re-bind restore of provisional
    # landmarks' founding records)
    restart = restart | (pend_valid & feats.mask & ~id_ok)
    keep = pend_valid & ~restart
    start_new = feats.mask & ~keep & track_ok
    prov_now = ops.gather_prov(new_map, map_id2)
    rows_id2 = ops.gather_pt(new_map, map_id2)
    f_uv = rows_id2[:, PT_FIRST_UV]
    f_C = rows_id2[:, PT_FIRST_C]
    f_P = rows_id2[:, PT_FIRST_P].reshape(N, 3, 4)
    restore = start_new & (map_id2 >= 0) & prov_now
    pend_uv = torch.where(keep[:, None], pend_uv,
                          torch.where(restore[:, None], f_uv, feats.uv))
    pend_P = torch.where(keep[:, None, None], pend_P,
                         torch.where(restore[:, None, None], f_P,
                                     P2[None].expand(N, 3, 4)))
    pend_C = torch.where(keep[:, None], pend_C,
                         torch.where(restore[:, None], f_C,
                                     C2[None].expand(N, 3)))
    pend_desc = torch.where(keep[:, None], pend_desc, feats.desc)
    pend_par = torch.where(keep, pend_par, 0.0)
    pend_par = torch.where(insert, parallax, pend_par)
    pend_par = torch.where(promote, parallax, pend_par)
    pend_par = torch.where(refine, FROZEN, pend_par)
    pend_valid = keep | start_new

    beta = cfg.pipeline.rot_smooth
    if beta > 0:
        R_pred = (state.pose @ state.vel)[:3, :3]
        dw = lie.so3_log(R_pred.T @ new_pose[:3, :3])
        R_blend = R_pred @ lie.so3_exp((1.0 - beta) * dw)
        use_blend = pose_ok & torch.isfinite(R_blend).all()
        blended = new_pose.clone()
        blended[:3, :3] = R_blend
        new_pose = torch.where(use_blend, blended, new_pose)

    new_pose = lie.orthonormalize_T(new_pose)
    # non-finite backstop: a NaN/inf never enters the pose chain
    finite = torch.isfinite(new_pose).all()
    new_pose = torch.where(finite, new_pose, state.pose)
    track_ok = track_ok & finite

    new_vel = torch.where(track_ok, lie.inv_T(state.pose) @ new_pose,
                          state.vel)
    step_len = torch.linalg.vector_norm(new_vel[:3, 3])
    scale = torch.where(track_ok & (step_len > 1e-6),
                        torch.clamp(step_len, 1e-3, 1e3), scale)
    out = TrackOutput(
        pose=new_pose,
        num_matches=m_valid.sum(),
        num_inliers=rres.num_inliers,
        num_cheirality=votes.max(),
        num_associated=assoc_ok.sum(),
        num_tracked_map=pnp_mask.sum(),
        num_tracked_prov=((pnp_ids >= 0) & feats.mask & pnp_prov).sum(),
        num_pnp_inliers=pr.num_inliers,
        num_refined=refine.sum(),
        num_promoted=promote.sum(),
        num_new_points=insert.sum() - n_dropped,
        num_dropped_inserts=n_dropped,
        map_size=new_map.size,
        map_alive=n_alive,
        scale=scale,
        scale_med=med,
        n_scale_support=n_ratio.to(torch.int32),
        success=track_ok,
        uv1=uv1,
        uv2=uv2,
        match_mask=rres.inliers,
        kp_uv=feats.uv,
        kp_mask=feats.mask,
    )
    new_state = TrackerState(
        pose=new_pose, prev=feats, prev_map_id=map_id2, map=new_map,
        frame_idx=state.frame_idx + 1, scale=scale, key=state.key,
        vel=new_vel, pend_uv=pend_uv, pend_P=pend_P, pend_C=pend_C,
        pend_desc=pend_desc, pend_par=pend_par, pend_valid=pend_valid,
        prev_flow=new_flow)
    return new_state, out
