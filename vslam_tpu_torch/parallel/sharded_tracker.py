"""Sharded-map tracking: the whole track step with the map split over the
mesh.

Port of ``vslam_tpu/parallel/sharded_tracker.py`` (BASELINE config 4 as an
operating mode). Every rank runs ``tracker._step_impl`` on replicated
state, with ``state.map`` its own block of the map and ``MapOps`` bound to
that block:

  * associate: K2 on the shard, then the cross-shard (distance, global id)
    arg-best (``sharded_map.associate_sharded``, bit-exact);
  * insert / observe / update_xyz: the global cursor and ids are
    replicated, and each rank applies the scatter rows that land in its
    slot range, with the single-device functions' collision rules
    (``types.last_writes``);
  * gathers from the map (scale, PnP landmarks, founding records): each
    rank contributes its owned rows and zeros elsewhere, combined by one
    ``psum`` (exact: each row has one contributor; a ``-0.0`` comes back as
    ``+0.0``);
  * cull on the shard's view; the alive count is a ``psum``.

RANSAC's hypothesis batch is sharded over the same axis
(``MeshConfig.shard_hypotheses``, default on;
``sharded_ransac.ransac_pose_hypsharded``). Off, every non-map stage runs
replicated and the map collectives are exact, so a run is bit-identical to
the single-device port at every mesh size; on, stage 2's per-slice float
sums add in another order and runs agree to tolerance. (Unlike XLA's SPMD
pass, torch does not re-tile the replicated compute per rank.)
"""
from __future__ import annotations

import torch

from ..config import VSLAMConfig
from ..core import types
from ..core.types import MapState, last_writes, scatter_drop
from ..mapping import point_map
from . import sharded_map, sharded_ransac
from .mesh import axis_index, axis_size, psum


def _local_ops(cfg: VSLAMConfig, mesh, axis: str, Cs: int, W: int, H: int):
    """``tracker.MapOps`` bound to this rank's block of the map."""
    from ..pipeline.tracker import MapOps

    GC = cfg.map.capacity
    start = axis_index(mesh, axis) * Cs

    def owned(ids):
        return (ids >= start) & (ids < start + Cs)

    def rows(a, ids):
        return a[torch.clamp(ids - start, 0, Cs - 1).long()]

    def associate(m, P2, uv, desc, free, frame):
        return sharded_map.associate_sharded(
            mesh, axis, m, P2, uv, desc, free, cfg.map, cfg.matching, W, H,
            frame_idx=frame)

    def gather_pt(m, ids):
        # one psum serves xyz, conf and the founding record
        return psum(mesh, axis, torch.where(owned(ids)[:, None],
                                            rows(m.pt, ids), 0.0))

    def gather_prov(m, ids):
        return psum(mesh, axis, rows(m.prov, ids) & owned(ids)) > 0

    def observe(m, ids, desc, valid, frame):
        mine = owned(ids)
        return point_map.add_observations(
            m, torch.where(mine, ids - start, -1), desc, valid & mine, frame)

    def insert(m, xyz, color, desc, valid, frame, provisional, first_uv,
               first_P, first_C, conf):
        # the global slot layout of point_map.insert_points; this rank
        # applies the rows that land in its range
        offs = torch.cumsum(valid.to(torch.int32), 0) - 1
        pos = torch.where(valid, m.size + offs, GC)
        dst = torch.where((pos >= start) & (pos < start + Cs), pos - start,
                          Cs).long()
        K = m.obs_slots
        dev = xyz.device
        payload = types.pack_pt_rows(xyz, conf, color, first_uv, first_C,
                                     first_P)
        return MapState(
            pt=scatter_drop(m.pt, dst, payload),
            desc=scatter_drop(m.desc, dst * K, desc),
            desc_count=scatter_drop(m.desc_count, dst, torch.ones(
                (), dtype=torch.int32, device=dev)),
            alive=scatter_drop(m.alive, dst, torch.ones(
                (), dtype=torch.bool, device=dev)),
            last_seen=scatter_drop(m.last_seen, dst, torch.as_tensor(
                frame, dtype=torch.int32, device=dev)),
            prov=scatter_drop(m.prov, dst, provisional),
            size=torch.clamp(m.size + valid.sum().to(torch.int32), max=GC))

    def update_xyz(m, ids, xyz, valid, promote, conf):
        dst = torch.where(valid & owned(ids), ids - start, Cs).long()
        pdst = torch.where(promote & owned(ids), ids - start, Cs).long()
        kept = m.pt[torch.clamp(dst, 0, Cs - 1)][:, 4:]
        new_rows = torch.cat([xyz, conf[:, None], kept], dim=1)
        return m.replace(
            pt=scatter_drop(m.pt, last_writes(dst, Cs), new_rows),
            prov=scatter_drop(m.prov, pdst, torch.zeros(
                (), dtype=torch.bool, device=xyz.device)))

    def cull(m, frame):
        out = point_map.cull_stale(sharded_map.local_view(m, start), frame)
        return out.replace(size=m.size)

    def alive_count(m):
        lv = sharded_map.local_view(m, start)
        in_cursor = torch.arange(Cs, device=m.pt.device) < lv.size
        return psum(mesh, axis, (lv.alive & in_cursor).sum())

    return MapOps(observe=observe, associate=associate, gather_pt=gather_pt,
                  gather_prov=gather_prov, insert=insert,
                  update_xyz=update_xyz, cull=cull, alive_count=alive_count,
                  global_capacity=GC)


def run_sharded(state, img, cfg: VSLAMConfig, mesh, map_axis: str):
    """One tracking step with ``state.map`` this rank's block of the map
    sharded over ``map_axis``; called from ``tracker.track_step``."""
    from ..pipeline import tracker

    D = axis_size(mesh, map_axis)
    GC = cfg.map.capacity
    if GC % D or (GC // D) % cfg.map.block_size:
        raise ValueError(f"capacity {GC} over {D} ranks: each shard must "
                         f"hold a multiple of block_size "
                         f"{cfg.map.block_size}")
    Cs = GC // D
    if state.map.capacity != Cs:
        raise ValueError(f"state.map holds {state.map.capacity} slots, a "
                         f"shard {Cs}: shard it first "
                         "(sharded_map.shard_map_state)")
    W, H = cfg.camera.width, cfg.camera.height

    # the hypothesis batch splits evenly with >= POSE_TOPK per rank, else
    # RANSAC runs replicated
    nh = cfg.ransac.num_hypotheses
    pose_fn = None
    if (cfg.mesh.shard_hypotheses and nh % D == 0
            and nh // D >= sharded_ransac.POSE_TOPK):
        def pose_fn(gen, uv1, uv2, m_valid, K, **kw):
            return sharded_ransac.ransac_pose_hypsharded(
                mesh, map_axis, gen, uv1, uv2, m_valid, K, **kw)

    ops = _local_ops(cfg, mesh, map_axis, Cs, W, H)
    return tracker._step_impl(state, img, cfg, ops, pose_fn=pose_fn)
