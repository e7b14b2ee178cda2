"""Device-sharded map storage and sharded search-by-projection.

Port of ``vslam_tpu/parallel/sharded_map.py`` (BASELINE config 4: the
map's point axis partitioned across the mesh, so its capacity grows with
the mesh and the per-frame association scan splits over it). Layout:
contiguous blocks, rank ``i`` owns global slots ``[i*Cs, (i+1)*Cs)`` with
``Cs = C / D``: its ``pt``, ``desc_count``, ``alive``, ``last_seen`` and
``prov`` rows, and rows ``[i*Cs*K, (i+1)*Cs*K)`` of the point-major
descriptor archive. ``size``, the global insert cursor, is replicated.

Association parity with the single-device path: K2 resolves ties toward
the lowest slot; the cross-shard combine takes the minimum distance, then
the lowest global id among the shards that reach it, so the sharded result
equals the single-device one bit for bit.
"""
from __future__ import annotations

import torch

from ..config import MapConfig, MatchingConfig
from ..core.types import MapState
from ..mapping import point_map
from ..mapping.point_map import AssociationResult
from .mesh import all_gather, axis_index, axis_size, pmin

_ROW_FIELDS = ("pt", "desc", "desc_count", "alive", "last_seen", "prov")


def local_block(m: MapState, i: int, D: int) -> MapState:
    """Block ``i`` of ``D`` of a whole map (copies; ``size`` replicated)."""
    if m.capacity % D:
        raise ValueError(f"capacity {m.capacity} does not split over {D}")
    Cs, K = m.capacity // D, m.obs_slots
    rows = {f: getattr(m, f) for f in _ROW_FIELDS}
    rows["desc"] = rows["desc"].reshape(m.capacity, K, 8)
    out = {f: a[i * Cs:(i + 1) * Cs].clone() for f, a in rows.items()}
    out["desc"] = out["desc"].reshape(Cs * K, 8)
    return MapState(size=m.size.clone(), **out)


def shard_map_state(mesh, axis: str, m: MapState) -> MapState:
    """This rank's block of the whole map ``m``."""
    return local_block(m, axis_index(mesh, axis), axis_size(mesh, axis))


def gather_map_state(mesh, axis: str, local: MapState) -> MapState:
    """The whole map from every rank's block: one ``all_gather`` a field,
    the inverse of ``shard_map_state``."""
    out = {}
    for f in _ROW_FIELDS:
        g = all_gather(mesh, axis, getattr(local, f))
        out[f] = g.reshape((-1,) + tuple(g.shape[2:]))
    return MapState(size=local.size, **out)


def local_view(m: MapState, start: int) -> MapState:
    """The shard's view for the single-device map functions: its cursor is
    how far the global cursor reaches into the shard (a device tensor; the
    host never reads it)."""
    return m.replace(size=torch.clamp(m.size - start, 0, m.capacity))


def associate_sharded(mesh, axis: str, m: MapState, P_mat, kp_uv, kp_desc,
                      kp_free, map_cfg: MapConfig, match_cfg: MatchingConfig,
                      width: int, height: int,
                      frame_idx=None) -> AssociationResult:
    """Search-by-projection with this rank's block ``m`` of the map: K2 on
    the shard, then the (distance, global id) winners combine with two
    ``pmin`` (distance, then the lowest global id among the minima).
    Keypoint inputs and the outputs are replicated."""
    Cs = m.capacity
    GC = Cs * axis_size(mesh, axis)
    if Cs % map_cfg.block_size:
        raise ValueError(f"shard capacity {Cs} is not a multiple of the "
                         f"block size {map_cfg.block_size}")
    start = axis_index(mesh, axis) * Cs
    res = point_map.associate(local_view(m, start), P_mat, kp_uv, kp_desc,
                              kp_free, map_cfg, match_cfg, width, height,
                              frame_idx=frame_idx)
    gid = torch.where(res.point_id >= 0, start + res.point_id, GC)
    gmin = pmin(mesh, axis, res.distance)
    cand = torch.where((res.distance == gmin) & (gid < GC), gid, GC)
    gbest = pmin(mesh, axis, cand)
    return AssociationResult(
        point_id=torch.where(gbest < GC, gbest, -1).to(torch.int32),
        distance=gmin)
