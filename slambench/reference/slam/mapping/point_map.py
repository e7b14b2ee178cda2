"""Functional persistent world map on torch tensors.

Port of ``vslam_tpu/mapping/point_map.py``: ``insert_points``,
``add_observations``, ``cull_stale``, the maintenance trio ``evict_lru`` /
``compact`` / ``remap_ids``, and ``associate``. Scatters that the
reference writes with ``mode="drop"`` (index C = drop) go through
``types.scatter_drop`` (a dump row, no boolean filter, no host sync). Every
function returns a new MapState; inputs are not mutated.

``associate`` projects the map in plain torch (as ``associate_fused``
keeps the projection outside the Pallas kernel) and hands the rest to
kernel K2 (``ops.associate``) whatever ``MapConfig.kernel`` says: the
reference's XLA and Pallas paths agree bit for bit, and so does K2.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import MapConfig, MatchingConfig
from ..core import types
from ..core.types import MapState, last_writes, scatter_drop
from ..ops import associate as k2


def insert_points(m: MapState, xyz, color, desc, valid, frame_idx=0,
                  provisional=None, first_uv=None, first_P=None,
                  first_C=None, conf=None) -> MapState:
    """Append masked rows at the insert cursor; rows beyond capacity are
    dropped (the cursor saturates). See the reference docstring."""
    C = m.capacity
    K = m.obs_slots
    B = valid.shape[0]
    dev = xyz.device
    f32 = dict(dtype=torch.float32, device=dev)
    if provisional is None:
        provisional = torch.zeros_like(valid)
    if first_uv is None:
        first_uv = torch.zeros((B, 2), **f32)
    if first_P is None:
        first_P = torch.zeros((B, 3, 4), **f32)
    if first_C is None:
        first_C = torch.zeros((B, 3), **f32)
    if conf is None:
        conf = torch.zeros((B,), **f32)
    offs = torch.cumsum(valid.to(torch.int32), 0) - 1
    pos = torch.where(valid, m.size + offs, C)
    pos = torch.where(pos < C, pos, C).long()
    payload = types.pack_pt_rows(xyz, conf, color, first_uv, first_C, first_P)
    frame = torch.as_tensor(frame_idx, dtype=torch.int32, device=dev)
    # slot 0 of the archive holds the founding descriptor; dropped rows
    # (pos = C) land on the archive's dump row C*K
    return MapState(
        pt=scatter_drop(m.pt, pos, payload),
        desc=scatter_drop(m.desc, pos * K, desc),
        desc_count=scatter_drop(m.desc_count, pos,
                                torch.ones((), dtype=torch.int32, device=dev)),
        alive=scatter_drop(m.alive, pos,
                           torch.ones((), dtype=torch.bool, device=dev)),
        last_seen=scatter_drop(m.last_seen, pos, frame),
        prov=scatter_drop(m.prov, pos, provisional),
        size=torch.clamp(m.size + valid.sum().to(torch.int32), max=C),
    )


def add_observations(m: MapState, point_ids, desc, valid,
                     frame_idx=0) -> MapState:
    """Record a new observation descriptor for existing map points in the
    rolling archive slot ``desc_count % K``."""
    C = m.capacity
    K = m.obs_slots
    ok = valid & (point_ids >= 0)
    pid = torch.where(ok, point_ids, C).long()
    cnt = m.desc_count[torch.clamp(point_ids, 0, C - 1).long()]
    slot = torch.where(ok, cnt % K, 0)
    frame = torch.as_tensor(frame_idx, dtype=torch.int32,
                            device=point_ids.device)
    # two keypoints may observe one point: the later one's descriptor wins
    return m.replace(
        desc=scatter_drop(m.desc, last_writes(pid * K + slot, C * K), desc),
        desc_count=scatter_drop(m.desc_count, pid, ok.to(torch.int32),
                                accumulate=True),
        last_seen=scatter_drop(m.last_seen, pid, frame),
    )


def cull_stale(m: MapState, current_frame, min_obs: int = 2,
               max_age: int = 30) -> MapState:
    """Mark never-corroborated landmarks unseen for ``max_age`` frames
    dead (ids stay stable until compaction)."""
    in_cursor = torch.arange(m.capacity, device=m.pt.device) < m.size
    stale = (in_cursor & m.alive & (m.desc_count < min_obs)
             & (current_frame - m.last_seen > max_age))
    return m.replace(alive=m.alive & ~stale)


def evict_lru(m: MapState, min_free: int) -> MapState:
    """Mark the oldest-seen alive landmarks dead until at least ``min_free``
    slots would be free after compaction. Exact count, ties broken by slot
    index (a stable sort over the capacity axis)."""
    C = m.capacity
    slots = torch.arange(C, device=m.pt.device)
    alive = m.alive & (slots < m.size)
    n_evict = torch.clamp(alive.sum() - (C - min_free), min=0)
    ls = torch.where(alive, m.last_seen, torch.iinfo(torch.int32).max)
    order = torch.sort(ls, stable=True).indices               # oldest first
    evict_idx = torch.where(slots < n_evict, order, C)
    return m.replace(alive=scatter_drop(
        m.alive, evict_idx, torch.zeros((), dtype=torch.bool,
                                        device=m.pt.device)))


def compact(m: MapState):
    """Pack alive landmarks to the front, freeing dead slots. Returns
    ``(compacted_map, remap)``, ``remap`` (C,) i32 old slot -> new slot, -1
    for retired slots; every id holder goes through ``remap_ids``."""
    C = m.capacity
    K = m.obs_slots
    dev = m.pt.device
    keep = m.alive & (torch.arange(C, device=dev) < m.size)
    new_pos = torch.cumsum(keep, 0, dtype=torch.int32) - 1
    remap = torch.where(keep, new_pos, -1)
    dst = torch.where(keep, new_pos, C).long()
    # archive rows move with their point: flat row p*K+k -> new_pos*K+k;
    # a retired point's rows all go to the archive's dump row C*K
    ddst = torch.where(keep[:, None],
                       dst[:, None] * K + torch.arange(K, device=dev)[None],
                       C * K).reshape(-1)
    moved = lambda a, idx=dst: scatter_drop(torch.zeros_like(a), idx, a)
    m2 = MapState(
        pt=moved(m.pt),
        desc=moved(m.desc, ddst),
        desc_count=moved(m.desc_count),
        alive=moved(keep),
        last_seen=moved(m.last_seen),
        prov=moved(m.prov),
        size=keep.sum().to(torch.int32),
    )
    return m2, remap


def remap_ids(ids, remap):
    """Apply a ``compact`` remap to map point ids (-1 passes through;
    retired ids become -1)."""
    C = remap.shape[0]
    looked = remap[torch.clamp(ids, 0, C - 1).long()]
    return torch.where(ids >= 0, looked, -1)


class AssociationResult(NamedTuple):
    point_id: torch.Tensor   # (N,) i32 best map point per keypoint, -1 if none
    distance: torch.Tensor   # (N,) i32 Hamming distance of the association


def project_map(m: MapState, P, width: int, height: int):
    """Projected pixels (C, 2) f32 of every map point through P (3, 4) and
    its visibility (C,) bool: alive, in front (z > 0.1), inside the image."""
    xyz = m.xyz
    Xh = torch.cat([xyz, torch.ones_like(xyz[:, :1])], dim=1)
    proj = Xh @ P.T                                          # (C, 3)
    z = proj[:, 2]
    safe = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    u = proj[:, 0] / safe
    v = proj[:, 1] / safe
    vis = m.alive & (z > 0.1) & (u >= 0) & (u < width) & (v >= 0) \
        & (v < height)
    return torch.stack([u, v], dim=1), vis


def associate(m: MapState, P, kp_uv, kp_desc, kp_free, map_cfg: MapConfig,
              match_cfg: MatchingConfig, width: int, height: int,
              frame_idx=None) -> AssociationResult:
    """Search-by-projection over the whole map (see the reference
    docstring): strict tier at ``search_radius`` / ``hamming_max``, plus the
    re-acquisition tier when ``frame_idx`` is given."""
    use_reacq = frame_idx is not None and match_cfg.reacq_max_age > 0
    assert m.capacity <= (1 << k2.ID_BITS), \
        f"map capacity {m.capacity} exceeds the 2^18 packed-key bound"
    muv, vis = project_map(m, P, width, height)
    key = k2.associate_plain(
        muv, vis, m.last_seen, m.desc_count, m.desc, m.size,
        frame_idx if use_reacq else m.size,
        kp_uv.contiguous(), kp_free, kp_desc.contiguous(),
        **gates(match_cfg, use_reacq), block=map_cfg.block_size)
    pid, dist = k2.decode(key)
    return AssociationResult(point_id=pid, distance=dist)


def gates(match_cfg: MatchingConfig, reacq: bool = True) -> dict:
    """K2's scalar gates from the matching config (reacq tier optional)."""
    return dict(
        r_sq=float(match_cfg.search_radius) ** 2,
        hamming_max=int(match_cfg.hamming_max),
        reacq_r_sq=float(match_cfg.reacq_radius) ** 2,
        reacq_hamming_max=int(match_cfg.reacq_hamming_max),
        reacq_max_age=int(match_cfg.reacq_max_age) if reacq else 0)
