"""Distributed bundle adjustment: landmarks sharded across the mesh.

Port of ``vslam_tpu/parallel/sharded_ba.py``. The point-major problem is
split along its point axis: each rank eliminates its own landmarks and
contributes its camera-block Hessian to a ``psum``med reduced system
(``optimizer.ba`` with ``mesh``); every rank then solves the identical
(6C, 6C) system and back-substitutes its landmarks. Communication per LM
iteration is camera-sized, (C, C, 6, 6) + (C, 6) + the cost, whatever the
number of landmarks.
"""
from __future__ import annotations

from ..config import BAConfig
from ..optimizer import ba
from .mesh import all_gather, axis_size, shard_leading

_POINT_FIELDS = ("points", "point_mask", "obs_cam", "obs_uv", "obs_mask")


def solve_sharded(mesh, axis: str, problem: ba.BAProblem, K_intr,
                  cfg: BAConfig):
    """Distributed LM solve of a whole (replicated) ``problem`` whose point
    count divides the mesh size. Returns (new_problem, BAStats) as the
    single-device ``ba.solve`` does: the cameras replicated, the points
    gathered from every rank's block, the stats replicated."""
    D = axis_size(mesh, axis)
    P = problem.points.shape[0]
    if P % D:
        raise ValueError(f"{P} points do not split over {D} ranks")
    local = problem.replace(**{f: shard_leading(mesh, axis, getattr(
        problem, f)) for f in _POINT_FIELDS})
    out, stats = ba._solve_impl(local, K_intr, cfg, mesh, axis)
    points = all_gather(mesh, axis, out.points).reshape(P, 3)
    return problem.replace(T_cw=out.T_cw, points=points), stats
