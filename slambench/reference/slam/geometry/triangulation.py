"""Batched DLT triangulation and the insertion quality gate.

Port of ``vslam_tpu/geometry/triangulation.py``: one batched 4x4 Jacobi
null-vector solve for the whole batch, degenerate rows handled by masks.
"""
from __future__ import annotations

import torch

from ..ops import jacobi


def _rows(P, uv):
    u = uv[:, 0:1]
    v = uv[:, 1:2]
    if P.dim() == 3:
        return u * P[:, 2, :] - P[:, 0, :], v * P[:, 2, :] - P[:, 1, :]
    return u * P[2][None, :] - P[0][None, :], v * P[2][None, :] - P[1][None, :]


def triangulate_dlt(P1, P2, uv1, uv2):
    """Linear (DLT) triangulation for N correspondences.

    P1, P2: (3, 4) or per-correspondence (N, 3, 4); uv1, uv2: (N, 2).
    Returns X (N, 3) world points and w_abs (N,) |homogeneous w|.
    """
    a0, a1 = _rows(P1, uv1)
    a2, a3 = _rows(P2, uv2)
    A = torch.stack([a0, a1, a2, a3], dim=1)                    # (N, 4, 4)
    A = A / (torch.linalg.vector_norm(A, dim=2, keepdim=True) + 1e-12)
    Xh = jacobi.null_vector(A, sweeps=7)
    w = Xh[:, 3]
    w_safe = torch.where(torch.abs(w) < 1e-9, 1e-9, w)
    return Xh[:, :3] / w_safe[:, None], torch.abs(w)


def reprojection_errors_sq(P, X, uv):
    """Squared pixel reprojection error of X (N, 3) through P (3, 4) or
    (N, 3, 4). Returns (err (N,), z (N,))."""
    Xh = torch.cat([X, torch.ones_like(X[:, :1])], dim=1)
    if P.dim() == 3:
        x = torch.einsum("nij,nj->ni", P, Xh)
    else:
        x = Xh @ P.T
    z = x[:, 2]
    safe = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    d = x[:, :2] / safe[:, None] - uv
    return torch.sum(d * d, dim=1), z


def triangulation_gate(P1, P2, C1_w, C2_w, X, uv1, uv2, w_abs,
                       reproj_threshold_sq: float = 4.0,
                       min_depth: float = 0.1, max_depth: float = 500.0,
                       min_parallax_cos: float = 0.999962):
    """Quality gate for newly triangulated points: reprojection in both
    views, depth range, parallax and finite homogeneous w. (N,) bool."""
    e1, z1 = reprojection_errors_sq(P1, X, uv1)
    e2, z2 = reprojection_errors_sq(P2, X, uv2)
    ray1 = X - (C1_w if C1_w.dim() == 2 else C1_w[None, :])
    ray2 = X - C2_w[None, :]
    n1 = torch.linalg.vector_norm(ray1, dim=1)
    n2 = torch.linalg.vector_norm(ray2, dim=1)
    cos_par = torch.sum(ray1 * ray2, dim=1) / torch.clamp(n1 * n2, min=1e-9)
    return ((e1 <= reproj_threshold_sq) & (e2 <= reproj_threshold_sq)
            & (z1 > min_depth) & (z1 < max_depth)
            & (z2 > min_depth) & (z2 < max_depth)
            & (cos_par < min_parallax_cos) & (w_abs > 1e-7))
