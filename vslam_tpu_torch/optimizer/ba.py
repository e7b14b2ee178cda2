"""Projection residuals and closed-form Jacobians of bundle adjustment.

Only the two functions pose-only PnP needs (``geometry/pnp.py``) are
ported so far, from ``vslam_tpu/optimizer/ba.py``; the BA solver follows in
a later slice. Conventions: cameras are T_cw (world->camera), updates are
left-multiplicative se(3).
"""
from __future__ import annotations

import torch

from ..core import lie


def _project_residual(T_cw, X, uv, K_intr):
    """Per-observation residual and camera-frame point.
    T_cw (..., 4, 4); X (..., 3); uv (..., 2) -> r (..., 2), Xc (..., 3)."""
    R = T_cw[..., :3, :3]
    t = T_cw[..., :3, 3]
    Xc = torch.einsum("...ij,...j->...i", R, X) + t
    z = Xc[..., 2]
    safe = torch.where(torch.abs(z) < 1e-6, 1e-6, z)
    fx, fy = K_intr[0, 0], K_intr[1, 1]
    cx, cy = K_intr[0, 2], K_intr[1, 2]
    u = fx * Xc[..., 0] / safe + cx
    v = fy * Xc[..., 1] / safe + cy
    return torch.stack([u, v], dim=-1) - uv, Xc


def _jacobians(Xc, R, K_intr):
    """Closed-form Jacobians: J_c (..., 2, 6) wrt a left se(3) perturbation
    of T_cw and J_p (..., 2, 3) wrt the world point."""
    fx, fy = K_intr[0, 0], K_intr[1, 1]
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    zs = torch.where(torch.abs(z) < 1e-6, 1e-6, z)
    inv_z = 1.0 / zs
    inv_z2 = inv_z * inv_z
    zero = torch.zeros_like(x)
    dpi = torch.stack([
        torch.stack([fx * inv_z, zero, -fx * x * inv_z2], dim=-1),
        torch.stack([zero, fy * inv_z, -fy * y * inv_z2], dim=-1),
    ], dim=-2)
    hatX = lie.hat(Xc)
    eye = torch.eye(3, dtype=Xc.dtype, device=Xc.device).expand(hatX.shape)
    J_c = dpi @ torch.cat([eye, -hatX], dim=-1)
    J_p = dpi @ R
    return J_c, J_p
