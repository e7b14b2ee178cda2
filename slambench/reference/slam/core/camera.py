"""Pinhole camera projection on torch tensors.

Port of ``vslam_tpu/core/camera.py`` (same conventions: ``T_wc`` is the
camera-to-world pose, ``T_cw = inv(T_wc)``, ``P = K · T_cw[:3, :]``
applied to homogeneous world points).
"""
from __future__ import annotations

import torch

from . import lie


def K_matrix(fx, fy, cx, cy, dtype=torch.float32, device=None):
    return torch.tensor([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]],
                        dtype=dtype, device=device)


def projection_matrix(K, T_wc):
    """P = K [R_cw | t_cw] : (…,3,4)."""
    T_cw = lie.inv_T(T_wc)
    return torch.einsum("ij,...jk->...ik", K, T_cw[..., :3, :])


def _divide_depth(x):
    """(…,N,3) homogeneous pixels -> uv (…,N,2), z (…,N); a depth within
    1e-9 of zero divides as 1e-9."""
    z = x[..., 2]
    safe_z = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    return x[..., :2] / safe_z[..., None], z


def project(P, X_w):
    """Project world points (…,N,3) through the (…,3,4) ``P``. Returns uv
    (…,N,2) with depth-safe division and the projective depth z (…,N)."""
    Xh = torch.cat([X_w, torch.ones_like(X_w[..., :1])], dim=-1)
    return _divide_depth(torch.einsum("...ij,...nj->...ni", P, Xh))


def project_camframe(K, X_c):
    """Project camera-frame points: (…,N,3) -> uv (…,N,2), z (…,N)."""
    return _divide_depth(torch.einsum("ij,...nj->...ni", K, X_c))


def _rays(K_inv, uv):
    ones = torch.ones_like(uv[..., :1])
    return torch.einsum("ij,...nj->...ni", K_inv, torch.cat([uv, ones], -1))


def backproject(K_inv, uv, depth):
    """Pixel + depth -> camera-frame 3D point."""
    return _rays(K_inv, uv) * depth[..., None]


def in_image(uv, width, height, margin=0.0):
    """Frustum test used by map-point association."""
    return ((uv[..., 0] >= margin) & (uv[..., 0] < width - margin)
            & (uv[..., 1] >= margin) & (uv[..., 1] < height - margin))


def pixel_to_normalized(K_inv, uv):
    """Pixels -> normalized image coordinates (z=1 plane)."""
    x = _rays(K_inv, uv)
    return x[..., :2] / x[..., 2:3]
