"""SO(3)/SE(3) Lie-group operations on torch tensors.

Port of ``vslam_tpu/core/lie.py``: same functions, same Taylor branches
selected with ``torch.where`` (no data-dependent control flow), batched
over leading axes.
"""
from __future__ import annotations

import torch

from .types import device_constant

_EPS = 1e-8


def hat(w):
    """so(3) hat operator: (…,3) -> (…,3,3) skew-symmetric."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def vee(W):
    """Inverse of hat: (…,3,3) -> (…,3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _eye3(like):
    return torch.eye(3, dtype=like.dtype, device=like.device)


def so3_exp(w):
    """Rodrigues formula with small-angle Taylor branch. (…,3) -> (…,3,3)."""
    theta_sq = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta_sq + _EPS * _EPS)
    W = hat(w)
    W2 = W @ W
    small = theta_sq < 1e-8
    A = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta_sq / 24.0,
                    (1.0 - torch.cos(theta)) / (theta_sq + _EPS))
    return _eye3(w) + A[..., None, None] * W + B[..., None, None] * W2


def so3_log(R):
    """(…,3,3) -> (…,3). Safe near identity and near pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    sin_theta = torch.sin(theta)
    small = torch.abs(sin_theta) < 1e-6
    scale = torch.where(
        small,
        0.5 + theta * theta / 12.0,
        theta / (2.0 * torch.where(small, torch.ones_like(sin_theta),
                                   sin_theta)),
    )
    return scale[..., None] * vee(R - R.transpose(-1, -2))


def _so3_left_jacobian(w):
    """V such that se3_exp translation = V @ rho."""
    theta_sq = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta_sq + _EPS * _EPS)
    W = hat(w)
    W2 = W @ W
    small = theta_sq < 1e-8
    B = torch.where(small, 0.5 - theta_sq / 24.0,
                    (1.0 - torch.cos(theta)) / (theta_sq + _EPS))
    C = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0,
                    (theta - torch.sin(theta)) / (theta_sq * theta + _EPS))
    return _eye3(w) + B[..., None, None] * W + C[..., None, None] * W2


def se3_exp(xi):
    """se(3) exp: (…,6) [rho, w] -> (…,4,4) homogeneous transform."""
    rho, w = xi[..., :3], xi[..., 3:]
    R = so3_exp(w)
    V = _so3_left_jacobian(w)
    t = torch.einsum("...ij,...j->...i", V, rho)
    return make_T(R, t)


def se3_log(T):
    """(…,4,4) -> (…,6) [rho, w]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = so3_log(R)
    V = _so3_left_jacobian(w)
    # solve_ex: no error check, so no device-to-host sync on CUDA
    rho = torch.linalg.solve_ex(V, t[..., None])[0][..., 0]
    return torch.cat([rho, w], dim=-1)


def make_T(R, t):
    """Assemble (…,4,4) from (…,3,3) and (…,3)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = device_constant((0.0, 0.0, 0.0, 1.0), R.dtype,
                             R.device).expand(batch + (4,))
    return torch.cat([top, bottom[..., None, :]], dim=-2)


def inv_T(T):
    """Inverse of a rigid transform, exploiting structure (no linear solve)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return make_T(Rt, -torch.einsum("...ij,...j->...i", Rt, t))


def orthonormalize_T(T, iters: int = 2):
    """Project the rotation block of a (…, 4, 4) transform back onto SO(3)
    by Newton iteration (R <- R (3I - R^T R) / 2), leaving translation
    untouched (see the reference docstring for why the tracked pose needs
    it every frame)."""
    R = T[..., :3, :3]
    eye = _eye3(T)
    for _ in range(iters):
        R = R @ (1.5 * eye - 0.5 * R.transpose(-1, -2) @ R)
    return with_rotation(T, R)


def with_rotation(T, R):
    """(…, 4, 4) T with its rotation block replaced by R (…, 3, 3), out of
    place by concatenation (a clone and an assignment would copy T with a
    device-to-device memcpy, a copy node in a CUDA graph)."""
    return torch.cat([torch.cat([R, T[..., :3, 3:]], dim=-1),
                      T[..., 3:, :]], dim=-2)


def with_translation(T, t):
    """(…, 4, 4) T with its translation replaced by t (…, 3), out of place
    as ``with_rotation``."""
    return torch.cat([torch.cat([T[..., :3, :3], t[..., :, None]], dim=-1),
                      T[..., 3:, :]], dim=-2)


def transform_points(T, X):
    """Apply (…,4,4) to points (…,N,3) -> (…,N,3)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return torch.einsum("...ij,...nj->...ni", R, X) + t[..., None, :]
