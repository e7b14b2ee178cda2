"""Pose-only refinement from 3D->2D correspondences (GN on se(3)).

Port of ``vslam_tpu/geometry/pnp.py::refine_pose``: the tracker's map
anchoring (step 7b), Huber-robust, maturity-weighted, fixed iteration count.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import lie
from ..optimizer.ba import _jacobians, _project_residual


class PnPResult(NamedTuple):
    T_cw: torch.Tensor         # (4, 4) refined world->camera transform
    num_inliers: torch.Tensor  # () i32 points with final residual < inlier_px
    rmse: torch.Tensor         # () f32 inlier reprojection RMSE


def refine_pose(T_cw0, X_w, uv, mask, K_intr, iters: int = 8,
                huber_delta: float = 2.0, inlier_px: float = 3.0,
                weights=None) -> PnPResult:
    """Gauss-Newton pose-only refinement (see the reference docstring).
    Updates are left-multiplicative: T_cw <- exp(xi) T_cw."""
    eye6 = torch.eye(6, dtype=torch.float32, device=X_w.device)
    prior_w = torch.ones_like(mask, dtype=torch.float32) if weights is None \
        else weights.to(torch.float32)

    def residuals(T):
        r, Xc = _project_residual(T[None], X_w, uv, K_intr)
        return r, Xc, mask & (Xc[..., 2] > 0.1)

    T = T_cw0.to(torch.float32)
    for _ in range(iters):
        r, Xc, ok = residuals(T)
        nrm = torch.sqrt(torch.sum(r * r, dim=-1) + 1e-12)
        w = torch.where(nrm <= huber_delta, 1.0, huber_delta / nrm)
        w = w * prior_w * ok.to(r.dtype)
        J, _ = _jacobians(Xc, T[:3, :3].expand(Xc.shape + (3,)), K_intr)
        wJ = w[:, None, None] * J
        H = torch.einsum("nri,nrj->ij", wJ, J) + 1e-5 * eye6
        b = -torch.einsum("nri,nr->i", wJ, r)
        dx = torch.linalg.solve_ex(H, b[:, None])[0][:, 0]
        # a degenerate system (too few points) must not explode
        dx = torch.where(torch.isfinite(dx), dx, 0.0)
        T = lie.se3_exp(dx) @ T
    r, _, ok = residuals(T)
    nrm = torch.sqrt(torch.sum(r * r, dim=-1) + 1e-12)
    inl = ok & (nrm < inlier_px)
    n = inl.sum()
    rmse = torch.sqrt(torch.sum(torch.where(inl, nrm * nrm, 0.0))
                      / torch.clamp(n, min=1))
    return PnPResult(T_cw=T, num_inliers=n.to(torch.int32), rmse=rmse)
