"""Two-view epipolar geometry on torch tensors.

Port of ``vslam_tpu/geometry/epipolar.py``. Where the reference ``vmap``s
a function over a hypothesis or start axis, the port writes the batch axis
out (leading ``...`` dims). Linear solves use ``solve_ex``/``inv_ex`` and
3x3 determinants are written out, so nothing on the tracking step's path
syncs with the host on CUDA (``fundamental_from_8pt(method="svd")``, off
that path, calls ``torch.linalg.svd``).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import lie
from ..core.types import device_constant, pick
from ..ops import jacobi, sampson_gn


def _det3(M):
    """Determinant of (..., 3, 3), cofactor expansion (no LU, no sync)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def _inv(K):
    return torch.linalg.inv_ex(K)[0]


def hartley_normalize(uv, mask):
    """Similarity transform sending masked points to zero-mean, mean distance
    sqrt(2). uv (..., N, 2), mask (..., N) -> (uv_norm, T (..., 3, 3))."""
    w = mask.to(uv.dtype)
    n = torch.clamp(w.sum(-1), min=1.0)
    mean = (uv * w[..., None]).sum(-2) / n[..., None]
    centered = (uv - mean[..., None, :]) * w[..., None]
    dist = torch.sqrt((centered * centered).sum(-1) + 1e-12)
    mean_dist = (dist * w).sum(-1) / n
    s = math.sqrt(2.0) / torch.clamp(mean_dist, min=1e-9)
    zero = torch.zeros_like(s)
    one = torch.ones_like(s)
    T = torch.stack([
        torch.stack([s, zero, -s * mean[..., 0]], dim=-1),
        torch.stack([zero, s, -s * mean[..., 1]], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ], dim=-2)
    return (uv - mean[..., None, :]) * s[..., None, None], T


def _constraint_rows(uv1, uv2):
    """Epipolar constraint rows x2' F x1 = 0: (..., N, 2) -> (..., N, 9)."""
    u1, v1 = uv1[..., 0], uv1[..., 1]
    u2, v2 = uv2[..., 0], uv2[..., 1]
    one = torch.ones_like(u1)
    return torch.stack(
        [u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, one], dim=-1)


def fundamental_from_8pt(uv1, uv2, method: str = "jacobi", sweeps: int = 8):
    """Least-squares F from >= 8 correspondences (..., N, 2). Returns
    (..., 3, 3), ||F|| = 1, rank 2, in pixel coordinates.

    ``"jacobi"`` (the RANSAC hot path): the null vector of A^T A by the
    batched fixed-sweep Jacobi solver and a closed-form rank-2 projection.
    ``"svd"``: ``torch.linalg.svd`` of A itself (error ~ cond(A), not
    cond(A)^2) and an SVD rank-2 projection, for one accurate estimate; F's
    sign follows the SVD's and may differ from the reference's LAPACK. No
    path of the port (nor of the reference) calls it: it exists for parity
    with the reference's signature.
    """
    if method not in ("jacobi", "svd"):
        raise ValueError(f"unknown method {method!r}")
    ones = torch.ones(uv1.shape[:-1], dtype=torch.bool, device=uv1.device)
    n1, T1 = hartley_normalize(uv1, ones)
    n2, T2 = hartley_normalize(uv2, ones)
    A = _constraint_rows(n1, n2)
    if method == "jacobi":
        f = jacobi.null_vector(A, sweeps=sweeps)
        F = f.reshape(f.shape[:-1] + (3, 3))
        F = jacobi.rank2_project(F, sweeps=sweeps)
    else:
        Vt = torch.linalg.svd(A, full_matrices=True)[2]
        F = Vt[..., -1, :].reshape(A.shape[:-2] + (3, 3))
        U, D, Vt = torch.linalg.svd(F)
        D = torch.cat([D[..., :2], torch.zeros_like(D[..., 2:])], dim=-1)
        F = (U * D[..., None, :]) @ Vt
    F = T2.transpose(-1, -2) @ F @ T1
    norm = torch.linalg.vector_norm(F, dim=(-2, -1), keepdim=True) + 1e-12
    return F / norm


def sampson_error(F, uv1, uv2):
    """Squared Sampson distance in px^2: F (..., 3, 3), uv (N, 2) ->
    (..., N)."""
    ones = torch.ones_like(uv1[..., :1])
    x1 = torch.cat([uv1, ones], dim=-1)
    x2 = torch.cat([uv2, ones], dim=-1)
    Fx1 = torch.einsum("...ij,nj->...ni", F, x1)
    Ftx2 = torch.einsum("...ji,nj->...ni", F, x2)
    num = torch.einsum("ni,...ni->...n", x2, Fx1)
    num = num * num
    den = (Fx1[..., 0] * Fx1[..., 0] + Fx1[..., 1] * Fx1[..., 1]
           + Ftx2[..., 0] * Ftx2[..., 0] + Ftx2[..., 1] * Ftx2[..., 1])
    return num / torch.clamp(den, min=1e-12)


def essential_from_fundamental(F, K):
    """E = K^T F K (..., 3, 3), projected to singular values (s, s, 0) with
    s the mean of the first two (3x3 SVD by the Jacobi backend)."""
    E = K.T @ F @ K
    U, D, Vt = jacobi.svd3(E)
    s = (D[..., 0] + D[..., 1]) * 0.5
    keep = device_constant((1.0, 1.0, 0.0), E.dtype, E.device)
    return (U * (keep * s[..., None])[..., None, :]) @ Vt


def decompose_essential(E):
    """The 4 (R, t) candidates of E (..., 3, 3): Rs (..., 4, 3, 3),
    ts (..., 4, 3). Convention x2 = R x1 + t."""
    U, _, Vt = jacobi.svd3(E)
    U = U * torch.sign(_det3(U))[..., None, None]
    Vt = Vt * torch.sign(_det3(Vt))[..., None, None]
    W = device_constant(((0.0, -1.0, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0)),
                        E.dtype, E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[..., :, 2]
    t = t / (torch.linalg.vector_norm(t, dim=-1, keepdim=True) + 1e-12)
    Rs = torch.stack([R1, R1, R2, R2], dim=-3)
    ts = torch.stack([t, -t, t, -t], dim=-2)
    return Rs, ts


def triangulate_midpoint_depths(K, R, t, uv1, uv2):
    """Two-view depths (z1, z2) (..., N) for cheirality voting."""
    K_inv = _inv(K)
    ones = torch.ones_like(uv1[..., :1])
    r1 = torch.einsum("ij,nj->ni", K_inv, torch.cat([uv1, ones], -1))
    r2 = torch.einsum("ij,nj->ni", K_inv, torch.cat([uv2, ones], -1))
    Rr1 = torch.einsum("...ij,nj->...ni", R, r1)
    r2b = r2.expand(Rr1.shape)
    a = torch.sum(Rr1 * Rr1, -1)
    b = -torch.sum(Rr1 * r2b, -1)
    c = torch.sum(r2b * r2b, -1)
    tb = t[..., None, :].expand(Rr1.shape)
    d = -torch.sum(Rr1 * tb, -1)
    e = torch.sum(r2b * tb, -1)
    det = a * c - b * b
    det = torch.where(torch.abs(det) < 1e-12, 1e-12, det)
    z1 = (d * c - b * e) / det
    z2 = (a * e - b * d) / det
    return z1, z2


def refine_pose_gn(R, t, K, uv1, uv2, w, iters: int = 16,
                   huber_px: float = 1.0):
    """Robust IRLS Levenberg-Marquardt polish of a batch of starts
    R (S, 3, 3), t (S, 3) on SO(3) x S^2 (Cauchy-robust Sampson error).

    Every start runs the reference's ``refine_pose_gn`` (which the reference
    ``vmap``s over starts); the (N, 5) Jacobian is the exact derivative at
    zero in the 5 tangent parameters, as the reference's ``jax.jacfwd``.
    Each iteration's normal equations and its trial step's cost come from
    ``ops.sampson_gn`` (one kernel launch each on a card); the damped
    solve, the accept test, lambda and the retraction are here.
    Returns (R (S,3,3), t (S,3), final robust cost (S,)).
    """
    K_inv = _inv(K)
    ones = torch.ones_like(uv1[..., :1])
    x1 = torch.einsum("ij,nj->ni", K_inv, torch.cat([uv1, ones], -1))
    x2 = torch.einsum("ij,nj->ni", K_inv, torch.cat([uv2, ones], -1))
    x1, x2 = x1.contiguous(), x2.contiguous()
    f = 0.5 * (K[0, 0] + K[1, 1])
    c = huber_px / f                                  # 0-d tensor
    valid = (w > 0).to(uv1.dtype)
    R, t = R.contiguous(), t.contiguous()
    S = R.shape[0]
    eye5 = torch.eye(5, dtype=R.dtype, device=R.device)

    lam = torch.full((S,), 1e-3, dtype=R.dtype, device=R.device)
    z = torch.zeros((S, 5), dtype=R.dtype, device=R.device)
    for _ in range(iters):
        H, g, cost = sampson_gn.linearize(R, t, x1, x2, valid, c)
        dH = torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1), min=1e-12)
        Hd = H + lam[:, None, None] * torch.diag_embed(dH) + 1e-10 * eye5
        delta = -torch.linalg.solve_ex(Hd, g[..., None])[0][..., 0]
        better = sampson_gn.trial_cost(delta, R, t, x1, x2, valid, c) < cost
        delta = torch.where(better[:, None], delta, 0.0)
        lam = torch.clamp(torch.where(better, lam * 0.25, lam * 8.0),
                          1e-9, 1e6)
        R = R @ lie.so3_exp(delta[:, :3])
        t = t + (sampson_gn.t_basis(t) @ delta[:, 3:, None])[..., 0]
        t = t / (torch.linalg.vector_norm(t, dim=-1, keepdim=True) + 1e-12)
    return R, t, sampson_gn.trial_cost(z, R, t, x1, x2, valid, c)


def refine_pose_gn_multistart(R, t, K, uv1, uv2, w, iters: int = 16,
                              huber_px: float = 1.0,
                              spread_deg=(30.0, 60.0),
                              extra_starts=None):
    """Multi-start robust pose polish (see the reference docstring): the
    given (R, t), a fan of translation-direction perturbations, and
    ``extra_starts``; keep the cheirality-supported start of lowest cost."""
    B = sampson_gn.t_basis(t)
    # the fan's angles in f32 on the host, as the reference computes them
    angs = np.deg2rad(np.asarray(spread_deg, np.float32))
    cs = [(float(c), float(s)) for c, s in zip(np.cos(angs), np.sin(angs))]
    dirs = []
    for sx, sy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        d = B[:, 0] * sx + B[:, 1] * sy
        dirs += [c * t + s * d for c, s in cs]
    t0s = torch.stack([t] + dirs, dim=0)
    R0s = R.expand((t0s.shape[0], 3, 3))
    if extra_starts is not None:
        Re, te = extra_starts
        t0s = torch.cat([t0s, te], dim=0)
        R0s = torch.cat([R0s, Re], dim=0)
    t0s = t0s / (torch.linalg.vector_norm(t0s, dim=1, keepdim=True) + 1e-12)

    Rs, ts, costs = refine_pose_gn(R0s, t0s, K, uv1, uv2, w, iters=iters,
                                   huber_px=huber_px)
    costs = torch.where(torch.isnan(costs), torch.inf, costs)

    z1p, z2p = triangulate_midpoint_depths(K, Rs, ts, uv1, uv2)
    z1m, z2m = triangulate_midpoint_depths(K, Rs, -ts, uv1, uv2)
    valid = (w > 0)[None, :]
    vp = ((z1p > 0) & (z2p > 0) & valid).sum(dim=1)
    vm = ((z1m > 0) & (z2m > 0) & valid).sum(dim=1)
    ts = torch.where((vm > vp)[:, None], -ts, ts)
    votes = torch.maximum(vp, vm)
    floor = torch.clamp((0.5 * votes.max()).to(votes.dtype), min=1)
    costs = torch.where(votes >= floor, costs, torch.inf)
    best = torch.argmin(costs)
    return pick(Rs, best), pick(ts, best)


def recover_pose(E, K, uv1, uv2, mask):
    """The (R, t) candidate of E with the most correspondences in front of
    both cameras. E, K (3, 3); uv1, uv2 (N, 2); mask (N,). Returns R (3, 3),
    t (3,), votes (4,) i32 in-front counts per candidate. The candidates'
    order follows the SVD's signs (compare votes sorted)."""
    Rs, ts = decompose_essential(E)
    z1, z2 = triangulate_midpoint_depths(K, Rs, ts, uv1, uv2)
    votes = ((z1 > 0) & (z2 > 0) & mask[None, :]).sum(dim=1).to(torch.int32)
    best = torch.argmax(votes)
    return pick(Rs, best), pick(ts, best), votes
