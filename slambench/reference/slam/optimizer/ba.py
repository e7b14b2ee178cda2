"""Bundle adjustment: Levenberg-Marquardt with a Schur complement.

Port of ``vslam_tpu/optimizer/ba.py``. A problem is (C cams, P points, K
obs-slots per point) in point-major layout, so eliminating a landmark needs
only its own row. Per-observation 2x6 / 2x3 Jacobians are closed form, 3x3
landmark Hessians are inverted in closed form, and the reduced (6C, 6C)
camera system is factored densely. Conventions: cameras are T_cw
(world->camera), updates are left-multiplicative se(3): T_cw <- exp(xi)
T_cw.

The reference's ``lax.scan`` over LM iterations is a Python loop here;
accept/reject and damping stay on tensors (``torch.where``), so a solve
never reads a value back to the host.

Only the paths the benchmark's cells drive: one device and the one-hot
Schur assembly (a window of at most ``onehot_max_cams`` cameras).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..config import BAConfig
from ..core import lie
from ..core.types import Replace


@dataclasses.dataclass
class BAProblem(Replace):
    """Point-major bundle-adjustment problem (all shapes static)."""
    T_cw: torch.Tensor        # (C, 4, 4) world->camera extrinsics
    cam_fixed: torch.Tensor   # (C,) bool — gauge-fixed cameras (no update)
    cam_mask: torch.Tensor    # (C,) bool — camera slot in use
    points: torch.Tensor      # (P, 3) world landmarks
    point_mask: torch.Tensor  # (P,) bool
    obs_cam: torch.Tensor     # (P, K) i32 camera index per observation
    obs_uv: torch.Tensor      # (P, K, 2) f32 pixel measurement
    obs_mask: torch.Tensor    # (P, K) bool

    @property
    def num_cams(self) -> int:
        return self.T_cw.shape[0]


class BAStats(NamedTuple):
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    accepted: torch.Tensor      # (iters,) bool
    costs: torch.Tensor         # (iters,) f32


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


def _huber_weight(r, delta):
    """Scalar robust weight per observation (applied to both components)."""
    nrm = torch.sqrt(torch.sum(r * r, dim=-1) + 1e-12)
    return torch.where(nrm <= delta, 1.0, delta / nrm)


def _huber_cost(r, mask, delta):
    n = torch.sqrt(torch.sum(r * r, dim=-1) + 1e-12)
    c = torch.where(n <= delta, 0.5 * n * n, delta * (n - 0.5 * delta))
    return torch.sum(torch.where(mask, c, 0.0))


def _inv3x3(A):
    """Closed-form batched 3x3 inverse (adjugate / det)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    det = torch.where(torch.abs(det) < 1e-12, 1e-12, det)
    adj = torch.stack([
        torch.stack([A11, A12, A13], dim=-1),
        torch.stack([A21, A22, A23], dim=-1),
        torch.stack([A31, A32, A33], dim=-1),
    ], dim=-2)
    return adj / det[..., None, None]


def _cam_idx(problem: BAProblem):
    return torch.clamp(problem.obs_cam, 0, problem.num_cams - 1).long()


def compute_cost(problem: BAProblem, K_intr, huber_delta: float):
    T = problem.T_cw[_cam_idx(problem)]
    r, Xc = _project_residual(T, problem.points[:, None, :], problem.obs_uv,
                              K_intr)
    mask = problem.obs_mask & problem.point_mask[:, None] & (Xc[..., 2] > 1e-3)
    return _huber_cost(r, mask, huber_delta)


def _gn_quantities(T_cw, points, problem: BAProblem, K_intr, huber_delta):
    """Per-observation GN ingredients in point-major layout: r (P,K,2),
    w (P,K), J_c (P,K,2,6), J_p (P,K,2,3), mask (P,K)."""
    T = T_cw[_cam_idx(problem)]                          # (P, K, 4, 4)
    r, Xc = _project_residual(T, points[:, None, :], problem.obs_uv, K_intr)
    mask = problem.obs_mask & problem.point_mask[:, None] & (Xc[..., 2] > 1e-3)
    J_c, J_p = _jacobians(Xc, T[..., :3, :3], K_intr)
    w = _huber_weight(r, huber_delta) * mask.to(r.dtype)
    return r, w, J_c, J_p, mask


def _diag_blocks(S):
    """(C, C, 6, 6) -> its (C, 6, 6) diagonal blocks (a view)."""
    return torch.diagonal(S, dim1=0, dim2=1).permute(2, 0, 1)


def _schur_reduce(r, w, J_c, J_p, problem: BAProblem, lam):
    """Build the reduced camera system S (6C, 6C), b (6C,), plus the
    landmark back-substitution data (Hpp_inv (P,3,3), b_p (P,3), W_blk).
    Every camera-indexed reduction is contracted against a dense (P, K, C)
    camera-incidence tensor (matmuls only, memory ~ C*P)."""
    C = problem.num_cams
    dt, dev = r.dtype, r.device
    wJc = w[..., None, None] * J_c                       # (P, K, 2, 6)
    wJp = w[..., None, None] * J_p                       # (P, K, 2, 3)

    # landmark blocks
    H_pp = torch.einsum("pkri,pkrj->pij", wJp, J_p)      # (P, 3, 3)
    b_p = -torch.einsum("pkri,pkr->pi", wJp, r)          # (P, 3)
    tr_p = torch.clamp(torch.einsum("pii->p", H_pp), min=1e-6)
    H_pp = H_pp + lam * torch.eye(3, dtype=dt, device=dev)[None] \
        * tr_p[:, None, None] / 3.0
    Hpp_inv = _inv3x3(H_pp)

    # camera blocks
    H_cc_blk = torch.einsum("pkri,pkrj->pkij", wJc, J_c)  # (P, K, 6, 6)
    b_c_blk = -torch.einsum("pkri,pkr->pki", wJc, r)      # (P, K, 6)
    W_blk = torch.einsum("pkri,pkrj->pkij", wJc, J_p)     # (P, K, 6, 3)

    #   S -= W_k G W_l^T  at (cam_k, cam_l);   b_c -= W_k G b_p
    M_blk_all = torch.einsum("pkij,pjl->pkil", W_blk, Hpp_inv)  # (P, K, 6, 3)
    b_corr = torch.einsum("pkij,pj->pki", M_blk_all, b_p)       # (P, K, 6)

    E = ((problem.obs_cam[..., None]
          == torch.arange(C, device=dev)[None, None, :])
         & (w > 0)[..., None]).to(dt)                           # (P, K, C)
    H_cc = torch.einsum("pkc,pkij->cij", E, H_cc_blk)           # (C, 6, 6)
    b_c = torch.einsum("pkc,pki->ci", E, b_c_blk - b_corr)      # (C, 6)
    A = torch.einsum("pkc,pkim->pcim", E, M_blk_all)            # (P, C, 6, 3)
    Bm = torch.einsum("pkc,pkim->pcim", E, W_blk)               # (P, C, 6, 3)
    S = -torch.einsum("pcim,pdjm->cdij", A, Bm)                 # (C, C, 6, 6)
    _diag_blocks(S).add_(H_cc)

    # LM damping on camera blocks (scaled by each block's trace)
    diag = _diag_blocks(S)
    tr = torch.clamp(torch.einsum("cii->c", diag), min=1e-6)
    diag.add_(lam * torch.eye(6, dtype=dt, device=dev)[None]
              * tr[:, None, None] / 6.0)

    # gauge: fixed, unused and observation-less cameras get identity
    # rows/cols and a zero rhs (a free camera with no live observation
    # makes the system indefinite)
    has_obs = torch.einsum("cii->c", _diag_blocks(S)) > 1e-9
    free = problem.cam_mask & ~problem.cam_fixed & has_obs
    free_rc = free.repeat_interleave(6)
    Sd = S.permute(0, 2, 1, 3).reshape(6 * C, 6 * C)
    Sd = torch.where(free_rc[:, None] & free_rc[None, :], Sd, 0.0)
    Sd = Sd + torch.diag(torch.where(free_rc, 0.0, 1.0).to(dt))
    b = torch.where(free_rc, b_c.reshape(-1), 0.0)
    return Sd, b, Hpp_inv, b_p, W_blk


def _backsub(dx_cam, Hpp_inv, b_p, W_blk, problem: BAProblem):
    """Landmark updates given camera updates:
    dX_p = G_p (b_p - sum_k W_k^T dx_{cam_k})."""
    C = problem.num_cams
    dx = dx_cam.reshape(C, 6)[_cam_idx(problem)]         # (P, K, 6)
    valid = problem.obs_mask[..., None]
    corr = torch.einsum("pkij,pki->pj", W_blk, torch.where(valid, dx, 0.0))
    return torch.einsum("pij,pj->pi", Hpp_inv, b_p - corr)


def _solve_dense(S, b):
    """Solve S dx = b by Cholesky with jitter. Where S is not positive
    definite the step is zero, which the accept test rejects (raising the
    damping), as the reference's NaN-from-cho_factor guard does; no check
    reads ``info`` on the host."""
    C6 = S.shape[0]
    jitter = 1e-6 * torch.trace(S) / C6
    L, info = torch.linalg.cholesky_ex(
        S + jitter * torch.eye(C6, dtype=S.dtype, device=S.device),
        check_errors=False)
    dx = torch.cholesky_solve(b[:, None], L)[:, 0]
    return torch.where((info == 0) & torch.isfinite(dx), dx, 0.0)


def _solve_impl(problem: BAProblem, K_intr, cfg: BAConfig):
    """The LM loop: ``cfg.iterations`` steps with accept/reject and damping
    adaptation, all on tensors."""
    dev, dt = problem.T_cw.device, problem.T_cw.dtype
    K_intr = torch.as_tensor(K_intr).to(dev, dt)
    if cfg.schur_assembly == "scatter" or (
            cfg.schur_assembly == "auto"
            and problem.num_cams > cfg.onehot_max_cams):
        raise ValueError("the reference has the one-hot Schur assembly "
                         "only")

    def cost_of(T_cw, points):
        return compute_cost(problem.replace(T_cw=T_cw, points=points),
                            K_intr, cfg.huber_delta)

    free = (problem.cam_mask & ~problem.cam_fixed)[:, None]
    T_cw, points = problem.T_cw, problem.points
    cost = init_cost = cost_of(T_cw, points)
    lam = torch.full((), cfg.init_damping, dtype=dt, device=dev)
    accepts, costs = [], []
    for _ in range(cfg.iterations):
        r, w, J_c, J_p, _ = _gn_quantities(T_cw, points, problem, K_intr,
                                           cfg.huber_delta)
        S, b, Hpp_inv, b_p, W_blk = _schur_reduce(r, w, J_c, J_p, problem,
                                                  lam)
        dx_cam = _solve_dense(S, b)
        dX = _backsub(dx_cam, Hpp_inv, b_p, W_blk, problem)
        dX = torch.where(torch.isfinite(dX), dX, 0.0)

        xi = torch.where(free, dx_cam.reshape(-1, 6), 0.0)
        T_new = lie.se3_exp(xi) @ T_cw
        pts_new = torch.where(problem.point_mask[:, None], points + dX, points)
        new_cost = cost_of(T_new, pts_new)
        accept = (new_cost < cost) & torch.isfinite(new_cost)
        T_cw = torch.where(accept, T_new, T_cw)
        points = torch.where(accept, pts_new, points)
        cost = torch.where(accept, new_cost, cost)
        lam = torch.where(accept, lam * cfg.damping_down,
                          lam * cfg.damping_up)
        lam = torch.clamp(lam, 1e-9, 1e6)
        accepts.append(accept)
        costs.append(cost)
    return problem.replace(T_cw=T_cw, points=points), BAStats(
        initial_cost=init_cost, final_cost=cost,
        accepted=torch.stack(accepts), costs=torch.stack(costs))


def observation_residuals(problem: BAProblem, K_intr):
    """Per-observation reprojection error norm (P, K), inf where masked."""
    T = problem.T_cw[_cam_idx(problem)]
    K_intr = torch.as_tensor(K_intr).to(T.device, T.dtype)
    r, Xc = _project_residual(T, problem.points[:, None, :], problem.obs_uv,
                              K_intr)
    n = torch.linalg.vector_norm(r, dim=-1)
    mask = problem.obs_mask & problem.point_mask[:, None]
    return torch.where(mask & (Xc[..., 2] > 1e-3), n, torch.inf)


def solve_robust(problem: BAProblem, K_intr, cfg: BAConfig,
                 reject_px: float = 5.0, rounds: int = 2):
    """LM solve with interleaved gross-outlier rejection: between rounds,
    observations whose residual exceeds ``reject_px`` are disabled, and
    points left with < 2 live observations are dropped."""
    stats = None
    for i in range(rounds):
        problem, stats = _solve_impl(problem, K_intr, cfg)
        if i + 1 < rounds:
            keep = observation_residuals(problem, K_intr) < reject_px
            new_mask = problem.obs_mask & keep
            pt_alive = problem.point_mask & (new_mask.sum(dim=1) >= 2)
            problem = problem.replace(obs_mask=new_mask, point_mask=pt_alive)
    return problem, stats
