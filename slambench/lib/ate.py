"""Trajectory error after Sim(3) (Umeyama) alignment: ATE RMSE.

A frozen copy of the program's trajectory arithmetic, numpy only.
Monocular SLAM is scale-ambiguous, hence the similarity alignment.
"""
from __future__ import annotations

import numpy as np


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """Least-squares similarity transform aligning src -> dst.

    Args:
      src, dst: (N, 3) corresponding points.
    Returns:
      s (float), R (3,3), t (3,): dst ≈ s * R @ src + t.
    """
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    var_s = (xs ** 2).sum() / len(src)
    s = float(np.trace(np.diag(D) @ S) / var_s) if with_scale else 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(est_poses: np.ndarray, gt_poses: np.ndarray, with_scale: bool = True):
    """Absolute trajectory error RMSE after Sim(3) alignment.

    Args:
      est_poses, gt_poses: (F, 4, 4) T_wc pose arrays.
    Returns:
      (rmse, aligned_positions (F,3), errors (F,))
    """
    p_est = est_poses[:, :3, 3]
    p_gt = gt_poses[:, :3, 3]
    # Robustness: evaluate over finite rows only (a crashed/diverged run
    # must yield a number plus the finite fraction, not an SVD error).
    ok = np.isfinite(p_est).all(axis=1) & np.isfinite(p_gt).all(axis=1)
    if ok.sum() < 3:
        bad = np.full(len(p_est), np.inf)
        return float("inf"), p_est, bad
    s, R, t = umeyama_alignment(p_est[ok], p_gt[ok], with_scale=with_scale)
    aligned = (s * (R @ np.where(np.isfinite(p_est), p_est, 0.0).T)).T + t
    err = np.where(ok, np.linalg.norm(aligned - p_gt, axis=1), np.inf)
    return float(np.sqrt((err[ok] ** 2).mean())), aligned, err
