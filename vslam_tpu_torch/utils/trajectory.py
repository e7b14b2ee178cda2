"""Trajectory import/export in TUM and KITTI formats.

The reference's only persistence hook was a commented-out JSON matrix dump
(reference src/vslam.cpp:21, include/helpers.h:13-15); proper trajectory I/O
is required for ATE evaluation against ground truth.
"""
from __future__ import annotations

import numpy as np


def _rotmat_to_quat(R: np.ndarray) -> np.ndarray:
    """(3,3) -> (4,) quaternion [qx, qy, qz, qw] (TUM order)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        qw = 0.25 * s
        qx = (R[2, 1] - R[1, 2]) / s
        qy = (R[0, 2] - R[2, 0]) / s
        qz = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        qw = (R[2, 1] - R[1, 2]) / s
        qx = 0.25 * s
        qy = (R[0, 1] + R[1, 0]) / s
        qz = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        qw = (R[0, 2] - R[2, 0]) / s
        qx = (R[0, 1] + R[1, 0]) / s
        qy = 0.25 * s
        qz = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        qw = (R[1, 0] - R[0, 1]) / s
        qx = (R[0, 2] + R[2, 0]) / s
        qy = (R[1, 2] + R[2, 1]) / s
        qz = 0.25 * s
    return np.array([qx, qy, qz, qw])


def _quat_to_rotmat(q: np.ndarray) -> np.ndarray:
    qx, qy, qz, qw = q
    n = qx * qx + qy * qy + qz * qz + qw * qw
    s = 0.0 if n < 1e-12 else 2.0 / n
    wx, wy, wz = s * qw * qx, s * qw * qy, s * qw * qz
    xx, xy, xz = s * qx * qx, s * qx * qy, s * qx * qz
    yy, yz, zz = s * qy * qy, s * qy * qz, s * qz * qz
    return np.array(
        [
            [1 - (yy + zz), xy - wz, xz + wy],
            [xy + wz, 1 - (xx + zz), yz - wx],
            [xz - wy, yz + wx, 1 - (xx + yy)],
        ]
    )


def save_tum(path: str, poses: np.ndarray, timestamps=None) -> None:
    """TUM format: `timestamp tx ty tz qx qy qz qw` per line."""
    if timestamps is None:
        timestamps = np.arange(len(poses), dtype=np.float64)
    with open(path, "w") as f:
        for ts, T in zip(timestamps, poses):
            q = _rotmat_to_quat(T[:3, :3])
            t = T[:3, 3]
            f.write(
                f"{ts:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n"
            )


def load_tum(path: str):
    """Returns (timestamps (F,), poses (F,4,4))."""
    ts_list, poses = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(v) for v in line.split()]
            ts_list.append(vals[0])
            T = np.eye(4)
            T[:3, 3] = vals[1:4]
            T[:3, :3] = _quat_to_rotmat(np.array(vals[4:8]))
            poses.append(T)
    return np.asarray(ts_list), np.asarray(poses)


def save_kitti(path: str, poses: np.ndarray) -> None:
    """KITTI format: 12 row-major values of the 3x4 [R|t] per line."""
    with open(path, "w") as f:
        for T in poses:
            f.write(" ".join(f"{v:.6e}" for v in T[:3, :4].reshape(-1)) + "\n")


def load_kitti(path: str) -> np.ndarray:
    poses = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            vals = np.array([float(v) for v in line.split()]).reshape(3, 4)
            T = np.eye(4)
            T[:3, :4] = vals
            poses.append(T)
    return np.asarray(poses)
