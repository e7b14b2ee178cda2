"""A KITTI-like forward drive down a corridor of landmarks.

The program's device-resident endurance scene, frozen here: landmarks
anchor to random poses of a forward-dominant path (constant yaw rate,
random sway) and sit ahead of them in the camera frame, with Gaussian
lateral and vertical offsets, so every stretch of the drive has the same
density of landmarks. Each frame is rendered from the landmarks anchored
within ``render_back`` frames behind and ``render_ahead`` frames ahead of
it, which holds every landmark that can lie in front of the camera
within ``ahead_m`` plus ``render_ahead`` steps.

Parameters (the traffic file): ``step_m`` a frame, ``yaw_rate`` (rad a
frame), ``sway`` (m), ``landmarks_per_frame``, ``lateral_m``,
``vertical_m``, ``ahead_m`` [near, far], ``render_back``,
``render_ahead`` (frames).
"""
from __future__ import annotations

import numpy as np
import torch

from . import render


def trajectory(n: int, step: float, yaw_rate: float, sway: float,
               rng: np.random.Generator) -> np.ndarray:
    """(n, 4, 4) float32 T_wc poses: each frame turns by ``yaw_rate`` and
    moves ``step`` forward with Gaussian sideways and vertical sway."""
    c, s = np.cos(yaw_rate), np.sin(yaw_rate)
    delta = np.eye(4, dtype=np.float32)
    delta[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    sway_xy = rng.standard_normal((n, 2)).astype(np.float32) * sway
    poses = np.zeros((n, 4, 4), np.float32)
    T = np.eye(4, dtype=np.float32)
    for i in range(n):
        poses[i] = T
        delta[:3, 3] = (sway_xy[i, 0], 0.3 * sway_xy[i, 1], step)
        T = (T @ delta).astype(np.float32)
    return poses


def make(p: dict, cam: dict, n_frames: int, seed: int, device):
    """(poses (n, 4, 4) float32 T_wc on the host, frames (n, H, W) uint8 on
    ``device``) of the drive drawn from ``seed``."""
    W, H = cam["width"], cam["height"]
    poses = trajectory(n_frames, p["step_m"], p["yaw_rate"], p["sway"],
                       np.random.default_rng([seed, 0]))
    gen = torch.Generator(device=device).manual_seed(seed)
    f32 = dict(dtype=torch.float32, device=device, generator=gen)
    poses_d = torch.from_numpy(poses).to(device)
    P = n_frames * p["landmarks_per_frame"]
    anchor = torch.sort(torch.randint(0, n_frames, (P,), device=device,
                                      generator=gen))[0]
    T = poses_d[anchor]
    near, far = p["ahead_m"]
    xyz = (T[:, :3, 3]
           + T[:, :3, 2] * (near + (far - near) * torch.rand((P, 1), **f32))
           + T[:, :3, 0] * (torch.randn((P, 1), **f32) * p["lateral_m"])
           + T[:, :3, 1] * (torch.randn((P, 1), **f32) * p["vertical_m"]))
    patches = render.make_patches(gen, P)
    i = torch.arange(n_frames, device=device)
    lo = torch.searchsorted(anchor, i - p["render_back"]).tolist()
    hi = torch.searchsorted(anchor, i + p["render_ahead"]).tolist()
    K = torch.from_numpy(render.intrinsics(cam)).to(device)
    frames = torch.empty((n_frames, H, W), dtype=torch.uint8, device=device)
    for f in range(n_frames):
        frames[f] = render.to_uint8(render.render(
            xyz[lo[f]:hi[f]], patches[lo[f]:hi[f]], K, poses_d[f], W, H))
    return poses, frames
