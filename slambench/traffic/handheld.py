"""A handheld camera moved back and forth over a desk-sized box of
landmarks, revisiting the same landmarks again and again.

The camera sits in front of the box and looks into it. Its position
oscillates along x, y and z and its orientation about three axes, each a
sinusoid of its own amplitude and period; the seed draws the phases and
the scene. Time is then scaled so that the path's mean speed and mean
angular speed over the sequence are exactly ``speed_m_s`` and
``turn_deg_s`` at ``rate_hz`` frames a second, whatever the seed: every
seed moves the same amount, along another path.

Parameters (the traffic file): ``rate_hz``, ``speed_m_s``, ``turn_deg_s``,
``amplitude_m`` [x, y, z], ``period_s`` [x, y, z],
``angle_amplitude_deg`` [pitch, yaw, roll], ``angle_period_s`` [three],
``landmarks``, ``box_m`` [half width, half height], ``depth_m``
[near, far].
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import render


def _rot(a: np.ndarray) -> np.ndarray:
    """(n, 3, 3) rotations R_x(pitch) R_y(yaw) R_z(roll) of (n, 3) angles."""
    cx, cy, cz = np.cos(a.T)
    sx, sy, sz = np.sin(a.T)
    one, zero = np.ones_like(cx), np.zeros_like(cx)
    Rx = np.stack([one, zero, zero, zero, cx, -sx, zero, sx, cx], -1)
    Ry = np.stack([cy, zero, sy, zero, one, zero, -sy, zero, cy], -1)
    Rz = np.stack([cz, -sz, zero, sz, cz, zero, zero, zero, one], -1)
    return (Rx.reshape(-1, 3, 3) @ Ry.reshape(-1, 3, 3)
            @ Rz.reshape(-1, 3, 3))


def _path(t, amp, period, phase):
    """(n, 3) sinusoids and their (n, 3) derivatives at times t."""
    w = 2 * math.pi / np.asarray(period)
    arg = t[:, None] * w + phase
    return np.asarray(amp) * np.sin(arg), np.asarray(amp) * w * np.cos(arg)


def trajectory(n: int, p: dict, rng: np.random.Generator) -> np.ndarray:
    """(n, 4, 4) float32 T_wc poses at ``rate_hz`` whose mean speed and mean
    angular speed are the traffic's."""
    t = np.arange(n, dtype=np.float64) / p["rate_hz"]
    ph_t, ph_r = rng.uniform(0, 2 * math.pi, (2, 3))
    amp_r = np.deg2rad(p["angle_amplitude_deg"])
    _, v = _path(t, p["amplitude_m"], p["period_s"], ph_t)
    _, w = _path(t, amp_r, p["angle_period_s"], ph_r)
    # the speeds scale with 1 / period: stretch time, axis by axis alike
    kt = np.linalg.norm(v, axis=1).mean() / p["speed_m_s"]
    kr = np.degrees(np.linalg.norm(w, axis=1).mean()) / p["turn_deg_s"]
    pos, _ = _path(t, p["amplitude_m"], np.asarray(p["period_s"]) * kt, ph_t)
    ang, _ = _path(t, amp_r, np.asarray(p["angle_period_s"]) * kr, ph_r)
    poses = np.tile(np.eye(4), (n, 1, 1))
    poses[:, :3, :3] = _rot(ang)
    poses[:, :3, 3] = pos
    return poses.astype(np.float32)


def make(p: dict, cam: dict, n_frames: int, seed: int, device):
    """(poses (n, 4, 4) float32 T_wc on the host, frames (n, H, W) uint8 on
    ``device``) of the handheld sequence drawn from ``seed``."""
    W, H = cam["width"], cam["height"]
    poses = trajectory(n_frames, p, np.random.default_rng([seed, 0]))
    gen = torch.Generator(device=device).manual_seed(seed)
    f32 = dict(dtype=torch.float32, device=device, generator=gen)
    P = p["landmarks"]
    bx, by = p["box_m"]
    near, far = p["depth_m"]
    lo = torch.tensor([-bx, -by, near], dtype=torch.float32, device=device)
    hi = torch.tensor([bx, by, far], dtype=torch.float32, device=device)
    xyz = lo + (hi - lo) * torch.rand((P, 3), **f32)
    patches = render.make_patches(gen, P)
    K = torch.from_numpy(render.intrinsics(cam)).to(device)
    poses_d = torch.from_numpy(poses).to(device)
    frames = torch.empty((n_frames, H, W), dtype=torch.uint8, device=device)
    for f in range(n_frames):
        frames[f] = render.to_uint8(render.render(xyz, patches, K, poses_d[f],
                                                  W, H))
    return poses, frames
