"""Landmark textures and the frame renderer shared by the traffic
generators, made on the device from a seed.

A frozen copy of the synthetic renderer the program ships with (the
corridor scene's patch design and the two-pass z-buffer splat), so that a
change to the program cannot change the benchmark's frames. Frames leave
here as uint8, as a camera or a decoder gives them.
"""
from __future__ import annotations

import numpy as np
import torch


def intrinsics(cam: dict) -> np.ndarray:
    """(3, 3) float32 pinhole matrix of a configuration's ``camera``."""
    return np.array([[cam["fx"], 0.0, cam["cx"]], [0.0, cam["fy"], cam["cy"]],
                     [0.0, 0.0, 1.0]], np.float32)


def make_patches(gen: torch.Generator, n: int, ps: int = 9):
    """(n, ps, ps) float32 textures on ``gen``'s device: a high-contrast
    binary surround smoothed by a 3x3 box, with a checkerboard X-junction
    at the center (a corner the detector localizes at the projection)."""
    f32 = dict(dtype=torch.float32, device=gen.device, generator=gen)
    binary = torch.where(torch.rand((n, ps, ps), **f32) > 0.5, 0.85, 0.15)
    e = torch.clamp(torch.arange(-1, ps + 1, device=gen.device), 0, ps - 1)
    pp = binary[:, e][:, :, e]
    patches = sum(pp[:, dy:dy + ps, dx:dx + ps]
                  for dy in range(3) for dx in range(3)) / 9.0
    c, q = ps // 2, 2
    hi = 0.9 + 0.1 * torch.rand((n, 1, 1), **f32)
    lo = 1.0 - hi
    patches[:, c - q:c, c - q:c] = hi
    patches[:, c:c + q, c:c + q] = hi
    patches[:, c - q:c, c:c + q] = lo
    patches[:, c:c + q, c - q:c] = lo
    return patches


def render(xyz, patches, K, T_wc, width: int, height: int,
           background: float = 0.35):
    """One grayscale frame (H, W) float32 in [0, 1] of the (P, 3) world
    landmarks with their (P, ps, ps) textures, seen from the (4, 4) T_wc
    pose through K: each visible landmark's patch resampled by its
    subpixel offset and splatted, the nearest landmark owning a pixel."""
    P, ps, _ = patches.shape
    r = ps // 2
    dev = xyz.device
    T_cw = torch.linalg.inv_ex(T_wc)[0]
    Xc = xyz @ T_cw[:3, :3].T + T_cw[:3, 3]
    z = Xc[:, 2]
    uvw = Xc @ K.T
    uv = uvw[:, :2] / torch.where(torch.abs(z) < 1e-9, 1e-9, z)[:, None]
    vis = ((z > 0.2)
           & (uv[:, 0] >= r + 1) & (uv[:, 0] < width - r - 1)
           & (uv[:, 1] >= r + 1) & (uv[:, 1] < height - r - 1))
    xf = torch.floor(uv[:, 0])
    yf = torch.floor(uv[:, 1])
    fx = (uv[:, 0] - xf)[:, None, None]
    fy = (uv[:, 1] - yf)[:, None, None]
    e = torch.clamp(torch.arange(-1, ps + 1, device=dev), 0, ps - 1)
    pp = patches[:, e][:, :, e]
    shifted = ((1 - fy) * (1 - fx) * pp[:, 1:-1, 1:-1]
               + (1 - fy) * fx * pp[:, 1:-1, :-2]
               + fy * (1 - fx) * pp[:, :-2, 1:-1]
               + fy * fx * pp[:, :-2, :-2])
    # landmarks out of view write to a dump pixel past the frame's end
    d = torch.arange(-r, r + 1, device=dev)
    xi = torch.where(vis, xf, 0.0).long()
    yi = torch.where(vis, yf, 0.0).long()
    flat = (yi[:, None, None] + d[None, :, None]) * width \
        + (xi[:, None, None] + d[None, None, :])
    flat = torch.where(vis[:, None, None], flat, height * width).reshape(-1)
    zpix = z[:, None, None].expand(P, ps, ps).reshape(-1)
    zbuf = torch.full((height * width + 1,), torch.inf, dtype=torch.float32,
                      device=dev)
    zbuf = zbuf.scatter_reduce(0, flat, zpix, "amin")
    own = zpix == zbuf[flat]
    val = torch.where(own, shifted.reshape(-1), -torch.inf)
    img = torch.full((height * width + 1,), -torch.inf, dtype=torch.float32,
                     device=dev)
    img = img.scatter_reduce(0, flat, val, "amax")[:-1].reshape(height, width)
    return torch.where(torch.isfinite(img), img, background)


def to_uint8(img):
    """A [0, 1] float frame as uint8, rounded."""
    return torch.round(torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.uint8)


def to_float(frame_u8):
    """A uint8 frame as the float32 [0, 1] image the system takes."""
    return frame_u8.to(torch.float32) / 255.0
