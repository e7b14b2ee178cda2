"""Synthetic scenes and frames made on the device, for device-resident runs.

Port of ``vslam_tpu/datasets/synthetic_device.py``. The host renderer
(``datasets/synthetic.py`` ``render_frame``) is a Python loop of patch
splats; this module renders the same scene model with tensor ops: project
every landmark, resample each landmark's patch by its subpixel offset (the
host renderer's bilinear 4-tap scheme) and splat the patches into the frame.

Overlaps follow the host renderer's painter's algorithm through a two-pass
z-buffer: a scatter ``amin`` of per-pixel depth, then each patch writes
only the pixels it owns (its depth equals the buffer's) by a scatter
``amax``; both reductions are order-free, so the frame does not depend on
the order of colliding writes. Writes of landmarks out of view go to a dump
pixel past the end of the frame (as ``core.types.scatter_drop`` does), not
through a boolean filter: ``render_frame_device`` has no host sync and runs
inside ``process_chunk``'s captured graph as its ``render_fn``.
"""
from __future__ import annotations

import torch


def make_corridor_scene_device(gen: torch.Generator, poses, num_points: int,
                               lateral: float = 14.0, vertical: float = 5.0,
                               ahead_min: float = 4.0, ahead_max: float = 45.0,
                               patch_size: int = 9):
    """A corridor scene made on ``gen``'s device: landmarks anchored along
    the (F, 4, 4) T_wc ``poses`` (uniform depth ahead of a random pose,
    Gaussian lateral and vertical offsets), each with a smoothed
    high-contrast binary texture and an X-junction center (the host
    generator's design). Statistically equivalent to the reference, not
    bit-equal: the random streams differ.

    Returns (xyz (P, 3), patches (P, ps, ps)) float32.
    """
    dev = gen.device
    f32 = dict(dtype=torch.float32, device=dev, generator=gen)
    poses = torch.as_tensor(poses, dtype=torch.float32, device=dev)
    P, ps = num_points, patch_size
    idx = torch.randint(0, poses.shape[0], (P,), device=dev, generator=gen)
    T = poses[idx]                                        # (P, 4, 4)
    right, up, fwd = T[:, :3, 0], T[:, :3, 1], T[:, :3, 2]
    ahead = ahead_min + (ahead_max - ahead_min) * torch.rand((P, 1), **f32)
    xyz = (T[:, :3, 3] + fwd * ahead
           + right * (torch.randn((P, 1), **f32) * lateral)
           + up * (torch.randn((P, 1), **f32) * vertical))

    binary = torch.where(torch.rand((P, ps, ps), **f32) > 0.5, 0.85, 0.15)
    # 3x3 box smooth, edge-padded (synthetic._box3)
    e = torch.clamp(torch.arange(-1, ps + 1, device=dev), 0, ps - 1)
    pp = binary[:, e][:, :, e]
    patches = sum(pp[:, dy:dy + ps, dx:dx + ps]
                  for dy in range(3) for dx in range(3)) / 9.0
    c, q = ps // 2, 2
    hi = 0.9 + 0.1 * torch.rand((P, 1, 1), **f32)
    lo = 1.0 - hi
    patches[:, c - q:c, c - q:c] = hi
    patches[:, c:c + q, c:c + q] = hi
    patches[:, c - q:c, c:c + q] = lo
    patches[:, c:c + q, c - q:c] = lo
    return xyz, patches


def render_frame_device(xyz, patches, K, T_wc, width: int, height: int,
                        background: float = 0.35):
    """Render one grayscale frame on the device of its inputs.

    Args:
      xyz: (P, 3) world landmarks; patches: (P, ps, ps) textures in [0, 1].
      K: (3, 3) intrinsics; T_wc: (4, 4) camera-to-world pose.
    Returns: (H, W) float32 image in [0, 1].
    """
    P, ps, _ = patches.shape
    r = ps // 2
    dev = xyz.device
    # the reference's general (LU) inverse: a rigid inverse differs in the
    # last bits, which moves splats' subpixel phase by up to ~5e-5 of
    # intensity; ``inv_ex`` reads no error flag back (no host sync)
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

    # subpixel placement: the host renderer's bilinear 4-tap resample
    e = torch.clamp(torch.arange(-1, ps + 1, device=dev), 0, ps - 1)
    pp = patches[:, e][:, :, e]
    shifted = ((1 - fy) * (1 - fx) * pp[:, 1:-1, 1:-1]
               + (1 - fy) * fx * pp[:, 1:-1, :-2]
               + fy * (1 - fx) * pp[:, :-2, 1:-1]
               + fy * fx * pp[:, :-2, :-2])               # (P, ps, ps)

    # flat pixel index of every patch cell; landmarks out of view write to
    # the dump pixel H*W (their coordinates are zeroed before the integer
    # cast, so no out-of-range float is converted)
    d = torch.arange(-r, r + 1, device=dev)
    xi = torch.where(vis, xf, 0.0).long()
    yi = torch.where(vis, yf, 0.0).long()
    flat = (yi[:, None, None] + d[None, :, None]) * width \
        + (xi[:, None, None] + d[None, None, :])
    flat = torch.where(vis[:, None, None], flat, height * width).reshape(-1)

    # pass 1: per-pixel nearest depth
    zpix = z[:, None, None].expand(P, ps, ps).reshape(-1)
    zbuf = torch.full((height * width + 1,), torch.inf, dtype=torch.float32,
                      device=dev)
    zbuf = zbuf.scatter_reduce(0, flat, zpix, "amin")
    # pass 2: each patch writes only the pixels it owns
    own = zpix == zbuf[flat]
    val = torch.where(own, shifted.reshape(-1), -torch.inf)
    img = torch.full((height * width + 1,), -torch.inf, dtype=torch.float32,
                     device=dev)
    img = img.scatter_reduce(0, flat, val, "amax")[:-1].reshape(height, width)
    return torch.where(torch.isfinite(img), img, background)
