"""BRIEF descriptors (upright and steered), orientations and bit packing.

Port of ``vslam_tpu/frontend/descriptors.py``. Descriptors are (N, 8) int32
bit-views of the reference's uint32 words.

``describe_dense_upright`` (the default, ``oriented=False``) gives the
reference's outputs bit for bit, but samples only at the N keypoints: the
reference builds a dense (H, W, 8) bit-plane image (gather-free on the TPU)
and then reads the keypoints' 8 words; the value it compares for pair
(x1,y1,x2,y2) at keypoint pixel (xi, yi) is ``img[clip(yi+y1),
clip(xi+x1)]`` of the edge-padded image, which is exactly what a gather at
the keypoint reads. On a GPU the gather is N*512 loads instead of 256
whole-image compares.

The steered path (``oriented=True``) is ``orientations_at`` (the dense
intensity-centroid map, four separable shift-MAC passes in the reference's
order, then one (N,) gather) and ``describe`` (the pattern rotated by each
keypoint's angle, rounded to the nearest pixel and gathered).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import FrontendConfig
from ..core.types import device_constant
from .features import _pixel, _sep_filter

_PATTERN_SEED = 42


@functools.lru_cache(maxsize=None)
def brief_pattern(bits: int = 256, patch_radius: int = 15):
    """(bits, 4) float32 [x1, y1, x2, y2] sampling offsets, Gaussian-distributed
    (BRIEF G-II), clipped inside the patch. Same seed as the reference."""
    rng = np.random.RandomState(_PATTERN_SEED)
    sigma = patch_radius / 2.5
    pts = rng.randn(bits, 4) * sigma
    pts = np.clip(pts, -(patch_radius - 1), patch_radius - 1)
    return pts.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _int_pattern(bits: int, patch_radius: int):
    """Integer-rounded BRIEF offsets for the dense (upright) path. Numpy."""
    return np.round(brief_pattern(bits, patch_radius)).astype(np.int32)


def _constant(arr: np.ndarray, dtype, device):
    """A numpy table as a per-device cached tensor (``device_constant``)."""
    return device_constant(tuple(map(tuple, arr.tolist())), dtype, device)


def _gather_nearest(img, y, x):
    """Nearest-neighbour sample of img (H, W) at float coords (any shape),
    clamped to the borders: round, clip, then one flat index."""
    H, W = img.shape
    yi = torch.clamp(torch.round(y), 0, H - 1).long()
    xi = torch.clamp(torch.round(x), 0, W - 1).long()
    return img.reshape(-1)[yi * W + xi]


def centroid_moments(img, patch_radius: int):
    """Dense square-window centroid moments (m01, m10), each (H, W):
    m10 = box_y(ramp_x(I)), m01 = box_x(ramp_y(I)), four separable
    shift-MAC passes in the reference's order."""
    r = patch_radius
    ramp = np.arange(-r, r + 1, dtype=np.float32)
    box = np.ones(2 * r + 1, dtype=np.float32)
    m10 = _sep_filter(_sep_filter(img, ramp, r, axis=1), box, r, axis=0)
    m01 = _sep_filter(_sep_filter(img, ramp, r, axis=0), box, r, axis=1)
    return m01, m10


def orientation_map(img, patch_radius: int):
    """Dense intensity-centroid orientation, one angle per pixel (a square
    window: exactly equivariant at multiples of 90 degrees)."""
    m01, m10 = centroid_moments(img, patch_radius)
    return torch.atan2(m01, m10)


def orientations_at(img, uv, patch_radius: int):
    """Per-keypoint orientation via the dense map + one (N,) gather."""
    H, W = img.shape
    amap = orientation_map(img, patch_radius)
    return amap[_pixel(uv[:, 1], H), _pixel(uv[:, 0], W)]


def pack_bits(bits):
    """(N, 256) bool -> (N, 8) int32 bit-view, little-endian within a word."""
    n, nbits = bits.shape
    words = bits.reshape(n, nbits // 32, 32).to(torch.int64)
    shifts = torch.arange(32, device=bits.device, dtype=torch.int64)
    w = torch.sum(words << shifts, dim=2)            # [0, 2^32)
    return w.to(torch.int32)                          # wraps: the bit-view


def unpack_bits(packed, nbits: int = 256):
    """(N, 8) int32 bit-view -> (N, 256) int8 in {0,1} (word-major, LSB
    first — the reference's bit order)."""
    n = packed.shape[0]
    shifts = torch.arange(32, device=packed.device, dtype=torch.int32)
    bits = (packed[:, :, None] >> shifts) & 1      # arithmetic >> keeps bit b
    return bits.reshape(n, nbits).to(torch.int8)


def describe_dense_upright(img_blurred, uv, cfg: FrontendConfig):
    """Upright BRIEF at each keypoint (bit-identical to the reference's
    dense formulation; see the module docstring)."""
    H, W = img_blurred.shape
    pat = _constant(_int_pattern(cfg.descriptor_bits, cfg.patch_radius),
                    torch.long, uv.device)                   # (B, 4)
    xi = _pixel(uv[:, 0], W)
    yi = _pixel(uv[:, 1], H)

    def sample(dx, dy):
        yy = torch.clamp(yi[:, None] + dy[None, :], 0, H - 1)
        xx = torch.clamp(xi[:, None] + dx[None, :], 0, W - 1)
        return img_blurred[yy, xx]                           # (N, B)

    bits = sample(pat[:, 0], pat[:, 1]) < sample(pat[:, 2], pat[:, 3])
    return pack_bits(bits)


def steered_pattern(angle, cfg: FrontendConfig):
    """The BRIEF pattern rotated by each keypoint's angle (N,): four (N, B)
    offsets (x1, y1, x2, y2)."""
    pat = _constant(brief_pattern(cfg.descriptor_bits, cfg.patch_radius),
                    torch.float32, angle.device)             # (B, 4)
    c = torch.cos(angle)[:, None]
    s = torch.sin(angle)[:, None]

    def rot(px, py):
        return c * px[None, :] - s * py[None, :], s * px[None, :] + c * py[None, :]

    return (*rot(pat[:, 0], pat[:, 1]), *rot(pat[:, 2], pat[:, 3]))


def describe(img_blurred, uv, angle, cfg: FrontendConfig):
    """Steered-BRIEF descriptors: img_blurred (H, W), uv (N, 2), angle (N,)
    radians -> (N, 8) int32 bit-views."""
    x1, y1, x2, y2 = steered_pattern(angle, cfg)
    i1 = _gather_nearest(img_blurred, uv[:, 1:2] + y1, uv[:, 0:1] + x1)
    i2 = _gather_nearest(img_blurred, uv[:, 1:2] + y2, uv[:, 0:1] + x2)
    return pack_bits(i1 < i2)
