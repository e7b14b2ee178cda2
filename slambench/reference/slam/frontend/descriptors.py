"""Upright BRIEF descriptors and bit packing.

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
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import FrontendConfig
from ..core.types import device_constant

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


def _pixel(coord, size: int):
    """round(coord) clipped to [0, size): the reference's
    ``clip(round(c).astype(int32), 0, size - 1)``, in int64 so a far-off
    prediction saturates instead of wrapping."""
    return torch.clamp(torch.round(coord).long(), 0, size - 1)


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
