"""Published peaks of one NVIDIA H100 and the operations and bytes of the
program's two hand-written kernels.

Peaks: NVIDIA's H100 SXM data sheet, dense, at the full 700 W power
limit. A card set below it runs slower under load, so every share is
printed beside the card's power limit. A kernel's least time is the larger
of its bytes at the HBM rate and its operations at the peak of the unit it
runs on; its roofline share is that least time over its measured time.
Bytes count each input byte read once and each output byte written once.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12          # outside the tensor cores
BF16_OPS_PER_S = 989e12
INT8_OPS_PER_S = 1979e12       # the b1 tensor-core product is counted here

DESC_BYTES = 32                # a 256-bit descriptor


def least_s(n_bytes: float, n_ops: float, ops_per_s: float) -> float:
    """The least time of a kernel: bytes at the HBM rate or operations at
    ``ops_per_s``, whichever takes longer."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s)


def k1(n1: int, n2: int):
    """(bytes, operations, ops/s) of K1, the all-pairs Hamming matrix of
    (n1, 8) and (n2, 8) int32 descriptors: both read once, the (n1, n2)
    int32 distances written once; an AND and a popcount per bit pair."""
    return (4 * n1 * n2 + DESC_BYTES * (n1 + n2), 2 * 256 * n1 * n2,
            INT8_OPS_PER_S)


def k2(n_kp: int, size: int, archive: int):
    """(bytes, operations, ops/s) of K2, search-by-projection of ``n_kp``
    keypoints against the ``size`` live points of a map with ``archive``
    descriptors a point. Map side, a row each: the projected pixel (8),
    the visibility flag (1), last seen (4), the archive count (4) and the
    archive; keypoint side: pixel (8), free flag (1), descriptor, and the
    packed key written (4). Five f32 operations a keypoint and point pair
    (the pixel gate), which bound it."""
    n_bytes = (size * (8 + 1 + 4 + 4 + DESC_BYTES * archive)
               + n_kp * (8 + 1 + DESC_BYTES + 4))
    return n_bytes, 5 * n_kp * size, F32_OPS_PER_S
