"""Hamming distance between packed 256-bit descriptors.

Port of ``vslam_tpu/matching/hamming.py``; descriptors are (N, 8) int32
bit-views. torch has no popcount op, so ``hamming_popcount`` (the oracle)
and ``hamming_pairwise`` use a SWAR bit count on int64 (an int32 SWAR count
overflows on the 0x01010101 multiply). ``hamming_matmul`` is the bit-plane
product d(a, b) = |a| + |b| - 2 a·b, which is K1's plain version
``ops.hamming.hamming_plain``. The matcher's production path is kernel K1
(``ops/hamming.py``); these stay as the reference's alternatives and the
yardsticks ``ops.bench_kernels`` races against it.
"""
from __future__ import annotations

import torch

from ..ops.hamming import hamming_plain

_M32 = 0xFFFFFFFF


def popcount32(x):
    """Per-element popcount of 32-bit words held in an int64 tensor
    (any sign-extension above bit 31 is masked off first)."""
    x = x & _M32
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _M32) >> 24


def hamming_popcount(desc1, desc2, chunk: int = 1024):
    """(N1,8) x (N2,8) int32 bit-views -> (N1,N2) int32 Hamming distances.
    Works in row chunks: it materializes (rows, N2, 8) int64 words."""
    a = desc1.to(torch.int64)
    b = desc2.to(torch.int64)
    out = []
    for s in range(0, a.shape[0], chunk):
        x = a[s:s + chunk, None, :] ^ b[None, :, :]
        out.append(popcount32(x).sum(dim=-1).to(torch.int32))
    if not out:
        return torch.zeros((0, b.shape[0]), dtype=torch.int32,
                           device=desc1.device)
    return torch.cat(out, dim=0)


# Bit-plane GEMM, (N1,8) x (N2,8) int32 bit-views -> (N1,N2) int32: one
# implementation, K1's plain version.
hamming_matmul = hamming_plain


def hamming_pairwise(desc1, desc2):
    """Row-wise Hamming distance of aligned (N, 8) bit-views -> (N,) int32."""
    x = desc1.to(torch.int64) ^ desc2.to(torch.int64)
    return popcount32(x).sum(dim=-1).to(torch.int32)
