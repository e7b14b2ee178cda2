"""Hamming distance between packed 256-bit descriptors — the plain oracle.

Port of ``vslam_tpu/matching/hamming.py::hamming_popcount``. torch has no
popcount op, so this is a SWAR bit count on int64 (an int32 SWAR count
overflows on the 0x01010101 multiply). It materializes (rows, N2, 8)
int64 words, so it works in row chunks; the matcher's production path is
``ops/hamming.py`` (kernel K1 on CUDA).
"""
from __future__ import annotations

import torch

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
    """(N1,8) x (N2,8) int32 bit-views -> (N1,N2) int32 Hamming distances."""
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
