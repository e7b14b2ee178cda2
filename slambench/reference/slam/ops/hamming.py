"""The all-pairs Hamming distance matrix, plain torch (the port's K1
computes the same integers on the tensor cores)."""
from __future__ import annotations

import torch

from ..frontend.descriptors import unpack_bits


def hamming_plain(d1, d2):
    """Plain torch: d(a, b) = |a| + |b| - 2 a·b over {0,1} bit planes (the
    reference's ``hamming_matmul``, which ``matching.hamming`` names it).

    The int8 ``@`` the reference's form suggests returns int8 in torch and
    overflows. On a CUDA device the planes are f16 and the product runs on
    the tensor cores; it is exact: every operand is 0 or 1, every partial
    sum an integer in [0, 256], and f16 holds every integer up to 2048, so
    no accumulation order or reduced-precision reduction can round. On the
    CPU (no fast f16 GEMM) the planes are f32, exact for the same reason."""
    a = unpack_bits(d1)
    b = unpack_bits(d2)
    dt = torch.float16 if a.is_cuda else torch.float32
    ab = (a.to(dt) @ b.to(dt).T).to(torch.int32)
    sa = a.sum(dim=1, dtype=torch.int32)
    sb = b.sum(dim=1, dtype=torch.int32)
    return sa[:, None] + sb[None, :] - 2 * ab
