"""Kernel K1: the all-pairs Hamming distance matrix.

Replaces the Pallas TPU kernel ``vslam_tpu/ops/pallas_hamming.py``
``_hamming_kernel`` (launched by ``hamming_pallas``): ``popcount(a ^ b)``
summed over the 8 words of two packed 256-bit descriptors, for every pair.

On Hopper (``csrc/hamming.cu``) the bit product runs on the b1 tensor
cores: one ``mma.sync`` m16n8k256 ``.and.popc`` gives popc(a & b) for a 16 x
8 block of descriptor pairs, and d = |a| + |b| - 2 popc(a & b). A block
stages its 16 x 128 output tile in shared memory and writes it with 16-byte
stores. The ragged edge is masked, so N1 and N2 need no padding (the
Pallas kernel needs multiples of 256). What bounds it on the card is writing
the (N1, N2) int32 matrix (37.75 MB at 3072 x 3072); keeping the matrix out
of device memory (fusing the matcher's top-2 / cross-check reductions) is
later work.

``hamming_cuda`` is the wrapper: a CPU tensor runs ``hamming_plain``; a CUDA
tensor launches the kernel or raises. ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..frontend.descriptors import unpack_bits
from . import _build

launches = 0

_TM = 16          # csrc/hamming.cu rows of d1 per block (grid.y)


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


@functools.lru_cache(maxsize=1)
def _entry():
    p = ctypes.c_void_p
    return _build.declare("vslam_hamming",
                          [p, p, p, ctypes.c_int, ctypes.c_int, p])


def _check_desc(d, name):
    if d.dtype != torch.int32 or d.dim() != 2 or d.shape[1] != 8:
        raise ValueError(f"{name}: want (N, 8) int32, got "
                         f"{tuple(d.shape)} {d.dtype}")
    if not d.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def hamming_cuda(d1, d2):
    """(N1, 8) x (N2, 8) int32 bit-views -> (N1, N2) int32 distances."""
    global launches
    _check_desc(d1, "d1")
    _check_desc(d2, "d2")
    if d1.device != d2.device:
        raise ValueError(f"d1 on {d1.device}, d2 on {d2.device}")
    if d1.device.type == "cpu":
        return hamming_plain(d1, d2)
    if d1.device.type != "cuda":
        raise ValueError(f"unsupported device {d1.device}")
    n1, n2 = d1.shape[0], d2.shape[0]
    if (n1 + _TM - 1) // _TM > 65535:
        raise ValueError(f"N1={n1} exceeds the kernel's grid")
    out = torch.empty((n1, n2), dtype=torch.int32, device=d1.device)
    stream = torch.cuda.current_stream(d1.device).cuda_stream
    with torch.cuda.device(d1.device):
        err = _entry()(d1.data_ptr(), d2.data_ptr(), out.data_ptr(),
                       n1, n2, stream)
    _build.check(err, "hamming kernel")
    launches += 1
    return out
