"""The reference's random stream: ``jax.random``'s Threefry-2x32 keys.

The reference draws its RANSAC samples with ``jax.random.randint`` from
``fold_in(PRNGKey(seed), frame_idx)``. These functions reproduce those
draws bit for bit (jax's partitionable Threefry, its default since jax
0.5), so the port can run the reference's own random stream
(``tracker.init_state(rng="threefry")``) and a run can be held to the
reference's run on the same samples.

A key is a (2,) int64 tensor holding the two uint32 words of a jax key,
high word first. The arithmetic is int64 masked to 32 bits: it runs on
any device, without a host sync, and inside a captured CUDA graph.
"""
from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for 0 <= seed < 2**32."""
    return torch.tensor([0, seed & MASK],
                        dtype=torch.int64, device=device)


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK


def hash2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds of the counter words (x0, x1) under the
    key words (k0, k1); every argument broadcasts."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(k, data)`` for 0 <= data < 2**32 (a Python int
    or a 0-d integer tensor)."""
    data = torch.as_tensor(data, device=k.device).to(torch.int64) & MASK
    return torch.stack(hash2x32(k[0], k[1], torch.zeros_like(data), data))


def split(k: torch.Tensor):
    """``jax.random.split(k)``: the two subkeys."""
    c = torch.arange(2, dtype=torch.int64, device=k.device)
    a, b = hash2x32(k[0], k[1], torch.zeros_like(c), c)
    return torch.stack((a[0], b[0])), torch.stack((a[1], b[1]))


def bits(k: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits(k, shape)``: uint32 words as int64, fewer than
    2**32 of them."""
    n = 1
    for d in shape:
        n *= d
    c = torch.arange(n, dtype=torch.int64, device=k.device).reshape(shape)
    a, b = hash2x32(k[0], k[1], torch.zeros_like(c), c)
    return a ^ b


def fma(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as XLA computes the product and
    sum it contracts into one fused multiply-add. The product of two
    float32 values is exact in float64; the sum is rounded to odd there
    (its error from a two-sum made sticky in the last bit), so the one
    rounding to float32 that follows is the correct rounding."""
    a, b, c = (torch.as_tensor(x, dtype=torch.float64) for x in (a, b, c))
    p = a * b
    s = p + c
    bp = s - c
    err = (p - bp) + (c - (s - bp))
    w = s.view(torch.int64)
    step = torch.where((err > 0) == (s > 0), 1, -1)
    w = torch.where((err != 0) & (w & 1 == 0), w + step, w)
    return w.view(torch.float64).to(torch.float32)


def uniform(k: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(k, shape, float32, minval, maxval)``: the top 23
    bits of each word as the mantissa of a float in [1, 2), minus 1, then
    ``* (maxval - minval) + minval`` as one fused multiply-add (``fma``, as
    XLA contracts it) and ``max(minval, .)``."""
    f32 = dict(dtype=torch.float32, device=k.device)
    lo = torch.tensor(minval, **f32)
    span = torch.tensor(maxval, **f32) - lo
    mant = ((bits(k, shape) >> 9) | 0x3F800000).to(torch.int32)
    return torch.maximum(lo, fma(mant.view(torch.float32) - 1.0, span, lo))


def randint(k: torch.Tensor, shape, maxval) -> torch.Tensor:
    """``jax.random.randint(k, shape, 0, maxval)`` for an int32 ``maxval``
    (a Python int or a 0-d tensor): two words per value, reduced modulo
    the span as jax does. Returns int64."""
    k1, k2 = split(k)
    hi, lo = bits(k1, shape), bits(k2, shape)
    span = torch.clamp(torch.as_tensor(maxval, device=k.device)
                       .to(torch.int64), min=1)
    mult = ((65536 % span) ** 2 & MASK) % span
    return ((hi % span * mult & MASK) + lo % span & MASK) % span
