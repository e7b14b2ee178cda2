"""Search-by-projection association, both tiers in one pass, plain torch
(the port's K2 computes the same packed keys in a persistent CUDA kernel)."""
from __future__ import annotations

import torch

from ..frontend.descriptors import unpack_bits

NO_KEY = 1 << 30      # larger than any packed key (256 * 2^18 + id < 2^27)
BIG = 1 << 14         # distance reported when nothing is found
ID_BITS = 18          # packed-key id field: capacity <= 2^18


def decode(key):
    """Packed keys (N,) -> (point_id (N,) i32, distance (N,) i32)."""
    found = key < NO_KEY
    pid = torch.where(found, key & ((1 << ID_BITS) - 1), -1)
    dist = torch.where(found, key >> ID_BITS, BIG)
    return pid.to(torch.int32), dist.to(torch.int32)


def associate_plain(muv, vis, last_seen, dcount, desc, size, frame_idx,
                    kp_uv, kp_free, kp_desc, *, r_sq, hamming_max,
                    reacq_r_sq, reacq_hamming_max, reacq_max_age,
                    block: int = 4096):
    """Plain torch over fixed shapes: map blocks of ``block`` rows, the
    Hamming min over slots as exact f32 bit-plane products, a masked
    packed-key min. Returns the packed keys (N,) i32.

    ``size`` is unused: rows past the cursor are never visible (``vis``
    includes ``alive``), and skipping them would need the host to read it.
    """
    del size
    C = muv.shape[0]
    K = desc.shape[0] // C
    N = kp_uv.shape[0]
    kbits = unpack_bits(kp_desc).to(torch.float32)         # (N, 256)
    kpop = kbits.sum(1)
    if reacq_max_age > 0:
        age = frame_idx - last_seen
        recent = vis & (age >= 1) & (age <= reacq_max_age)
    else:
        recent = torch.zeros_like(vis)
    best = torch.full((N,), NO_KEY, dtype=torch.int32, device=muv.device)
    for s in range(0, C, block):
        e = min(s + block, C)
        du = muv[s:e, 0:1] - kp_uv[None, :, 0]
        dv = muv[s:e, 1:2] - kp_uv[None, :, 1]
        d2 = du * du + dv * dv
        near = vis[s:e, None] & (d2 <= r_sq)
        near_rq = recent[s:e, None] & (d2 <= reacq_r_sq)
        slots = desc[s * K:e * K].reshape(e - s, K, 8)
        ham = torch.full((e - s, N), BIG, dtype=torch.int32,
                         device=muv.device)
        for k in range(K):
            bits = unpack_bits(slots[:, k].contiguous()).to(torch.float32)
            d_k = (bits.sum(1)[:, None] + kpop[None, :]
                   - 2.0 * (bits @ kbits.T)).to(torch.int32)
            ham = torch.where((dcount[s:e] > k)[:, None],
                              torch.minimum(ham, d_k), ham)
        ok = (near & (ham < hamming_max)) | (near_rq & (ham < reacq_hamming_max))
        ok = ok & kp_free[None, :]
        row = torch.arange(s, e, dtype=torch.int32, device=muv.device)
        key = torch.where(ok, ham * (1 << ID_BITS) + row[:, None], NO_KEY)
        best = torch.minimum(best, key.amin(dim=0))
    return best
