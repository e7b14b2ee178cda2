"""Descriptor matching: knn-2 + Lowe ratio + cross-check, fully batched.

Port of ``vslam_tpu/matching/matcher.py`` (``match``, ``match_pairs``).
The distance matrix comes from ``ops.hamming.hamming_plain``
for every ``MatchingConfig.kernel`` value: the reference's three
implementations ("matmul", "popcount", "pallas") agree bit for bit, and so
does K1, so the setting cannot change a result; routing the default
"matmul" to ``hamming.hamming_matmul`` would only take the hand kernel off
the main path. ``torch.argmin`` returns the first index of the minimum, as
``jnp.argmin`` does, so tie-breaking matches the reference.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import MatchingConfig
from ..ops.hamming import hamming_plain

_BIG = 1 << 14  # larger than any 256-bit Hamming distance


class MatchResult(NamedTuple):
    idx2: torch.Tensor      # (N1,) i32 — matched index in frame2 per frame1 kp
    mask: torch.Tensor      # (N1,) bool — match survived ratio + cross-check
    distance: torch.Tensor  # (N1,) i32 — Hamming distance of the match


def match(desc1, mask1, desc2, mask2, cfg: MatchingConfig,
          uv1=None, uv2=None) -> MatchResult:
    """Match packed descriptors between two frames (see the reference
    docstring; ``uv1``/``uv2`` enable the guided window)."""
    guided = uv1 is not None and cfg.guided_radius > 0
    D = hamming_plain(desc1, desc2)
    D = torch.where(mask1[:, None] & mask2[None, :], D, _BIG)
    if guided:
        dx = uv1[:, None, 0] - uv2[None, :, 0]
        dy = uv1[:, None, 1] - uv2[None, :, 1]
        pix_sq = dx * dx + dy * dy
        D = torch.where(pix_sq <= cfg.guided_radius ** 2, D, _BIG)

    # top-2 smallest per row by two min passes (Lowe ratio test)
    d_best = D.amin(dim=1)
    best_j = torch.argmin(D, dim=1)
    cols = torch.arange(D.shape[1], device=D.device)[None, :]
    d_second = torch.where(cols == best_j[:, None], _BIG, D).amin(dim=1)
    ratio_ok = d_best.float() < cfg.lowe_ratio * d_second.float()

    ok = ratio_ok & mask1 & (d_best < _BIG)
    if guided:
        ok = ok & (d_best < cfg.guided_hamming_max)
    if cfg.cross_check:
        best_i_of_j = torch.argmin(D, dim=0)                     # (N2,)
        rows = torch.arange(D.shape[0], device=D.device)
        ok = ok & (best_i_of_j[best_j] == rows)
    return MatchResult(idx2=best_j.to(torch.int32), mask=ok,
                       distance=d_best.to(torch.int32))


def match_pairs(result: MatchResult):
    """(N1, 2) i32 [i, j] match pairs (row i valid iff result.mask[i])."""
    n1 = result.idx2.shape[0]
    rows = torch.arange(n1, dtype=torch.int32, device=result.idx2.device)
    return torch.stack([rows, result.idx2], dim=1)
