"""Batched hypothesize-and-verify RANSAC.

Port of ``vslam_tpu/geometry/ransac.py``: ``sample_minimal_sets``, the
generic ``ransac`` and ``ransac_fundamental`` (with its weighted 8-point
polish), and ``ransac_pose`` with its two-stage verification and LO +
multistart refine. The hypothesis axis is a batch axis, as in the
reference; where the reference ``vmap``s a fit or residual function over
it, the port's functions take the batched form (see ``ransac``). Sampling
draws, with no host sync, from an explicit ``torch.Generator`` or from a
Threefry key (``utils.threefry``), which gives the reference's own
``jax.random`` samples; parity tests can also hand both sides the same
(H, S) samples through the ``*_from_samples`` entries.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch.utils._pytree import tree_map

from . import epipolar
from ..core import lie
from ..core.types import pick
from ..ops import jacobi
from ..utils import threefry
from ..utils.profiling import mark


class RansacResult(NamedTuple):
    model: object              # best model (a tensor or a tuple of them)
    inliers: torch.Tensor      # (N,) bool inlier mask of the best model
    num_inliers: torch.Tensor  # () i32
    best_score: torch.Tensor   # () f32 truncated residual sum of the best
    success: torch.Tensor      # () bool


class PoseRansacResult(NamedTuple):
    model: torch.Tensor        # (3, 3) fundamental matrix of the winner
    R: torch.Tensor            # (3, 3) rotation, x2 = R x1 + t
    t: torch.Tensor            # (3,) unit translation
    inliers: torch.Tensor      # (N,) bool — Sampson inliers in front of both
    num_inliers: torch.Tensor  # () i32
    votes: torch.Tensor        # (4,) cheirality votes of the winner
    success: torch.Tensor      # () bool


def sample_minimal_sets(gen, weights, num_hypotheses: int, sample_size: int):
    """Draw (H, S) index sets over the entries with positive weight.

    Same scheme as the reference (valid indices compacted by a stable
    argsort, then S uniform positions per hypothesis), written sync-free.
    ``gen`` is a ``torch.Generator`` (positions floor(U * n_valid) with
    U ~ uniform[0, 1)) or a Threefry key tensor (the positions the
    reference's ``jax.random.randint`` draws from that key).
    """
    valid = weights > 0
    n_valid = torch.clamp(valid.sum(), min=1)
    order = torch.argsort((~valid).to(torch.int32), stable=True)
    shape = (num_hypotheses, sample_size)
    if isinstance(gen, torch.Tensor):
        return order[threefry.randint(gen, shape, n_valid)]
    u = torch.rand(shape, generator=gen, device=weights.device)
    pos = torch.clamp((u * n_valid).long(), max=n_valid - 1)
    return order[pos]


def ransac(gen, fit_fn: Callable, residual_fn: Callable, data_fit,
           data_verify, valid_mask, num_hypotheses: int, sample_size: int,
           inlier_threshold: float, min_inliers: int = 8) -> RansacResult:
    """Generic batched hypothesize-and-verify: draws (H, S) samples from
    ``gen`` and runs ``ransac_from_samples``."""
    idx = sample_minimal_sets(gen, valid_mask.to(torch.float32),
                              num_hypotheses, sample_size)
    return ransac_from_samples(idx, fit_fn, residual_fn, data_fit,
                               data_verify, valid_mask, inlier_threshold,
                               min_inliers)


def ransac_from_samples(idx, fit_fn: Callable, residual_fn: Callable,
                        data_fit, data_verify, valid_mask,
                        inlier_threshold: float,
                        min_inliers: int = 8) -> RansacResult:
    """``ransac`` on given (H, S) minimal-sample indices.

    Args:
      fit_fn: the samples (the tensors of ``data_fit`` gathered to
        (H, S, ...)) -> H models, batched along their first axis. The
        reference's ``fit_fn`` fits one sample and is ``vmap``ped; here it
        takes the whole batch.
      residual_fn: (models, data_verify) -> (H, N) squared residuals, also
        batched over the H models.
      data_fit: a tensor or a tuple of (N, ...) tensors to sample from.
      data_verify: passed whole to ``residual_fn``.
      valid_mask: (N,) bool, which rows are real data.
      inlier_threshold: squared-residual threshold.
    Selection: the most inliers, ties broken by the lower truncated
    (MSAC) residual sum; the first such hypothesis wins.
    """
    samples = tree_map(lambda a: a[idx], data_fit)
    models = fit_fn(samples)
    resid = residual_fn(models, data_verify)
    resid = torch.where(valid_mask[None, :], resid, torch.inf)
    inlier = resid <= inlier_threshold
    counts = inlier.sum(dim=1)
    score = _truncated_sum(resid, inlier_threshold)
    combined = counts.float() - score / (score.max() + 1.0)
    best = torch.argmax(combined)
    best_inliers = pick(inlier, best) & valid_mask
    num = best_inliers.sum().to(torch.int32)
    return RansacResult(model=tree_map(lambda m: pick(m, best), models),
                        inliers=best_inliers, num_inliers=num,
                        best_score=pick(score, best),
                        success=num >= min_inliers)


def ransac_fundamental(gen, uv1, uv2, valid_mask, num_hypotheses: int = 2048,
                       inlier_threshold: float = 2.0, min_inliers: int = 15,
                       refine: bool = True) -> RansacResult:
    """RANSAC fundamental matrix over padded matches uv1, uv2 (N, 2):
    draws (H, 8) samples from ``gen`` and runs
    ``ransac_fundamental_from_samples``."""
    idx = sample_minimal_sets(gen, valid_mask.to(torch.float32),
                              num_hypotheses, 8)
    return ransac_fundamental_from_samples(
        idx, uv1, uv2, valid_mask, inlier_threshold=inlier_threshold,
        min_inliers=min_inliers, refine=refine)


def ransac_fundamental_from_samples(idx, uv1, uv2, valid_mask,
                                    inlier_threshold: float = 2.0,
                                    min_inliers: int = 15,
                                    refine: bool = True) -> RansacResult:
    """``ransac_fundamental`` on given (H, 8) samples: 8-point fits, Sampson
    verification, then (``refine``) one weighted 8-point polish on the
    inliers, kept when it holds at least as many."""
    result = ransac_from_samples(
        idx, lambda s: epipolar.fundamental_from_8pt(*s),
        lambda F, d: epipolar.sampson_error(F, *d), (uv1, uv2), (uv1, uv2),
        valid_mask, inlier_threshold, min_inliers)
    if refine:
        result = _polish_fundamental(result, uv1, uv2, valid_mask,
                                     inlier_threshold)
    return result


def _polish_fundamental(result: RansacResult, uv1, uv2, valid_mask,
                        inlier_threshold: float) -> RansacResult:
    """One weighted 8-point fit on ``result``'s inliers, kept when it holds
    at least as many (``success`` stays the unpolished verdict)."""
    F = _weighted_eight_point(uv1, uv2, result.inliers.to(uv1.dtype))
    inl = (epipolar.sampson_error(F, uv1, uv2) <= inlier_threshold) \
        & valid_mask
    better = inl.sum() >= result.num_inliers
    inl = torch.where(better, inl, result.inliers)
    return result._replace(model=torch.where(better, F, result.model),
                           inliers=inl, num_inliers=inl.sum().to(torch.int32))


def ransac_pose(gen, uv1, uv2, valid_mask, K, num_hypotheses: int = 2048,
                inlier_threshold: float = 2.0, min_inliers: int = 15,
                **kw) -> PoseRansacResult:
    """Relative-pose RANSAC (see the reference docstring): draws the
    (H, 8) samples from ``gen`` and runs ``ransac_pose_from_samples``."""
    idx = sample_minimal_sets(gen, valid_mask.to(torch.float32),
                              num_hypotheses, 8)
    return ransac_pose_from_samples(idx, uv1, uv2, valid_mask, K,
                                    inlier_threshold=inlier_threshold,
                                    min_inliers=min_inliers, **kw)


def ransac_pose_from_samples(idx, uv1, uv2, valid_mask, K,
                             inlier_threshold: float = 2.0,
                             min_inliers: int = 15, refine: bool = True,
                             fit_sweeps: int = 4, vote_stride: int = 6,
                             verify_stride: int = 4, topk: int = 16,
                             refine_iters: int = 10) -> PoseRansacResult:
    """``ransac_pose`` on given (H, 8) minimal-sample indices. Its stages
    are ``utils.profiling.mark``ed: ``ransac.fit``, ``ransac.stage1``,
    ``ransac.stage2`` and ``ransac.refine``."""
    mark("ransac.fit")
    Fs = epipolar.fundamental_from_8pt(uv1[idx], uv2[idx], sweeps=fit_sweeps)
    mark("ransac.stage1")
    combined_v, Rs, ts = _pose_stage1(Fs, uv1, uv2, valid_mask, K,
                                      inlier_threshold, verify_stride,
                                      vote_stride)
    mark("ransac.stage2")
    # stage 2: full-N re-scoring of the top-k leaders. A stable descending
    # sort keeps the lower index first among ties, as jax.lax.top_k does.
    k = min(int(topk), idx.shape[0])
    lead = torch.sort(combined_v, descending=True, stable=True)[1][:k]
    F, R, t, best_votes, inl, num = _pose_stage2(
        Fs[lead], Rs[lead], ts[lead], uv1, uv2, valid_mask, K,
        inlier_threshold)
    if refine:
        mark("ransac.refine")
        F, R, t, inl, num = _pose_refine(R, t, inl, uv1, uv2, valid_mask, K,
                                         inlier_threshold, refine_iters)
    return PoseRansacResult(model=F, R=R, t=t, inliers=inl, num_inliers=num,
                            votes=best_votes, success=num >= min_inliers)


def _truncated_sum(resid, thr):
    trunc = torch.clamp(resid, max=thr)
    trunc = torch.where(torch.isfinite(trunc), trunc, 0.0)
    return trunc.sum(dim=-1)


def _pose_stage1(Fs, uv1, uv2, valid_mask, K, inlier_threshold,
                 verify_stride, vote_stride, score_norm_fn=None):
    """Subset scoring of a batch of F hypotheses.
    Returns (combined (H,) selection score, Rs (H,4,3,3), ts (H,4,3)).
    ``score_norm_fn`` reduces the local ``score.max()`` normalizer: the
    hypothesis-sharded caller passes a ``pmax`` so every rank's scores
    share the global normalizer."""
    sv = max(int(verify_stride), 1)
    uv1v, uv2v = uv1[::sv], uv2[::sv]
    maskv = valid_mask[::sv]
    resid_v = epipolar.sampson_error(Fs, uv1v, uv2v)
    resid_v = torch.where(maskv[None, :], resid_v, torch.inf)
    samp_v = resid_v <= inlier_threshold

    Es = torch.einsum("ji,hjk,kl->hil", K, Fs, K)
    Rs, ts = epipolar.decompose_essential(Es)
    vs = max(round(int(vote_stride) / sv), 1)
    z1, z2 = epipolar.triangulate_midpoint_depths(K, Rs, ts, uv1v[::vs],
                                                  uv2v[::vs])
    good = samp_v[:, None, ::vs] & (z1 > 0) & (z2 > 0)
    counts_v = good.sum(dim=2).amax(dim=1)

    score_v = _truncated_sum(resid_v, inlier_threshold)
    norm = score_v.max()
    if score_norm_fn is not None:
        norm = score_norm_fn(norm)
    combined_v = counts_v.float() - score_v / (norm + 1.0)
    return combined_v, Rs, ts


def _pose_stage2_rank(Fk, Rk, tk, uv1, uv2, valid_mask, K, inlier_threshold):
    """The per-match half of stage 2 over (a slice of) the match axis:
    per-leader cheirality votes (k, 4) and truncated-residual scores (k,),
    sums over matches that a match-sharded caller ``psum``s."""
    resid_k = epipolar.sampson_error(Fk, uv1, uv2)
    resid_k = torch.where(valid_mask[None, :], resid_k, torch.inf)
    samp_k = resid_k <= inlier_threshold
    z1k, z2k = epipolar.triangulate_midpoint_depths(K, Rk, tk, uv1, uv2)
    votes_k = (samp_k[:, None, :] & (z1k > 0) & (z2k > 0)).sum(dim=2)
    return votes_k, _truncated_sum(resid_k, inlier_threshold)


def _pose_stage2_select(Fk, Rk, tk, votes_k, score_k, uv1, uv2, valid_mask,
                        K, inlier_threshold):
    """Winner selection from full-N votes and scores, and the winner's
    exact inlier mask. Returns (F, R, t, votes (4,), inliers (N,), num ())."""
    counts_k = votes_k.amax(dim=1)
    cand_k = votes_k.argmax(dim=1)
    combined_k = counts_k.float() - score_k / (score_k.max() + 1.0)
    bk = torch.argmax(combined_k)

    F = pick(Fk, bk)
    cand = pick(cand_k, bk)
    R = pick(pick(Rk, bk), cand)
    t = pick(pick(tk, bk), cand)
    resid = epipolar.sampson_error(F[None], uv1, uv2)[0]
    samp = (resid <= inlier_threshold) & valid_mask
    z1, z2 = epipolar.triangulate_midpoint_depths(K, R, t, uv1, uv2)
    inl = samp & (z1 > 0) & (z2 > 0)
    return F, R, t, pick(votes_k, bk), inl, inl.sum().to(torch.int32)


def _pose_stage2(Fk, Rk, tk, uv1, uv2, valid_mask, K, inlier_threshold):
    """Full-N re-scoring of the k leader hypotheses; exact winner pick."""
    votes_k, score_k = _pose_stage2_rank(Fk, Rk, tk, uv1, uv2, valid_mask, K,
                                         inlier_threshold)
    return _pose_stage2_select(Fk, Rk, tk, votes_k, score_k, uv1, uv2,
                               valid_mask, K, inlier_threshold)


def _pose_refine(R, t, inl, uv1, uv2, valid_mask, K, inlier_threshold,
                 refine_iters):
    """LO (weighted 8-point on the consensus, its 4 decompositions join the
    fan) + multistart robust polish of the RANSAC winner."""
    w = inl.to(uv1.dtype)
    F2 = _weighted_eight_point(uv1, uv2, w, sweeps=6)
    R4, t4 = epipolar.decompose_essential(K.T @ F2 @ K)
    R, t = epipolar.refine_pose_gn_multistart(
        R, t, K, uv1, uv2, valid_mask.to(uv1.dtype), iters=refine_iters,
        extra_starts=(R4, t4))
    K_inv = torch.linalg.inv_ex(K)[0]
    F = K_inv.T @ (lie.hat(t) @ R) @ K_inv
    F = F / (torch.linalg.vector_norm(F) + 1e-12)
    s3 = (epipolar.sampson_error(F, uv1, uv2) <= inlier_threshold) \
        & valid_mask
    z1g, z2g = epipolar.triangulate_midpoint_depths(K, R, t, uv1, uv2)
    inl = s3 & (z1g > 0) & (z2g > 0)
    return F, R, t, inl, inl.sum().to(torch.int32)


def _weighted_eight_point(uv1, uv2, w, sweeps: int = 10):
    """Weighted least-squares F over all (masked) correspondences."""
    mask = w > 0
    n1, T1 = epipolar.hartley_normalize(uv1, mask)
    n2, T2 = epipolar.hartley_normalize(uv2, mask)
    A = epipolar._constraint_rows(n1, n2) * w[:, None]
    F = jacobi.null_vector(A, sweeps=sweeps).reshape(3, 3)
    F = jacobi.rank2_project(F, sweeps=8)
    F = T2.T @ F @ T1
    return F / (torch.linalg.vector_norm(F) + 1e-12)
