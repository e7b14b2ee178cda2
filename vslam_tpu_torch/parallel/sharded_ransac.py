"""RANSAC with the hypothesis axis sharded across a device mesh.

Port of ``vslam_tpu/parallel/sharded_ransac.py``. Every rank fits and
scores its slice of one hypothesis batch, then a cross-rank arg-best over
the gathered leaders selects the winner; matches and masks are replicated.
Every rank draws the same GLOBAL (H, 8) batch from an identically seeded
generator and slices its share (the counterpart of the reference's split or
shared keys: independent samples per rank, one stream, no host sync on a
CUDA generator); the ``*_from_samples`` entries take that global batch, so
tests can inject the reference's samples.
"""
from __future__ import annotations

import torch

from ..core.types import pick
from ..geometry import epipolar
from ..geometry import ransac
from ..geometry.ransac import PoseRansacResult, RansacResult
from .mesh import all_gather, axis_index, axis_size, pmax, psum, shard_leading

# Stage-2 leader count of ransac_pose_hypsharded, shared with the gate in
# sharded_tracker.run_sharded: selection parity needs every rank's H/D
# hypotheses to hold at least this many leaders.
POSE_TOPK = 16


def _sample(gen, valid_mask, num_hypotheses):
    return ransac.sample_minimal_sets(gen, valid_mask.to(torch.float32),
                                      num_hypotheses, 8)


def ransac_fundamental_sharded(mesh, axis, gen, uv1, uv2, valid_mask,
                               num_hypotheses: int = 2048,
                               inlier_threshold: float = 2.0,
                               min_inliers: int = 15) -> RansacResult:
    """Fundamental-matrix RANSAC with ``num_hypotheses`` (the global count)
    split evenly over ``axis``; outputs are replicated."""
    return ransac_fundamental_sharded_from_samples(
        mesh, axis, _sample(gen, valid_mask, num_hypotheses), uv1, uv2,
        valid_mask, inlier_threshold, min_inliers)


def ransac_fundamental_sharded_from_samples(
        mesh, axis, idx, uv1, uv2, valid_mask, inlier_threshold: float = 2.0,
        min_inliers: int = 15) -> RansacResult:
    """``ransac_fundamental_sharded`` on a given global (H, 8) batch: each
    rank's best of its slice, the gathered (count, score, model) arg-best,
    then the winner's inliers and one weighted 8-point polish, replicated."""
    res = ransac.ransac_fundamental_from_samples(
        shard_leading(mesh, axis, idx), uv1, uv2, valid_mask,
        inlier_threshold=inlier_threshold, min_inliers=min_inliers,
        refine=False)
    rows = all_gather(mesh, axis, torch.cat([
        res.num_inliers.to(torch.float32)[None], res.best_score[None],
        res.model.reshape(9)]))                              # (D, 11)
    counts, scores = rows[:, 0], rows[:, 1]
    best = torch.argmax(counts - scores / (scores.max() + 1.0))
    F = pick(rows[:, 2:].reshape(-1, 3, 3), best)
    inl = (epipolar.sampson_error(F, uv1, uv2) <= inlier_threshold) \
        & valid_mask
    num = inl.sum().to(torch.int32)
    return ransac._polish_fundamental(
        RansacResult(model=F, inliers=inl, num_inliers=num,
                     best_score=pick(scores, best),
                     success=num >= min_inliers),
        uv1, uv2, valid_mask, inlier_threshold)


def ransac_pose_hypsharded(mesh, axis, gen, uv1, uv2, valid_mask, K,
                           num_hypotheses: int = 2048,
                           **kw) -> PoseRansacResult:
    """``geometry.ransac.ransac_pose`` with the hypothesis axis split over
    ``axis``: draws the global (H, 8) batch from ``gen`` and runs
    ``ransac_pose_hypsharded_from_samples``."""
    return ransac_pose_hypsharded_from_samples(
        mesh, axis, _sample(gen, valid_mask, num_hypotheses), uv1, uv2,
        valid_mask, K, **kw)


def ransac_pose_hypsharded_from_samples(
        mesh, axis, idx, uv1, uv2, valid_mask, K,
        inlier_threshold: float = 2.0, min_inliers: int = 15,
        fit_sweeps: int = 4, vote_stride: int = 6, verify_stride: int = 4,
        topk: int = POSE_TOPK, refine_iters: int = 10) -> PoseRansacResult:
    """Stage 1 (8-point fits, subset scores and cheirality votes, the
    dominant tracking stage) on this rank's H/D slice of the global batch,
    normalized by the global score maximum (``pmax``); each rank's top-k
    leaders are gathered and re-ranked by (score descending, global index
    ascending), the order one stable sort over the whole batch gives, so
    the union of local top-k holds the global top-k in the single-device
    order. Stage 2's ranking sums run on this rank's N/D match slice and
    are ``psum``med when N divides; selection and refine are replicated.
    """
    D, me = axis_size(mesh, axis), axis_index(mesh, axis)
    H = idx.shape[0]
    if H % D or H // D < topk:
        raise ValueError(f"{H} hypotheses over {D} ranks: each rank needs "
                         f"an equal share of at least topk={topk}")
    Hl = H // D
    idx_l = idx[me * Hl:(me + 1) * Hl]
    Fs = epipolar.fundamental_from_8pt(uv1[idx_l], uv2[idx_l],
                                       sweeps=fit_sweeps)
    cv, Rs, ts = ransac._pose_stage1(
        Fs, uv1, uv2, valid_mask, K, inlier_threshold, verify_stride,
        vote_stride, score_norm_fn=lambda m: pmax(mesh, axis, m))

    # local leaders: a stable descending sort keeps the lower index first
    # among ties, as jax.lax.top_k does
    k = int(topk)
    sc_l, lead_l = torch.sort(cv, descending=True, stable=True)
    sc_l, lead_l = sc_l[:k], lead_l[:k]
    # one gather of every rank's k leaders: score, global id (exact in
    # f32 below 2^24), F, the 4 (R, t) candidates
    rows = all_gather(mesh, axis, torch.cat([
        sc_l[:, None], (me * Hl + lead_l)[:, None].to(torch.float32),
        Fs[lead_l].reshape(k, 9), Rs[lead_l].reshape(k, 36),
        ts[lead_l].reshape(k, 12)], dim=1)).reshape(D * k, 59)
    # lexsort((gid, -score)): global id ascending, then a stable sort on
    # score descending
    order = torch.sort(rows[:, 1], stable=True).indices
    order = order[torch.sort(rows[order, 0], descending=True,
                             stable=True).indices]
    sel = rows[order[:k]]
    Fk = sel[:, 2:11].reshape(k, 3, 3)
    Rk = sel[:, 11:47].reshape(k, 4, 3, 3)
    tk = sel[:, 47:59].reshape(k, 4, 3)

    N = uv1.shape[0]
    if N % D == 0:
        s = slice(me * (N // D), (me + 1) * (N // D))
        votes_k, score_k = ransac._pose_stage2_rank(
            Fk, Rk, tk, uv1[s], uv2[s], valid_mask[s], K, inlier_threshold)
        votes_k = psum(mesh, axis, votes_k)
        score_k = psum(mesh, axis, score_k)
    else:
        votes_k, score_k = ransac._pose_stage2_rank(
            Fk, Rk, tk, uv1, uv2, valid_mask, K, inlier_threshold)
    F, R, t, best_votes, inl, num = ransac._pose_stage2_select(
        Fk, Rk, tk, votes_k, score_k, uv1, uv2, valid_mask, K,
        inlier_threshold)
    F, R, t, inl, num = ransac._pose_refine(R, t, inl, uv1, uv2, valid_mask,
                                            K, inlier_threshold,
                                            refine_iters)
    return PoseRansacResult(model=F, R=R, t=t, inliers=inl, num_inliers=num,
                            votes=best_votes, success=num >= min_inliers)
