"""The slice: the port's bootstrap + track_step against the reference tracker.

Parity: 8 rendered frames through both trackers, with the port's RANSAC
fed the reference's own samples, ``sample_minimal_sets(fold_in(
PRNGKey(0), frame_idx), mask)`` (the two frameworks' random streams
differ by construction). Per frame:
  * the frame-to-frame match (idx2 and mask) is exact: it depends only on
    the images, and descriptors and masks are exact (test_torch_frontend);
  * the pose to 1e-3 max-abs: both sides run the same solvers, whose f32
    rounding (sums in another order) compounds along the pose chain;
  * num_inliers and map_size within +-2: counts over thresholds (Sampson
    2 px, parallax, reprojection) flip for the few samples that sit on one
    when the pose differs in its last bits.

Bounds: without injection, the port alone passes tests/test_tracker.py's
three cases (every frame succeeds, ATE < 0.15, the map-reuse bounds).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vslam_tpu.config import small_config
from vslam_tpu.datasets import synthetic
from vslam_tpu.frontend.frame import extract_features as jextract
from vslam_tpu.geometry import ransac as jransac
from vslam_tpu.matching import matcher as jmatcher
from vslam_tpu.pipeline import tracker as jtracker
from vslam_tpu_torch.frontend.frame import extract_features
from vslam_tpu_torch.geometry import ransac
from vslam_tpu_torch.matching import matcher
from vslam_tpu_torch.pipeline import tracker
from vslam_tpu_torch.utils import evaluate

torch.set_num_threads(2)

CFG = small_config()
K = CFG.camera.K()
W, H = CFG.camera.width, CFG.camera.height


def _sequence(num_frames, step=0.6, n_points=600, seed=0):
    scene = synthetic.make_scene(num_points=n_points, seed=seed,
                                 extent=(14, 6, 40), z_min=6.0)
    poses = synthetic.make_trajectory(num_frames, step=step, seed=seed)
    return synthetic.render_sequence(K, poses, scene, W, H), poses


def _reference_samples(frame_idx):
    """pose_fn for the port that draws the reference's own RANSAC samples
    (tracker key = fold_in(PRNGKey(0), frame_idx), the port's match mask)."""
    key = jax.random.fold_in(jax.random.PRNGKey(0), frame_idx)

    def pose_fn(gen, uv1, uv2, mask, Km, num_hypotheses, inlier_threshold,
                min_inliers):
        idx = jransac.sample_minimal_sets(
            key, jnp.asarray(mask.numpy(), jnp.float32), num_hypotheses, 8)
        return ransac.ransac_pose_from_samples(
            torch.tensor(np.asarray(idx)).long(), uv1, uv2, mask, Km,
            inlier_threshold=inlier_threshold, min_inliers=min_inliers)
    return pose_fn


def test_slice_parity_with_injected_samples():
    frames, _ = _sequence(8)
    sj = jtracker.bootstrap(jnp.asarray(frames[0]), CFG)
    st = tracker.bootstrap(frames[0], CFG, "cpu")
    ops = tracker.default_map_ops(CFG, W, H)
    for i in range(1, len(frames)):
        fi = int(sj.frame_idx)
        assert fi == int(st.frame_idx) == i
        # the step's match, from each side's own state
        fj = jextract(jnp.asarray(frames[i]), CFG.frontend, H, W)
        mj = jmatcher.match(sj.prev.desc, sj.prev.mask, fj.desc, fj.mask,
                            CFG.matching, uv1=sj.prev.uv, uv2=fj.uv)
        ft = extract_features(torch.from_numpy(frames[i]), CFG.frontend,
                              H, W)
        mt = matcher.match(st.prev.desc, st.prev.mask, ft.desc, ft.mask,
                           CFG.matching, uv1=st.prev.uv, uv2=ft.uv)
        mask = np.asarray(mj.mask)
        np.testing.assert_array_equal(mt.mask.numpy(), mask)
        np.testing.assert_array_equal(mt.idx2.numpy()[mask],
                                      np.asarray(mj.idx2)[mask])

        sj, oj = jtracker.track_step(sj, jnp.asarray(frames[i]), CFG)
        st, ot = tracker._step_impl(st, frames[i], CFG, ops,
                                    pose_fn=_reference_samples(fi))
        assert bool(ot.success) == bool(oj.success)
        np.testing.assert_allclose(ot.pose.numpy(), np.asarray(oj.pose),
                                   atol=1e-3, err_msg=f"frame {i}")
        assert abs(int(ot.num_inliers) - int(oj.num_inliers)) <= 2, i
        assert abs(int(ot.map_size) - int(oj.map_size)) <= 2, i
    assert int(oj.map_size) > 40


def _track(num_frames, seed=0):
    frames, poses = _sequence(num_frames, seed=seed)
    st = tracker.bootstrap(frames[0], CFG, "cpu")
    outs, est = [], [np.eye(4, dtype=np.float32)]
    for i in range(1, num_frames):
        st, out = tracker.track_step(st, frames[i], CFG)
        outs.append(out)
        est.append(out.pose.numpy())
    return np.stack(est), poses, outs, st


@pytest.mark.parametrize("seed", [0, 1])
def test_port_tracks_sequence_within_reference_bounds(seed):
    """tests/test_tracker.py's bounds, on the port alone (its own RANSAC
    stream): every frame succeeds, ATE < 0.15 over 8 frames, and the map
    grows past 40 points while re-using points, scale staying in (0.5, 2)."""
    est, gt, outs, st = _track(8, seed)
    assert all(bool(o.success) for o in outs)
    assert int(outs[0].num_inliers) > 30
    assert int(st.pend_valid.sum()) > 30
    rmse, _, _ = evaluate.ate_rmse(est, gt.astype(np.float64))
    assert rmse < 0.15, rmse
    sizes = [int(o.map_size) for o in outs[:5]]
    assert sizes[-1] > 40, sizes
    assert sizes[-1] < sum(int(o.num_matches) for o in outs[:5])
    scales = [float(o.scale) for o in outs[:5]]
    assert all(0.5 < s < 2.0 for s in scales[1:]), scales
