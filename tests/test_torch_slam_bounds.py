"""The reference's system-level bounds, held on the port alone (its own
RANSAC stream, no reference in the loop):

  * tests/test_slam.py's four cases (tracking with window BA, BA at the
    keyframe noise floor, the keyframe store and snapshot, the metrics
    summary);
  * tests/test_global_ba.py's two cases that are not marked slow;
  * tests/test_failure.py TestSensorDropout's four cases (blackout,
    constant-velocity extrapolation, relocalization on the first real
    frame, severe blur).

Each sequence runs once per module. The 12- and 8-frame cases read the
24-frame run after its 12th and 8th frame: make_trajectory draws its
steps in sequence, so those prefixes are the shorter runs' sequences.
"""
import numpy as np
import pytest
import torch
from scipy import ndimage

from vslam_tpu_torch.config import small_config
from vslam_tpu_torch.datasets import synthetic
from vslam_tpu_torch.pipeline import slam
from vslam_tpu_torch.utils import evaluate

torch.set_num_threads(2)

CFG = small_config()
K = CFG.camera.K()
W, H = CFG.camera.width, CFG.camera.height


def _kf_ate(sys_, gt):
    kf_frames = sys_.kf_store.kf_frame.numpy()
    kf_frames = np.sort(kf_frames[kf_frames >= 0])
    return evaluate.ate_rmse(sys_.keyframe_poses(),
                             gt[kf_frames].astype(np.float64))[0]


def _run(enable_ba, num_frames=24, seed=2):
    """tests/test_slam.py's scene; records what the cases read, then runs
    global BA and records its effect."""
    scene = synthetic.make_scene(num_points=700, seed=seed,
                                 extent=(14, 6, 45), z_min=6.0)
    gt = synthetic.make_trajectory(num_frames, step=0.6, yaw_rate=0.01,
                                   seed=seed)
    frames = synthetic.render_sequence(K, gt, scene, W, H)
    s = slam.SLAMSystem(CFG, "cpu", enable_ba=enable_ba)
    rec = {"infos": []}
    for i, f in enumerate(frames):
        rec["infos"].append(s.process(f))
        if i + 1 == 8:
            rec["summary8"] = s.metrics.summary()
        if i + 1 == 12:
            rec["kf12"] = s.keyframe_poses()
            rec["snap12"] = s.snapshot()
    rec["ate"] = evaluate.ate_rmse(s.poses(), gt.astype(np.float64))[0]
    rec["last_ba_stats"] = s.last_ba_stats
    rec["kf_ate"] = _kf_ate(s, gt)
    rec["global_stats"] = s.run_global_ba()
    rec["kf_ate_global"] = _kf_ate(s, gt)
    rec["coverage"] = s.last_global_ba_coverage
    return rec


@pytest.fixture(scope="module")
def with_ba():
    return _run(True)


@pytest.fixture(scope="module")
def without_ba():
    return _run(False)


# ---- tests/test_slam.py ----------------------------------------------------

def test_tracks_with_ba(with_ba):
    infos = with_ba["infos"]
    assert all(i.get("success", True) for i in infos[1:])
    assert any(i["ran_ba"] for i in infos[1:]), "window BA never ran"
    assert with_ba["ate"] < 0.5, with_ba["ate"]
    st = with_ba["last_ba_stats"]
    assert float(st.final_cost) < float(st.initial_cost)


def test_ba_improves_keyframe_trajectory(with_ba, without_ba):
    ate_ba, ate_no = with_ba["kf_ate"], without_ba["kf_ate"]
    assert ate_ba < 0.08, (ate_ba, ate_no)
    assert ate_ba < ate_no + 0.04, (ate_ba, ate_no)


def test_keyframe_store_populated(with_ba):
    assert len(with_ba["kf12"]) >= 3
    snap = with_ba["snap12"]
    assert snap["points"].shape[0] > 50
    assert snap["points"].shape[1] == 3


def test_metrics_summary(with_ba):
    s = with_ba["summary8"]
    assert s["frames"] == 8
    assert s["fps"] > 0


# ---- tests/test_global_ba.py -----------------------------------------------

def test_global_ba_improves_ate(without_ba):
    before, after = without_ba["kf_ate"], without_ba["kf_ate_global"]
    st = without_ba["global_stats"]
    assert float(st.final_cost) < float(st.initial_cost)
    assert after < before * 0.8, (before, after)
    cov = without_ba["coverage"]
    assert cov["dropped_points"] == 0 and cov["dropped_obs"] == 0, cov


def test_global_ba_no_regression_at_noise_floor(with_ba):
    before, after = with_ba["kf_ate"], with_ba["kf_ate_global"]
    st = with_ba["global_stats"]
    assert float(st.final_cost) < float(st.initial_cost)
    assert after < max(2.0 * before, 0.05), (before, after)


# ---- tests/test_failure.py TestSensorDropout -------------------------------

def _dropout_frames(n, seed):
    scene = synthetic.make_scene(num_points=600, seed=seed,
                                 extent=(14, 6, 40), z_min=6.0)
    gt = synthetic.make_trajectory(n, step=0.6, seed=seed)
    return [np.asarray(f) for f in
            synthetic.render_sequence(K, gt, scene, W, H)], gt


@pytest.fixture(scope="module")
def blackout():
    frames, gt = _dropout_frames(14, seed=5)
    for i in (6, 7, 8):
        frames[i] = np.zeros_like(frames[i])      # dead sensor
    s = slam.SLAMSystem(CFG, "cpu", seed=3)
    infos = [s.process(f) for f in frames]
    return s, infos, gt


def test_blackout_recovers(blackout):
    s, infos, _ = blackout
    assert not any(i["success"] for i in (infos[7], infos[8]))
    assert all(np.isfinite(p).all() for p in s.poses())
    assert any(i["success"] for i in infos[9:12]), infos[9:12]
    assert infos[-1]["success"]


def test_blackout_extrapolates_not_holds(blackout):
    s, _, gt = blackout
    est_pos = s.poses()[:, :3, 3]
    gt_pos = gt[:, :3, 3]
    step_pre = np.linalg.norm(est_pos[5] - est_pos[4])
    for i in (6, 7, 8):
        step = np.linalg.norm(est_pos[i] - est_pos[i - 1])
        assert step > 0.4 * step_pre, (i, step, step_pre)
    ln = lambda p: np.linalg.norm(np.diff(p, axis=0), axis=1).sum()
    scl = ln(gt_pos[:6]) / max(ln(est_pos[:6]), 1e-9)
    err_extrap = np.linalg.norm(scl * est_pos[8] - gt_pos[8])
    err_hold = np.linalg.norm(scl * est_pos[5] - gt_pos[8])
    assert err_extrap < 0.7 * err_hold, (err_extrap, err_hold)


def test_relocalization_reacquires_on_first_real_frame(blackout):
    _, infos, _ = blackout
    assert infos[9]["success"], infos[9]


def test_severe_blur_never_nan():
    frames, _ = _dropout_frames(8, seed=6)
    for i in (3, 4, 5):
        f = frames[i]
        for _ in range(3):
            f = ndimage.uniform_filter(f, size=11)
        frames[i] = f.astype(np.float32)
    s = slam.SLAMSystem(CFG, "cpu", seed=3)
    for f in frames:
        s.process(f)
    assert all(np.isfinite(p).all() for p in s.poses())
    assert np.isfinite(float(s.state.scale))
