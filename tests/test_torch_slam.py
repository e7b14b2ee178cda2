"""The port's SLAM system (vslam_tpu_torch.pipeline.slam) against the
reference SLAMSystem, and the window-BA guards on hand-built windows.

Parity: tests/test_slam.py's 24-frame scene with window BA through both
systems, the port's RANSAC fed the reference's own samples (the two
frameworks' random streams differ by construction). Per frame the
keyframe / BA / maintenance decisions are equal (inlier counts and map
sizes within +-2, as in the tracking step's parity), and so is every BA
event's outcome (skipped and why, or solved and accepted or not). Poses
agree to 1e-3 up to the first accepted BA event: the tracking step's f32
tolerance (tests/test_torch_tracker.py). After it, to 5e-3: the event's
write-back re-anchors the pose chain by a correction computed from an LM
solve whose last digits differ (the port's solver agrees to ~1e-5 per
pose, tests/test_torch_ba.py), and tracking carries that difference on.
The keyframe ATEs agree to 0.01. The chunked driver (``process_chunk``)
is held to the same reference run with the same tolerances.

``structure_every=2`` runs the structure-only refinement and its write-
back on the system path; promoted counts are equal and costs agree to
1e-4 relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import test_guards as jguards
from tests.test_slam import CFG as JCFG
from tests.test_slam import K, H, W
from tests.test_torch_tracker import _reference_samples
from vslam_tpu.datasets import synthetic
from vslam_tpu.pipeline import slam as jslam
from vslam_tpu.utils import evaluate as jeval
from vslam_tpu_torch import interop
from vslam_tpu_torch.config import small_config
from vslam_tpu_torch.optimizer.ba import BAProblem
from vslam_tpu_torch.pipeline import keyframes, slam, tracker

torch.set_num_threads(2)

CFG = small_config()
FLAGS = ("keyframe", "ran_ba", "ran_maintenance", "success")


def _frames(n, seed=2):
    scene = synthetic.make_scene(num_points=700, seed=seed,
                                 extent=(14, 6, 45), z_min=6.0)
    poses = synthetic.make_trajectory(n, step=0.6, yaw_rate=0.01, seed=seed)
    return synthetic.render_sequence(K, poses, scene, W, H), poses


def _injected_step(state, img, cfg, mesh=None, map_axis="map"):
    """track_step with the reference's RANSAC samples for this frame."""
    assert mesh is None
    ops = tracker.default_map_ops(cfg, cfg.camera.width, cfg.camera.height)
    return tracker._step_impl(state, img, cfg, ops,
                              pose_fn=_reference_samples(
                                  int(state.frame_idx)))


def _kf_ate(sys_, gt):
    kf_frames = sys_.kf_store.kf_frame
    kf_frames = (kf_frames.numpy() if isinstance(kf_frames, torch.Tensor)
                 else np.asarray(kf_frames))
    kf_frames = np.sort(kf_frames[kf_frames >= 0])
    return jeval.ate_rmse(sys_.keyframe_poses(),
                          gt[kf_frames].astype(np.float64))[0]


def _both(n, jcfg, tcfg):
    frames, gt = _frames(n)
    ref = jslam.SLAMSystem(jcfg, enable_ba=True)
    port = slam.SLAMSystem(tcfg, "cpu", enable_ba=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(slam.tracker, "track_step", _injected_step)
        infos = [(ref.process(f), port.process(f)) for f in frames]
    return ref, port, infos, gt


def _events(sys_, kind):
    return [r for r in sys_.metrics.records if r.get("kind") == kind]


@pytest.fixture(scope="module")
def parity():
    return _both(24, JCFG, CFG)


def test_decisions_match_reference_per_frame(parity):
    _, _, infos, _ = parity
    for i, (a, b) in enumerate(infos[1:], 1):
        for f in FLAGS:
            assert a[f] == b[f], (i, f, a[f], b[f])
        # counts over thresholds, as in the tracking step's parity
        for f in ("num_inliers", "map_size"):
            assert abs(a[f] - b[f]) <= 2, (i, f, a[f], b[f])
    assert any(a["ran_ba"] for a, _ in infos[1:])


def test_ba_events_match_reference(parity):
    ref, port, _, _ = parity
    ej, et = _events(ref, "ba"), _events(port, "ba")
    assert [e["frame"] for e in ej] == [e["frame"] for e in et]
    for a, b in zip(ej, et):
        assert a.get("skipped") == b.get("skipped"), (a, b)
        assert a["ba_result_accepted"] == b["ba_result_accepted"], (a, b)
        if "skipped" in a:
            key = "deep_obs" if a["skipped"] == "shallow" else "n_obs"
            assert a[key] == b[key], (a, b)
        else:
            np.testing.assert_allclose(b["initial_cost"], a["initial_cost"],
                                       rtol=1e-4)
            np.testing.assert_allclose(b["final_cost"], a["final_cost"],
                                       rtol=1e-3)
            for k in ("dropped_points", "dropped_obs", "evicted_keyframes"):
                assert a[k] == b[k], (k, a, b)
    # premise: the run has a skipped event and an accepted one
    assert any("skipped" in e for e in ej)
    assert any(e["ba_result_accepted"] for e in ej)


def test_poses_match_reference(parity):
    ref, port, infos, gt = parity
    first = min(e["frame"] for e in _events(ref, "ba")
                if e["ba_result_accepted"])
    pj, pt = ref.poses(), port.poses()
    err = np.abs(pj - pt).max(axis=(1, 2))
    assert err[:first + 1].max() <= 1e-3, err
    assert err.max() <= 5e-3, err
    assert abs(_kf_ate(ref, gt) - _kf_ate(port, gt)) < 0.01
    np.testing.assert_allclose(port.keyframe_poses(), ref.keyframe_poses(),
                               atol=5e-3)


def test_structure_refinement_matches_reference():
    jcfg = JCFG.replace(ba=dataclasses.replace(JCFG.ba, structure_every=2))
    tcfg = CFG.replace(ba=dataclasses.replace(CFG.ba, structure_every=2))
    ref, port, infos, _ = _both(14, jcfg, tcfg)
    for i, (a, b) in enumerate(infos[1:], 1):
        for f in FLAGS:
            assert a[f] == b[f], (i, f)
    sj, st = _events(ref, "structure_refine"), _events(port, "structure_refine")
    assert [e["frame"] for e in sj] == [e["frame"] for e in st]
    assert len(sj) >= 2
    for a, b in zip(sj, st):
        assert a["promoted"] == b["promoted"], (a, b)
        np.testing.assert_allclose(b["initial_cost"], a["initial_cost"],
                                   rtol=1e-4)
        np.testing.assert_allclose(b["final_cost"], a["final_cost"],
                                   rtol=1e-4)
    assert sum(e["promoted"] for e in sj) > 0     # premise
    np.testing.assert_allclose(port.poses(), ref.poses(), atol=1e-3)


# ---- tests/test_guards.py (a), (b), (d) on the port's static methods ------

def _pwp(wp):
    """A reference WindowProblem (tests/test_guards.py builds them) as
    the port's."""
    t = lambda a: torch.from_numpy(np.array(a))
    return keyframes.WindowProblem(
        problem=_pproblem(wp.problem),
        **{f: t(getattr(wp, f)) for f in keyframes.WindowProblem._fields
           if f != "problem"})


def _pproblem(p):
    return interop.from_jax(jax.tree_util.tree_map(np.asarray, p), BAProblem)


def _rewired_anchor_only(wp):
    obs_cam = np.asarray(wp.problem.obs_cam).copy()
    obs_cam[-16:, 0] = 0
    obs_cam[-16:, 1] = 1
    return wp._replace(problem=wp.problem.replace(
        obs_cam=jnp.asarray(obs_cam)))


GAUGE_CASES = {
    "engages-on-starved-bridge": (5, 1.5, False),
    "noop-on-healthy-bridge": (40, 1.5, False),
    "noop-inside-engage-band": (5, 1.01, False),
    "anchored-only-landmarks-not-rescaled": (5, 1.5, True),
}


@pytest.mark.parametrize("case", list(GAUGE_CASES))
def test_gauge_pinning(case):
    bridge, s_true, rewire = GAUGE_CASES[case]
    wp = jguards._window(bridge_obs=bridge)
    if rewire:
        wp = _rewired_anchor_only(wp)
    solved, _ = jguards._scaled_solution(wp, s_true)
    out, s = slam.SLAMSystem._pin_window_gauge(_pwp(wp), _pproblem(solved))
    assert out.T_cw.dtype == torch.float32 == out.points.dtype
    if case == "engages-on-starved-bridge":
        assert abs(s - 1.5) < 0.05, s
        np.testing.assert_allclose(out.T_cw.numpy(),
                                   np.asarray(wp.problem.T_cw), atol=1e-4)
        np.testing.assert_allclose(out.points.numpy(),
                                   np.asarray(wp.problem.points), atol=1e-3)
    elif case == "noop-on-healthy-bridge":
        assert s == 1.0
        np.testing.assert_array_equal(out.T_cw.numpy(),
                                      np.asarray(solved.T_cw))
    elif case == "noop-inside-engage-band":
        np.testing.assert_array_equal(out.T_cw.numpy(),
                                      np.asarray(solved.T_cw))
    else:
        assert abs(s - 1.5) < 0.05, s
        np.testing.assert_array_equal(out.points.numpy()[-16:],
                                      np.asarray(solved.points)[-16:])
        assert not np.allclose(out.points.numpy()[:5],
                               np.asarray(solved.points)[:5])
    # the same answer as the reference's guard
    want, s_ref = jslam.SLAMSystem._pin_window_gauge(wp, solved)
    assert s == s_ref
    np.testing.assert_allclose(out.T_cw.numpy(), np.asarray(want.T_cw),
                               atol=1e-6)
    np.testing.assert_allclose(out.points.numpy(), np.asarray(want.points),
                               atol=1e-5)


@pytest.mark.parametrize("case", ["fires-on-near-empty-window",
                                  "quiet-on-healthy-window"])
def test_starvation_skip(case):
    wp = jguards._window(n_pts=64)
    if case == "fires-on-near-empty-window":
        mask = np.zeros_like(np.asarray(wp.problem.obs_mask))
        mask[:5, :2] = True
        wp = wp._replace(problem=wp.problem.replace(
            obs_mask=jnp.asarray(mask)))
    starved, n_obs, n_free = slam.SLAMSystem._window_starved(_pwp(wp))
    if case == "fires-on-near-empty-window":
        assert starved and n_obs == 10 and n_free == 2
    else:
        assert not starved and n_obs == 128
    # the pre-solve gate statistics _run_window_ba reads agree
    pwp = _pwp(wp)
    n_obs2, n_free2, _, _ = (int(x) for x in slam._window_gate_stats(
        pwp.problem, pwp.sel_prov))
    assert (n_obs2, n_free2) == (n_obs, n_free)


@pytest.mark.parametrize("move,ok", [(0.6, False), (0.3, True)])
def test_ba_event_trust_region(move, ok):
    wp = jguards._window()                    # baselines = 1.0
    T = np.asarray(wp.problem.T_cw).copy()
    T[-1, 2, 3] -= move
    solved = wp.problem.replace(T_cw=jnp.asarray(T))
    got, max_move, baseline = slam.SLAMSystem._ba_event_accepted(
        _pwp(wp), _pproblem(solved))
    assert got == ok
    if not ok:
        assert abs(max_move - 0.6) < 1e-5 and baseline == 1.0


# ---- the chunked driver against the reference's per-frame driver ---------

def test_chunk_matches_reference_per_frame(parity):
    """The port's ``process_chunk`` with the reference's RANSAC samples
    injected, in chunks aligned to keyframe_every * local_ba_every, against
    the reference's per-frame run of ``parity``: the same decisions and BA
    events, inlier counts and map sizes within +-2, poses to 1e-3 up to the
    first accepted BA event and 5e-3 after (tests/test_torch_scan_driver.py
    holds the chunk to the port's own per-frame driver exactly)."""
    from tests import test_torch_scan_driver as chunk

    ref = parity[0]
    frames, _ = _frames(24)
    align = CFG.pipeline.keyframe_every * CFG.pipeline.local_ba_every
    port = chunk._injected_chunk(CFG, frames, (align + 1,) + (align,) * 4
                                 + (3,), True)
    chunk.assert_chunk_matches_reference(ref, port)
    assert any(e["ba_result_accepted"] for e in port["ba"])      # premise
