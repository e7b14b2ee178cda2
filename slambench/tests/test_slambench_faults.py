"""A whole run at a small size on the CPU (the harness's look for a card
skipped), with the program's timed path broken underneath: ``correct``
comes out false for each fault a cell of this benchmark can have, and
true without one. A cell runs on one card, so there is no exchange
between cards to leave out. The step's faults run on the drive with window
BA off; window BA's on a small handheld revisit whose events solve."""
import dataclasses
import json
import os

import torch

from slambench import run as srun
from slambench.reference import check
from vslam_tpu_torch.config import small_config
from vslam_tpu_torch.optimizer import ba
from vslam_tpu_torch.pipeline import keyframes, scan_driver, tracker

HERE = os.path.dirname(os.path.abspath(__file__))


def _traffic(name):
    with open(os.path.join(HERE, "..", "traffic", f"{name}.json")) as f:
        return json.load(f)


def _small(enable_ba=False):
    """The drive at the small configuration (its window-BA events, every
    25th frame, do not solve)."""
    cfg = dataclasses.asdict(small_config())
    cfg["pipeline"].update(keyframe_every=5, local_ba_every=5)
    tr = _traffic("drive")
    tr.update(step_m=0.6, landmarks_per_frame=100, lateral_m=14.0,
              warmup_frames=4, warmup_max_frames=4, ceiling_frames_per_s=6,
              check_frames=2, check_within_frames_per_s=1,
              enable_ba=enable_ba)
    return {"vslam": cfg}, tr


def _small_ba():
    """A handheld revisit at the small configuration with a window-BA event
    every 6th frame: the warm-up ends after the first that solves (frame
    30), and the window's first (frame 36) solves too."""
    cfg = dataclasses.asdict(small_config())
    cfg["pipeline"].update(keyframe_every=2, local_ba_every=3)
    tr = _traffic("xyz")
    tr.update(landmarks=300, speed_m_s=0.5, warmup_frames=4,
              warmup_max_frames=40, ceiling_frames_per_s=8, check_frames=2,
              check_within_frames_per_s=1)
    return {"vslam": cfg}, tr


def _correct(small=_small, seed=2 ** 31 + 3, seconds=3.0, cell=None):
    torch.set_num_threads(4)
    man = srun.manifest()
    cell = srun.cell_of(man, cell or "kitti00_mono.drive")
    cfg_doc, tr = small()
    result, rows, info, _ = srun.run_cell(man, cell, seed, seconds, False,
                                          device="cpu", cfg_doc=cfg_doc,
                                          tr=tr)
    assert info["frames_checked"] >= 1
    return result["correct"], dict((k, v) for k, v, _ in rows), info


def _correct_ba():
    return _correct(_small_ba, 7, 6.0, "tum_fr1_mono.xyz")


def test_sound_run_is_correct():
    ok, rows, _ = _correct()
    assert ok, rows


def test_step_that_returns_its_state_unchanged(monkeypatch):
    real = scan_driver.track_frame

    def unchanged(state, *a, **k):
        _, out, row = real(state, *a, **k)
        return state, out, row
    monkeypatch.setattr(scan_driver, "track_frame", unchanged)
    ok, rows, _ = _correct()
    assert not ok, rows


def test_half_the_keypoints_left_out(monkeypatch):
    real = tracker.extract_features

    def half(*a, **k):
        f = real(*a, **k)
        keep = torch.arange(f.mask.shape[0], device=f.mask.device) \
            < f.mask.shape[0] // 2
        return f.replace(mask=f.mask & keep)
    monkeypatch.setattr(tracker, "extract_features", half)
    ok, rows, _ = _correct()
    assert not ok, rows


def test_pose_altered_where_it_is_produced(monkeypatch):
    real = scan_driver.track_frame

    def altered(*a, **k):
        state, out, row = real(*a, **k)
        pose = state.pose.clone()
        pose[0, 3] += 1e-2
        return state.replace(pose=pose), out, row
    monkeypatch.setattr(scan_driver, "track_frame", altered)
    ok, rows, _ = _correct()
    assert not ok, rows


def test_ba_cell_without_a_solved_event_is_not_correct():
    # window BA on, but no event of the run solves: no BA number is read,
    # and a BA cell's run that compared none is not correct
    ok, rows, info = _correct(lambda: _small(enable_ba=True))
    assert info["ba_checked"] == 0
    assert rows["ba.build_gap"] is None and rows["step.pose_gap"] == 0.0
    assert not ok


def test_sound_ba_run_is_correct():
    ok, rows, info = _correct_ba()
    assert info["ba_checked"] == 1 and ok, rows


def test_ba_problem_built_wrong(monkeypatch):
    # one observation of the window left out where the program builds it
    real = keyframes.build_window_problem

    def dropped(*a, **k):
        wp = real(*a, **k)
        mask = wp.problem.obs_mask.clone()
        mask[mask.nonzero()[0][0], mask.nonzero()[0][1]] = False
        return wp._replace(problem=wp.problem.replace(obs_mask=mask))
    monkeypatch.setattr(keyframes, "build_window_problem", dropped)
    ok, rows, info = _correct_ba()
    assert info["ba_checked"] == 1 and rows["ba.build_gap"] >= 1, rows
    assert not ok


def test_ba_solve_altered(monkeypatch):
    # the solve's cameras moved where it returns them
    real = ba.solve_robust

    def altered(*a, **k):
        solved, stats = real(*a, **k)
        T = solved.T_cw.clone()
        T[:, 0, 3] += 1e-2
        return solved.replace(T_cw=T), stats
    monkeypatch.setattr(ba, "solve_robust", altered)
    ok, rows, info = _correct_ba()
    lim = check.limits()["ba.pose_gap"]
    assert info["ba_checked"] == 1 and rows["ba.pose_gap"] > lim, rows
    assert not ok
