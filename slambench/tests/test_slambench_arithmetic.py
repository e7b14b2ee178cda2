"""The benchmark's arithmetic on the CPU: the traffic generators at a tiny
size, the end-to-end readers over a whole window, the kernels' bytes and
operations against hand-worked shapes, and the trace's union and gaps."""
import math

import numpy as np
import pytest
import torch

from slambench import run as srun
from slambench.lib import roofline
from slambench.lib import trace as libtrace
from slambench.traffic import corridor, handheld

CAM = {"width": 64, "height": 48, "fx": 50.0, "fy": 50.0, "cx": 32.0,
       "cy": 24.0}


def _read(name, r):
    return srun.reader(name)(r)


def test_corridor_frames_from_the_seed():
    p = {"step_m": 1.0, "yaw_rate": 0.004, "sway": 0.05,
         "landmarks_per_frame": 20, "lateral_m": 5.0, "vertical_m": 2.0,
         "ahead_m": [4.0, 45.0], "render_back": 50, "render_ahead": 100}
    poses, frames = corridor.make(p, CAM, 6, 2 ** 31 + 5, "cpu")
    again = corridor.make(p, CAM, 6, 2 ** 31 + 5, "cpu")[1]
    other = corridor.make(p, CAM, 6, 2 ** 31 + 6, "cpu")[1]
    assert frames.dtype == torch.uint8 and frames.shape == (6, 48, 64)
    assert poses.shape == (6, 4, 4)
    assert torch.equal(frames, again) and not torch.equal(frames, other)
    steps = np.linalg.norm(np.diff(poses[:, :3, 3], axis=0), axis=1)
    assert np.all(np.abs(steps - 1.0) < 0.2)
    assert len(torch.unique(frames[0])) > 2      # landmarks were drawn


def test_handheld_speeds_are_the_traffics():
    p = {"rate_hz": 30.0, "speed_m_s": 0.244, "turn_deg_s": 8.92,
         "amplitude_m": [0.3, 0.2, 0.25], "period_s": [4.0, 5.0, 6.0],
         "angle_amplitude_deg": [3.0, 4.0, 2.0],
         "angle_period_s": [3.1, 3.7, 4.3], "landmarks": 50,
         "box_m": [2.0, 1.5], "depth_m": [0.8, 3.0]}
    for seed in (1, 2 ** 31 + 11):
        poses = handheld.trajectory(600, p, np.random.default_rng([seed, 0]))
        v = np.linalg.norm(np.diff(poses[:, :3, 3], axis=0), axis=1) * 30
        assert abs(v.mean() - 0.244) < 0.01
        R = poses[:, :3, :3]
        rel = np.einsum("nji,njk->nik", R[:-1], R[1:])
        ang = np.degrees(np.arccos(np.clip((np.trace(rel, axis1=1, axis2=2)
                                            - 1) / 2, -1, 1))) * 30
        assert abs(ang.mean() - 8.92) < 0.5
    _, frames = handheld.make(p, CAM, 3, 7, "cpu")
    assert frames.dtype == torch.uint8 and frames.shape == (3, 48, 64)


def _run(latencies, window_s):
    r = srun.Run(None)
    r.latencies, r.window_s = latencies, window_s
    return r


def test_rate_over_the_whole_window():
    # a stall inside the window counts: 3 frames in 2 s, whatever the
    # frames' own latencies
    assert _read("frames_per_s", _run([0.01, 0.01, 0.01], 2.0)) == 1.5


def test_p95_over_all_frames():
    lat = [0.001 * i for i in range(1, 101)]            # 1 .. 100 ms
    assert _read("frame_ms_p95", _run(lat, 1.0)) == pytest.approx(95.0)
    # nearest rank: one slow frame in 20 lies beyond, two reach it
    assert _read("frame_ms_p95", _run([0.04] * 19 + [0.2], 1.0)) == \
        pytest.approx(40.0)
    assert _read("frame_ms_p95", _run([0.04] * 18 + [0.2] * 2, 1.0)) == \
        pytest.approx(200.0)


def test_k1_counts():
    n_bytes, ops, peak = roofline.k1(3072, 3072)
    assert n_bytes == 4 * 3072 * 3072 + 32 * 6144 == 37945344
    assert ops == 2 * 256 * 3072 * 3072 and peak == 1979e12
    # 37.95 MB at 3.35 TB/s bounds it: 0.0113 ms
    assert roofline.least_s(n_bytes, ops, peak) == pytest.approx(
        37945344 / 3.35e12)


def test_k2_counts():
    n_bytes, ops, peak = roofline.k2(3072, 51200, 4)
    assert n_bytes == 51200 * (8 + 1 + 4 + 4 + 128) + 3072 * (8 + 1 + 32 + 4)
    assert ops == 5 * 3072 * 51200 and peak == 67e12
    # the pixel gate's operations bound it: 0.0117 ms
    assert roofline.least_s(n_bytes, ops, peak) == pytest.approx(
        5 * 3072 * 51200 / 67e12)


def _trace():
    frames = [libtrace.Frame(1, 0, 100), libtrace.Frame(2, 150, 300)]
    ops = [("hamming_kernel", 10, 30), ("void at::elementwise_kernel", 20, 60),
           ("Memcpy DtoD (Device -> Device)", 60, 70),
           ("associate_kernel", 160, 200), ("gemm", 250, 260)]
    tr = libtrace.Trace(frames, ops)
    for op in ops:
        tr.frame_of(op[1]).ops.append(op)
    return tr


def test_trace_union_and_gaps():
    tr = _trace()
    assert tr.window_ns == 300
    assert tr.busy_ns() == 60 + 40 + 10          # [10,70] [160,200] [250,260]
    assert tr.idle_gaps() == [(0, 10), (70, 160), (200, 250), (260, 300)]
    assert tr.frames[0].busy_ns() == 60 and len(tr.frames[0].kernels()) == 2
    assert libtrace.classify("Memcpy DtoD (Device -> Device)") == "memcpy"
    assert libtrace.classify("hamming_kernel(unsigned const*)") == \
        "K1 hamming"
    assert libtrace.classify("void cutlass::Kernel<x>") == "gemm"


def test_step_readers_take_ordinary_frames():
    tr = _trace()
    r = srun.Run(None)
    r.trace = tr
    base = {"kind": "frame", "success": True, "keyframe": False,
            "ran_ba": False, "ran_maintenance": False}
    r.records = [dict(base, frame=1, wall_s=100e-9),
                 dict(base, frame=2, wall_s=150e-9, keyframe=True)]
    assert _read("step.device_ms", r) == pytest.approx(60e-6)
    assert _read("step.kernels", r) == 2
    # the host side is not read from the traced stretch
    assert _read("driver.host_ms", r) is None
    assert _read("device.idle_share", r) is None


def test_host_and_idle_from_the_untraced_replays():
    # frames 10-13 of a window that starts at frame 10; 12 is a keyframe
    # and 13 was traced (no replay time): the ordinary 10 and 11 count
    base = {"kind": "frame", "success": True, "keyframe": False,
            "ran_ba": False, "ran_maintenance": False}
    r = srun.Run(None)
    r.first = 10
    r.records = [dict(base, frame=10, wall_s=0.045),
                 dict(base, frame=11, wall_s=0.047),
                 dict(base, frame=12, wall_s=0.050, keyframe=True),
                 dict(base, frame=13, wall_s=0.070)]
    r.latencies = [0.0455, 0.0475, 0.0505, 0.0705]
    r.replay_s = {10: 0.044, 11: 0.044, 12: 0.044}
    assert _read("driver.host_ms", r) == pytest.approx(
        1e3 * (0.001 + 0.003) / 2)
    assert _read("device.idle_share", r) == pytest.approx(
        100 * (1 - 0.088 / 0.093))


def test_ba_readers():
    base = {"kind": "frame", "success": True, "keyframe": False,
            "ran_ba": False, "ran_maintenance": False}
    r = srun.Run(None)
    r.records = ([dict(base, frame=i, wall_s=0.045) for i in range(20)]
                 + [dict(base, frame=20, wall_s=0.1, keyframe=True,
                         ran_ba=True),
                    {"kind": "ba", "frame": 20, "skipped": "shallow"},
                    dict(base, frame=45, wall_s=0.2, keyframe=True,
                         ran_ba=True),
                    {"kind": "ba", "frame": 45, "accepted": 3}])
    assert _read("ba.event_ms", r) == pytest.approx(1e3 * (0.15 - 0.045))
    assert _read("ba.solved_share", r) == 50.0
    r.records = r.records[:20]
    assert _read("ba.event_ms", r) is None
    assert _read("ba.solved_share", r) is None
    assert math.isfinite(_read("frames_per_s", _run([0.04], 1.0)))


def test_map_gap_matches_inserts_by_their_founding_pixel():
    from slambench.reference import check
    counts = {k: 0 for k in check.COUNTS}
    pre = torch.tensor([[1.0, 0, 5], [0, 1, 5], [0, 0, 4]], dtype=torch.float64)
    eye = torch.eye(4, dtype=torch.float64)

    def out(xyz, uv):
        return {"pose": eye, "counts": counts,
                "xyz": torch.tensor(xyz, dtype=torch.float64),
                "first_uv": torch.tensor(uv, dtype=torch.float32)}
    old_uv = [[0.0, 0.0]] * 3
    # the reference inserts A, B, C; the program skips A, so B and C land a
    # row earlier; the program also moves row 1 by 1e-3
    want = out(pre.tolist() + [[1, 1, 6], [2, 2, 7], [3, 3, 8]],
               old_uv + [[10.5, 20.5], [11.5, 21.5], [12.5, 22.5]])
    got = out([[1, 0, 5], [0, 1, 5.001], [0, 0, 4], [2, 2, 7], [3, 3, 8]],
              old_uv + [[11.5, 21.5], [12.5, 22.5]])
    g = check.gaps(got, want, eye, pre)
    # compared: row 1 (moved on one side) and B and C: median gap 0
    assert g["step.map_gap"] == 0.0 and g["step.pose_gap"] == 0.0
    got["xyz"][3:] += 0.5
    scale = float(torch.linalg.vector_norm(want["xyz"], dim=1).median())
    assert check.gaps(got, want, eye, pre)["step.map_gap"] == \
        pytest.approx(0.5 / scale)
