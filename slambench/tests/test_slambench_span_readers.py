"""The readers of the program's own spans, counters and stage events, on
hand-made runs: each reads what it should, skips what it should, and
returns None on records that lack the fields (the program before them)."""
import pytest

from slambench import run as srun
from slambench.lib import trace as libtrace


def _read(name, r):
    return srun.reader(name)(r)


def _trace():
    frames = [libtrace.Frame(1, 0, 100), libtrace.Frame(2, 150, 300)]
    ops = [("hamming_kernel", 10, 30), ("void at::elementwise_kernel", 20, 60),
           ("Memcpy DtoD (Device -> Device)", 60, 70),
           ("associate_kernel", 160, 200), ("gemm", 250, 260)]
    tr = libtrace.Trace(frames, ops)
    for op in ops:
        tr.frame_of(op[1]).ops.append(op)
    return tr


_ORD = {"kind": "frame", "success": True, "keyframe": False,
        "ran_ba": False, "ran_maintenance": False}


def test_stage_and_host_span_readers():
    # frames 10-13: 12 a keyframe, 13 traced (no replay time); the
    # ordinary 10 and 11 count
    r = srun.Run(None)
    r.first = 10
    fetch = lambda s, e: ["fetch", s, e]
    r.records = [
        dict(_ORD, frame=10, wall_s=0.045, syncs=1,
             device_ms={"ransac": 36.0, "ransac.fit": 9.0},
             spans=[["upload", 0, 10], ["step", 10, 400_000],
                    fetch(400_000, 44_000_000)]),
        dict(_ORD, frame=11, wall_s=0.047, syncs=1,
             device_ms={"ransac": 34.0},
             spans=[fetch(1_000_000, 44_500_000),
                    fetch(45_000_000, 45_500_000)]),
        dict(_ORD, frame=12, wall_s=0.050, keyframe=True,
             device_ms={"ransac": 99.0}, spans=[fetch(0, 10_000_000)]),
        dict(_ORD, frame=13, wall_s=0.070, device_ms={"ransac": 99.0},
             spans=[])]
    r.latencies = [0.0455, 0.0475, 0.0505, 0.0705]
    r.replay_s = {10: 0.044, 11: 0.044, 12: 0.044}
    assert _read("step.ransac_ms", r) == pytest.approx(35.0)
    assert _read("driver.host_span_ms", r) == pytest.approx(
        1e3 * ((0.045 - 0.0436) + (0.047 - 0.044)) / 2)
    # the host's spans are read before the traced stretch only
    r.trace = libtrace.Trace([libtrace.Frame(11, 0, 1)], [])
    assert _read("driver.host_span_ms", r) == pytest.approx(1.4)
    assert _read("step.ransac_ms", r) == pytest.approx(35.0)
    r.trace = libtrace.Trace([libtrace.Frame(10, 0, 1)], [])
    assert _read("driver.host_span_ms", r) is None
    r.trace = None
    # the parent's records carry neither stages nor spans
    for rec in r.records:
        del rec["device_ms"], rec["spans"]
    assert _read("step.ransac_ms", r) is None
    assert _read("driver.host_span_ms", r) is None


def test_ba_solve_and_sync_readers():
    r = srun.Run(None)
    r.records = [dict(_ORD, frame=i, wall_s=0.045, syncs=1)
                 for i in range(3)]
    for i, skipped, ms, syncs in ((25, "shallow", None, 2),
                                  (50, None, 45.0, 19),
                                  (75, None, 47.0, 21),
                                  (100, None, 90.0, 40)):
        r.records.append(dict(_ORD, frame=i, wall_s=0.1, keyframe=True,
                              ran_ba=True, syncs=syncs))
        ev = {"kind": "ba", "frame": i}
        ev.update({"skipped": skipped} if skipped else
                  {"solve_device_ms": ms})
        r.records.append(ev)
    # frame 100 was traced (no replay time): left out
    r.replay_s = {i: 0.044 for i in (0, 1, 2, 25, 50, 75)}
    assert _read("ba.solve_ms", r) == pytest.approx(46.0)
    assert _read("ba.syncs", r) == 20
    for rec in r.records:
        rec.pop("solve_device_ms", None)
        rec.pop("syncs", None)
    assert _read("ba.solve_ms", r) is None
    assert _read("ba.syncs", r) is None


def test_host_idle_leaves_out_the_replay_and_other_frames():
    # idle gaps [0,10] [70,160] [200,250] [260,300] (the hand trace);
    # frame 1 [0,100] is ordinary with its step over [0,5] and a fetch
    # over [20,80], frame 2 [150,300] a keyframe
    tr = _trace()
    r = srun.Run(None)
    r.trace = tr
    r.records = [dict(_ORD, frame=1, wall_s=100e-9,
                      spans=[["upload", 0, 1], ["step", 1, 5],
                             ["fetch", 20, 80]]),
                 dict(_ORD, frame=2, wall_s=150e-9, keyframe=True,
                      spans=[])]
    # frame 1: [0,1] and [5,10] of [0,10], [80,100] of [70,160]; [150,160]
    # lies in frame 2
    assert _read("device.host_idle_ms", r) == pytest.approx(26e-6)
    r.records[1]["keyframe"] = False
    # frame 2 too: [150,160] [200,250] [260,300], no step or fetch
    assert _read("device.host_idle_ms", r) == pytest.approx(
        (26 + 100) / 2 * 1e-6)
    for rec in r.records:
        del rec["spans"]
    assert _read("device.host_idle_ms", r) is None
    r.trace = None
    assert _read("device.host_idle_ms", r) is None


def test_associate_and_maintenance_readers():
    # frames 20-24: 22 ran maintenance, 24 was traced (no replay time)
    r = srun.Run(None)
    r.first = 20
    r.records = [
        dict(_ORD, frame=20, wall_s=0.03, device_ms={"associate": 0.12}),
        dict(_ORD, frame=21, wall_s=0.03, device_ms={"associate": 0.18}),
        dict(_ORD, frame=22, wall_s=0.04, ran_maintenance=True,
             device_ms={"associate": 9.0},
             spans=[["step", 0, 10], ["maintenance", 1_000_000, 4_000_000]]),
        {"kind": "map_maintenance", "frame": 22, "size_before": 117970,
         "size_after": 109700},
        dict(_ORD, frame=23, wall_s=0.04, ran_maintenance=True,
             spans=[["maintenance", 0, 5_000_000]]),
        dict(_ORD, frame=24, wall_s=0.03, device_ms={"associate": 9.0})]
    r.replay_s = {20: 0.02, 21: 0.02, 22: 0.02, 23: 0.02}
    r.latencies = [0.031, 0.031, 0.041, 0.041, 0.031]
    assert _read("step.associate_ms", r) == pytest.approx(0.15)
    assert _read("map.maintenance_ms", r) == pytest.approx(4.0)
    # only maintenances before the traced stretch count
    r.trace = libtrace.Trace([libtrace.Frame(23, 0, 1)], [])
    assert _read("map.maintenance_ms", r) == pytest.approx(3.0)
    r.trace = libtrace.Trace([libtrace.Frame(22, 0, 1)], [])
    assert _read("map.maintenance_ms", r) is None
    r.trace = None
    for rec in r.records:
        rec.pop("device_ms", None)
        rec["ran_maintenance"] = False
    assert _read("step.associate_ms", r) is None
    assert _read("map.maintenance_ms", r) is None


def test_k2_roofline_reads_the_map_a_compaction_left():
    # frame 2's K2 searched the map that frame 1's maintenance left
    from slambench.lib import roofline
    from slambench.metrics._frames import live_map

    r = srun.Run(None)
    r.cfg = type("C", (), {})()
    r.cfg.frontend = type("F", (), {"max_keypoints": 3072})()
    r.cfg.map = type("M", (), {"obs_per_point": 4})()
    r.trace = _trace()
    r.records = [dict(_ORD, frame=1, map_size=117970, ran_maintenance=True),
                 {"kind": "map_maintenance", "frame": 1,
                  "size_before": 117970, "size_after": 109700}]
    assert live_map(r, 2) == 109700 and live_map(r, 1) is None
    want = roofline.least_s(*roofline.k2(3072, 109700, 4)) / 40e-9
    assert _read("k2_roofline", r) == pytest.approx(100 * want)
    r.records.pop()
    assert live_map(r, 2) == 117970
