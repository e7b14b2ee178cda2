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
