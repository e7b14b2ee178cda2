"""The ORB-style front end as a benchmarked configuration.

``slambench/configs/kitti00_mono_orb.json`` is ``kitti00_mono.json`` with
``oriented`` and ``track_carry`` on, and its traffic ``drive_vo.json`` is
``drive.json`` with window BA off; a small CPU run of the cell's files is
judged correct with every gap 0. The carry's counters (``num_carried``,
``num_keypoints``), which the step notes inside its graph and the frame's
row carries out, equal a recount from the frozen reference's
``detect_with_carry`` on the same inputs, and read 0 on the upright path.
The cell's four readers on made-up records.

The ``gpu`` case (skipped without a card; the module imports no jax): a
``span=True`` ORB step graph records the front end's parts and replays to
the bit what the graph without events replays. Run it with

    python -m pytest tests/test_torch_orb_config.py -m gpu --noconftest -q
"""
import dataclasses
import json
import os

import pytest
import torch

from slambench import run as srun
from slambench.reference import check
from slambench.reference.slam.frontend import features as rfeat
from slambench.traffic import corridor
from torch_frozen import tensors
from vslam_tpu_torch.config import VSLAMConfig, small_config
from vslam_tpu_torch.frontend import features as pfeat
from vslam_tpu_torch.pipeline import scan_driver, tracker
from vslam_tpu_torch.pipeline.slam import SLAMSystem

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "slambench")
CELL = "kitti00_mono_orb.drive_vo"
FLAGS = ("oriented", "track_carry")
PARTS = ("features.carry", "features.orient", "features.describe")


def _load(*parts):
    with open(os.path.join(BENCH, *parts)) as f:
        return json.load(f)


def _cfg(**frontend):
    cfg = small_config()
    return cfg.replace(frontend=dataclasses.replace(cfg.frontend, **frontend))


ORB = _cfg(oriented=True, track_carry=True)


def _traffic():
    """The cell's traffic, shrunk to the small camera and a few frames:
    the frame checked is the window's second (``check_within_frames_per_s``
    x the window's seconds < 2), which a loaded CPU reaches too."""
    tr = _load("traffic", "drive_vo.json")
    tr.update(step_m=0.6, landmarks_per_frame=100, lateral_m=14.0,
              warmup_frames=4, warmup_max_frames=4, ceiling_frames_per_s=20,
              check_frames=2, check_within_frames_per_s=0.25)
    return tr


def _frames(cfg, n, seed=2 ** 31 + 41):
    cam = dataclasses.asdict(cfg.camera)
    _, frames = corridor.make(_traffic(), cam, n, seed, "cpu")
    return [f.float() / 255.0 for f in frames]


# ---- (a), (b): the files -------------------------------------------------

def test_orb_config_is_kitti00_mono_with_the_two_flags():
    orb = _load("configs", "kitti00_mono_orb.json")
    base = _load("configs", "kitti00_mono.json")
    cfg = VSLAMConfig.from_json(json.dumps(orb["vslam"]))
    assert cfg.frontend.oriented and cfg.frontend.track_carry
    assert json.loads(cfg.to_json()) == orb["vslam"]
    want = json.loads(json.dumps(base["vslam"]))
    want["frontend"].update({k: True for k in FLAGS})
    assert orb["vslam"] == want
    assert not any(base["vslam"]["frontend"][k] for k in FLAGS)
    assert orb["name"] == "kitti00_mono_orb" and orb["reduced"] == []
    assert 1 <= len(orb["source"]) <= 200
    assert orb["deployment"] and orb["assumed"]
    man = srun.manifest()
    entry = [c for c in man["configs"] if c["name"] == orb["name"]]
    assert entry and entry[0]["source"] == orb["source"]
    cell = srun.cell_of(man, CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "kitti00_mono_orb", "drive_vo", 1)


def test_drive_vo_is_drive_without_window_ba():
    vo, drive = _load("traffic", "drive_vo.json"), _load("traffic",
                                                         "drive.json")
    assert drive["enable_ba"] is True and vo["enable_ba"] is False
    assert {k: v for k, v in vo.items() if k != "enable_ba"} == \
        {k: v for k, v in drive.items() if k != "enable_ba"}


# ---- (c): a small run of the cell ----------------------------------------

def test_small_orb_cell_run_is_correct():
    """The cell's traffic and flags at ``small_config``'s widths: the
    reference judges it correct, every step gap 0, and the frames record
    the carry's counters."""
    torch.set_num_threads(4)
    doc = dataclasses.asdict(ORB)
    doc["pipeline"].update(keyframe_every=5, local_ba_every=5)
    man = srun.manifest()
    result, rows, info, _ = srun.run_cell(
        man, srun.cell_of(man, CELL), 2 ** 31 + 53, 6.0, False,
        device="cpu", cfg_doc={"vslam": doc}, tr=_traffic())
    assert info["frames_checked"] >= 1 and info["window_ba"] == []
    assert result["correct"], rows
    assert rows and all(v == 0.0 for _, v, _ in rows), rows


# ---- (d): the carry's counters -------------------------------------------

def _recount(img, carry_uv, carry_mask, cfg):
    """(carried, valid) keypoints of the reference's ``detect_with_carry``
    on these inputs: its carried keypoints that survive the gates and the
    dedupe, which lead its output in index order."""
    rcfg = check.config(json.loads(cfg.to_json())).frontend
    H, W = cfg.camera.height, cfg.camera.width
    uv, _, ok = rfeat.detect_with_carry(img, rcfg, H, W, carry_uv,
                                        carry_mask)
    resp = rfeat.corner_response(img, rcfg.score, rcfg.harris_k)
    uv_t, sc_t, ok_t = rfeat.refine_tracked(resp, carry_uv, carry_mask,
                                            rcfg.border, H, W)
    ok_t = ok_t & (sc_t > rcfg.quality_level * torch.max(resp))
    i = torch.arange(uv_t.shape[0])
    clash = (rfeat._chebyshev_within(uv_t, uv_t, float(rcfg.nms_radius))
             & ok_t[None, :] & (i[None, :] < i[:, None]))
    kept = uv_t[ok_t & ~clash.any(dim=1)]
    k = kept.shape[0]
    # what makes the count a recount of the output: its first k rows
    assert torch.equal(uv[:k], kept) and bool(ok[:k].all())
    return k, int(ok.sum())


def test_num_carried_is_a_recount_of_the_reference(monkeypatch):
    calls = []
    detect = pfeat.detect_with_carry

    def spy(img, cfg, height, width, carry_uv, carry_mask):
        calls.append((img.clone(), carry_uv.clone(), carry_mask.clone()))
        return detect(img, cfg, height, width, carry_uv, carry_mask)

    monkeypatch.setattr(pfeat, "detect_with_carry", spy)
    imgs = _frames(ORB, 7)
    s = SLAMSystem(ORB, "cpu", seed=3, enable_ba=False)
    infos = [s.process(img) for img in imgs]
    assert len(calls) == len(imgs) - 1           # the bootstrap detects
    got = [(x["num_carried"], x["num_keypoints"]) for x in infos[1:]]
    want = [_recount(img, uv, mask, ORB) for img, uv, mask in calls]
    assert got == want
    assert sum(x["success"] for x in infos[1:]) >= len(imgs) - 2
    assert any(0 < c < n for c, n in got), got    # premise: both kinds


@pytest.mark.parametrize("flags", [{}, {"oriented": True}],
                         ids=["upright", "oriented"])
def test_num_carried_reads_zero_without_the_carry(flags):
    cfg = _cfg(**flags)
    imgs = _frames(cfg, 3)
    st = tracker.bootstrap(imgs[0], cfg, "cpu", seed=3)
    for img in imgs[1:]:
        st, out, row = scan_driver.track_frame(st, img, cfg)
        sc = scan_driver.ChunkScalars.unpack(row[None].numpy())
        assert int(sc.num_carried[0]) == 0 and int(sc.num_keypoints[0]) == 0
        assert int(sc.num_matches[0]) == int(out.num_matches)
    s = SLAMSystem(cfg, "cpu", seed=3, enable_ba=False)
    infos = [s.process(img) for img in imgs]
    assert not any(k in x for x in infos for k in scan_driver.NOTED)


def test_chunk_rows_carry_the_noted_counters():
    """``process_chunk``'s rows hold the counters ``process`` records."""
    imgs = _frames(ORB, 6)
    a = SLAMSystem(ORB, "cpu", seed=3, enable_ba=False)
    b = SLAMSystem(ORB, "cpu", seed=3, enable_ba=False)
    want = [a.process(img) for img in imgs]
    b.process(imgs[0])
    b.process_chunk(torch.stack(imgs[1:]))
    got = [r for r in b.metrics.records
           if r.get("kind") == "frame" and "success" in r]
    for k in scan_driver.NOTED:
        assert [r[k] for r in got] == [x[k] for x in want[1:]], k
    assert sum(r["num_carried"] for r in got) > 0


# ---- (e): the cell's readers ---------------------------------------------

def _run(records):
    """A ``slambench.run.Run`` whose window is these frame records, each
    replayed outside a traced stretch."""
    run = srun.Run(cfg=None, first=10)
    run.records = [dict(kind="frame", frame=10 + j, success=True, **r)
                   for j, r in enumerate(records)]
    run.latencies = [0.03] * len(records)
    run.replay_s = {10 + j: 0.028 for j in range(len(records))}
    return run


def _read(name, run):
    return srun.reader(name)(run)


def test_frontend_readers_on_made_up_records():
    ms = [dict(features=3.0, match=0.4, **{"features.carry": 1.0,
                                           "features.orient": 0.5,
                                           "features.describe": 1.25}),
          dict(features=5.0, match=0.4, **{"features.carry": 2.0,
                                           "features.orient": 0.75,
                                           "features.describe": 1.5})]
    recs = [dict(device_ms=ms[0], num_carried=300, num_keypoints=1000),
            dict(device_ms=ms[1], num_carried=500, num_keypoints=1000),
            # a keyframe: not an ordinary frame, so no reader reads it
            dict(device_ms=dict(ms[1], features=99.0), keyframe=True,
                 num_carried=1000, num_keypoints=1000)]
    run = _run(recs)
    assert _read("frontend.features_ms", run) == pytest.approx(4.0)
    assert _read("frontend.carry_ms", run) == pytest.approx(1.5)
    assert _read("frontend.steer_ms", run) == pytest.approx(2.0)
    assert _read("frontend.carried_share", run) == pytest.approx(40.0)


def test_frontend_readers_read_none_without_marks_or_counters():
    upright = _run([dict(device_ms=dict(features=1.0, match=0.4))] * 3)
    assert _read("frontend.features_ms", upright) == pytest.approx(1.0)
    for name in ("frontend.carry_ms", "frontend.steer_ms",
                 "frontend.carried_share"):
        assert _read(name, upright) is None, name
    bare = _run([{}, {}])                    # an untraced run's records
    bare.replay_s = {}
    for name in ("frontend.features_ms", "frontend.carry_ms",
                 "frontend.steer_ms", "frontend.carried_share"):
        assert _read(name, bare) is None, name
    none_valid = _run([dict(num_carried=0, num_keypoints=0)])
    assert _read("frontend.carried_share", none_valid) is None


# ---- (f): on the card ----------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs and the hand kernels "
                    "have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_orb_stage_events_leave_the_replay_unchanged_on_cuda(cuda):
    imgs = [f.to(cuda) for f in _frames(ORB, 8)]
    runs = {}
    for span in (False, True):
        s = SLAMSystem(ORB, cuda, seed=3, enable_ba=False)
        if span:
            s.step_graph = scan_driver.step_graph(ORB, span=True)
        runs[span] = (s, [s.process(img) for img in imgs])
    (a, ia), (b, ib) = runs[False], runs[True]
    names = [n for n, _ in b.step_graph.marks]
    assert all(p in names for p in PARTS), names
    assert names.index("features") < names.index("features.carry") < \
        names.index("features.orient") < names.index("features.describe") \
        < names.index("match")
    assert a.step_graph.nodes["kernel"] == b.step_graph.nodes["kernel"]
    for x in ib[1:]:
        ms = x["device_ms"]
        parts = sum(ms[p] for p in PARTS)
        assert 0 < parts <= ms["features"] + 1e-3, ms
    skip = ("wall_s", "t", "capture_s", "spans", "syncs", "device_ms")
    strip = [[{k: v for k, v in x.items() if k not in skip} for x in i]
             for i in (ia, ib)]
    assert strip[0] == strip[1]
    assert sum(x["num_carried"] for x in ia[1:]) > 0
    for p, q in zip(a.trajectory, b.trajectory):
        assert (p == q).all()
    for (name, x), (_, y) in zip(tensors(a.state), tensors(b.state)):
        assert torch.equal(x, y), name
    for name, x, y in zip(tracker.TrackOutput._fields, a.last_output,
                          b.last_output):
        assert torch.equal(x, y), name
