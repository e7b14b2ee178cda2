"""The reference's ORB-style front end (``oriented``, ``track_carry``) held
bit for bit to the program's on the CPU, a whole small run with both on
judged correct, and the fullmap traffic's ``prepare``: its distractors in
the map, pinned, and left alone by the maintenance that follows."""
import dataclasses
import json
import os

import pytest
import torch

from slambench import run as srun
from slambench.reference import check
from slambench.reference.slam.frontend import descriptors as rdesc
from slambench.reference.slam.frontend import features as rfeat
from slambench.reference.slam.pipeline import tracker as rtracker
from slambench.traffic import corridor, fullmap
from vslam_tpu_torch.config import small_config
from vslam_tpu_torch.frontend import descriptors as pdesc
from vslam_tpu_torch.frontend import features as pfeat
from vslam_tpu_torch.pipeline import tracker as ptracker
from vslam_tpu_torch.pipeline.slam import SLAMSystem

HERE = os.path.dirname(os.path.abspath(__file__))
VARIANTS = {"oriented": dict(oriented=True),
            "carry": dict(track_carry=True),
            "both": dict(oriented=True, track_carry=True)}


def _traffic(name):
    with open(os.path.join(HERE, "..", "traffic", f"{name}.json")) as f:
        return json.load(f)


def _cfg(**frontend):
    cfg = small_config()
    return cfg.replace(frontend=dataclasses.replace(cfg.frontend, **frontend))


def _frames(cfg, n, seed=2 ** 31 + 17):
    tr = _traffic("drive")
    tr.update(step_m=0.6, landmarks_per_frame=100, lateral_m=14.0)
    cam = dataclasses.asdict(cfg.camera)
    _, frames = corridor.make(tr, cam, n, seed, "cpu")
    return [f.float() / 255.0 for f in frames]


def _same(a, b, where=""):
    """Snapshots equal to the bit (NaN where NaN)."""
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert torch.equal(a, b) or torch.equal(
            torch.nan_to_num(a, nan=7.0), torch.nan_to_num(b, nan=7.0)), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    else:
        assert a == b or a is b or str(a) == str(b), where


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_reference_front_end_is_the_programs(variant):
    torch.manual_seed(0)
    cfg = _cfg(**VARIANTS[variant])
    rcfg = check.config(json.loads(cfg.to_json()))
    fe, rfe = cfg.frontend, rcfg.frontend
    H, W = cfg.camera.height, cfg.camera.width
    imgs = _frames(cfg, 5)
    blurred = pfeat.gaussian_blur(imgs[1], fe.blur_sigma)
    uv = torch.rand(300, 2) * torch.tensor([W + 40.0, H + 40.0]) - 20.0
    angle = pdesc.orientations_at(blurred, uv, fe.patch_radius)
    _same(angle, rdesc.orientations_at(blurred, uv, rfe.patch_radius))
    _same(pdesc.describe(blurred, uv, angle, fe),
          rdesc.describe(blurred, uv, angle, rfe))
    carry = torch.rand(fe.max_keypoints, 2) * torch.tensor([W, H * 1.0])
    mask = torch.rand(fe.max_keypoints) < 0.7
    _same(pfeat.detect_with_carry(imgs[2], fe, H, W, carry, mask),
          rfeat.detect_with_carry(imgs[2], rfe, H, W, carry, mask))

    # the step, frame by frame from the program's state
    st = ptracker.bootstrap(imgs[0], cfg, "cpu", seed=11)
    for img in imgs[1:]:
        pre = check.snapshot(st)
        want = rtracker.track_step(check.build(pre), img, rcfg)
        st, out = ptracker.track_step(st, img, cfg)
        _same(check.snapshot(want[0])[1], check.snapshot(st)[1], "state")
        _same(tuple(want[1]), tuple(out), "output")
    assert int(out.num_matches) > 0


def test_orb_run_is_correct():
    """A whole small drive with ``oriented`` and ``track_carry`` on: every
    judged gap reads 0."""
    torch.set_num_threads(4)
    cfg = dataclasses.asdict(_cfg(oriented=True, track_carry=True))
    cfg["pipeline"].update(keyframe_every=5, local_ba_every=5)
    tr = _traffic("drive")
    tr.update(step_m=0.6, landmarks_per_frame=100, lateral_m=14.0,
              warmup_frames=4, warmup_max_frames=4, ceiling_frames_per_s=6,
              check_frames=2, check_within_frames_per_s=1, enable_ba=False)
    man = srun.manifest()
    result, rows, info, _ = srun.run_cell(
        man, srun.cell_of(man, "kitti00_mono.drive"), 2 ** 31 + 29, 3.0,
        False, device="cpu", cfg_doc={"vslam": cfg}, tr=tr)
    assert info["frames_checked"] >= 1
    assert result["correct"], rows
    assert all(v == 0.0 for _, v, _ in rows), rows


def test_fullmap_prepare_pins_its_distractors():
    cfg = small_config()
    cap = cfg.map.capacity
    tr = _traffic("fullmap")
    tr.update(step_m=0.6, landmarks_per_frame=100, lateral_m=14.0,
              distractors=cap * 3 // 4)
    imgs = _frames(cfg, 60, seed=5)
    system = SLAMSystem(cfg, "cpu", seed=5)
    system.process(imgs[0])
    system.process(imgs[1])
    before = int(system.state.map.size)
    fullmap.prepare(system, tr, 5, "cpu")
    m = system.state.map
    n = tr["distractors"]
    pinned = m.last_seen == tr["distractor_last_seen"]
    assert int(m.size) == before + n
    assert int(pinned.sum()) == n and bool(pinned[before:before + n].all())
    assert bool(m.alive[before:before + n].all())
    xyz = m.pt[before:before + n, :3]
    assert float(xyz[:, 0].abs().max()) < 50 and \
        float(xyz[:, 1].abs().max()) < 10
    assert 2 <= float(xyz[:, 2].min()) and float(xyz[:, 2].max()) <= 180
    # the drive fills what is left until maintenance compacts the map
    i = 2
    while system.maintenance_runs == 0:
        assert i < len(imgs), "no maintenance in the frames made"
        system.process(imgs[i])
        i += 1
    m = system.state.map
    rec = [r for r in system.metrics.records
           if r.get("kind") == "map_maintenance"][0]
    assert rec["size_before"] >= system._maint_high_water
    assert rec["size_after"] < rec["size_before"]
    live = m.alive & (torch.arange(cap) < m.size)
    assert int((live & (m.last_seen == tr["distractor_last_seen"])).sum()) \
        == n
