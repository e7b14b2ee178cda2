"""The port's chunked driver (vslam_tpu_torch.pipeline.scan_driver,
``SLAMSystem.process_chunk``).

tests/test_scan_driver.py's three cases on the port alone: the chunk
against the port's own per-frame ``process``. On the CPU both drivers run
the same ops, so flags and counters are equal and poses agree to 1e-6.

The chunk against the reference's per-frame ``process``, with the
reference's RANSAC samples injected (``_injected_chunk``,
``assert_chunk_matches_reference``), runs in tests/test_torch_slam.py (the
BA run) and tests/test_torch_map_lifecycle.py (capacity 512, maintenance
inside the chunk); the renderer's tests are in
tests/test_torch_synthetic_device.py.

MKL's float32 results on this CPU depend on where the allocator put the
operands, so a run made while another system is still alive can differ
from a fresh one in the last bit (a PnP inlier count by one). Each system
is reduced to host values and released before the next run starts.
"""
import gc

import numpy as np
import pytest
import torch

from tests.test_torch_tracker import _reference_samples
from vslam_tpu_torch.config import small_config
from vslam_tpu_torch.datasets import synthetic, synthetic_device
from vslam_tpu_torch.pipeline import scan_driver, slam, tracker

torch.set_num_threads(2)

CFG = small_config()
K = CFG.camera.K()
W, H = CFG.camera.width, CFG.camera.height
ALIGN = CFG.pipeline.keyframe_every * CFG.pipeline.local_ba_every
COUNTS = ("num_matches", "num_inliers", "num_associated", "num_tracked_map",
          "num_tracked_prov", "num_pnp_inliers", "num_refined",
          "num_promoted", "num_new_points", "num_dropped_inserts",
          "map_size", "map_alive")


def _scene(n, seed=2):
    scene = synthetic.make_scene(num_points=700, seed=seed,
                                 extent=(14, 6, 45), z_min=6.0)
    poses = synthetic.make_trajectory(n, step=0.6, yaw_rate=0.01, seed=seed)
    return np.stack(synthetic.render_sequence(K, poses, scene, W, H))


def _corridor(n=12, points=1200):
    """tests/test_scan_driver.py's renderer case: a corridor scene made by
    make_corridor_scene_device around the trajectory, and the renderer."""
    poses = torch.from_numpy(synthetic.make_trajectory(n, step=0.6, seed=3)
                             .astype(np.float32))
    xyz, patches = synthetic_device.make_corridor_scene_device(
        torch.Generator().manual_seed(3), poses, points)
    Kt = torch.from_numpy(K)
    return poses, lambda pose: synthetic_device.render_frame_device(
        xyz, patches, Kt, pose, W, H)


def _summary(s):
    """What the comparisons read, as host values; the system is dropped."""
    out = dict(
        rows=[r for r in s.metrics.records
              if r.get("kind") == "frame" and "success" in r],
        ba=[r for r in s.metrics.records if r.get("kind") == "ba"],
        poses=s.poses(), kf_count=int(s.kf_store.count),
        kf_frames=sorted(int(f) for f in s.kf_store.kf_frame if f >= 0),
        maintenance_runs=s.maintenance_runs,
        dropped=s.dropped_inserts_total)
    del s
    gc.collect()
    return out


def _per_frame(cfg, frames, enable_ba):
    s = slam.SLAMSystem(cfg, "cpu", enable_ba=enable_ba)
    for f in frames:
        s.process(f)
    return _summary(s)


def _chunked(cfg, inputs, sizes, enable_ba, render_fn=None):
    s = slam.SLAMSystem(cfg, "cpu", enable_ba=enable_ba)
    s0 = 0
    for k in sizes:
        s.process_chunk(inputs[s0:s0 + k], render_fn=render_fn)
        s0 += k
    assert s0 == len(inputs)
    return _summary(s)


def _as_inserted(row):
    """A per-frame row with ``keyframe`` as the chunk logs it: the
    per-frame driver logs the decision, the chunk the insert (the decision
    and success), as the reference's two drivers do."""
    return dict(row, keyframe=row["keyframe"] and row["success"])


def _ba_outcomes(events):
    return [(e.get("skipped"), e["ba_result_accepted"]) for e in events]


CASES = {
    # uneven chunks, no BA: boundaries must not matter
    "uneven-no-ba": (17, False, (7, 5, 5)),
    # chunks aligned to keyframe_every * local_ba_every: window BA fires on
    # the frames the per-frame driver picks
    "ba-aligned": (25, True, (ALIGN + 1,) + (ALIGN,) * 5),
    # frames drawn by render_frame_device from the chunk's pose inputs
    "render-fn": (12, False, (6, 6)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_chunk_matches_process(case):
    n, ba_on, sizes = CASES[case]
    render = None
    if case == "render-fn":
        inputs, render = _corridor(n)
        a = _per_frame(CFG, [render(p) for p in inputs], ba_on)
    else:
        inputs = _scene(n)
        a = _per_frame(CFG, inputs, ba_on)
    b = _chunked(CFG, inputs, sizes, ba_on, render)
    assert len(a["rows"]) == len(b["rows"]) == n - 1
    for x, y in zip(a["rows"], b["rows"]):
        x = _as_inserted(x)
        for k in ("success", "keyframe", "ran_maintenance", "scale") + COUNTS:
            assert x[k] == y[k], (x["frame"], k, x[k], y[k])
        assert y["ran_ba"] is False
    np.testing.assert_allclose(b["poses"], a["poses"], atol=1e-6)
    for k in ("kf_count", "kf_frames", "maintenance_runs", "dropped"):
        assert a[k] == b[k], k
    assert _ba_outcomes(a["ba"]) == _ba_outcomes(b["ba"])
    if ba_on:
        assert a["ba"], "premise: a window-BA event"
    if case == "render-fn":
        assert sum(r["success"] for r in b["rows"]) >= n - 3


def test_chunk_rows_pack_and_unpack():
    """ChunkScalars.unpack inverts pack: the reference's field order and
    types (f32 pose and scale, integer counts, bool flags)."""
    n = 4
    frames = _scene(n)
    s = slam.SLAMSystem(CFG, "cpu", enable_ba=False)
    s.process(frames[0])
    st, sr, rows = scan_driver.run_chunk(
        s.state, s.kf_store, torch.from_numpy(frames[1:]), CFG,
        s._maint_high_water, s._maint_min_free)
    assert rows.shape == (n - 1, scan_driver.ROW)
    sc = scan_driver.ChunkScalars.unpack(rows.numpy())
    assert list(sc._fields) == list(scan_driver.ChunkScalars._fields)
    assert sc.pose.dtype == np.float32 and sc.pose.shape == (n - 1, 4, 4)
    np.testing.assert_array_equal(sc.pose[-1], st.pose.numpy())
    assert sc.success.dtype == bool and sc.num_inliers.dtype == np.int64
    assert int(sc.map_size[-1]) == int(st.map.size)
    assert int(sc.is_keyframe.sum()) == int(sr.count)


# ---- the chunk against the reference's per-frame driver --------------------

def _injected_chunk(cfg, frames, sizes, enable_ba):
    """The port's chunk with each frame's RANSAC drawn from the
    reference's samples (tests/test_torch_slam.py injects them the same
    way into the per-frame driver)."""
    step = tracker._step_impl

    def injected(state, img, cfg, ops, pose_fn=None):
        return step(state, img, cfg, ops,
                    pose_fn=_reference_samples(int(state.frame_idx)))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(scan_driver.tracker, "_step_impl", injected)
        return _chunked(cfg, frames, sizes, enable_ba)


def assert_chunk_matches_reference(ref, port):
    """Per-frame decisions equal, inlier counts and map sizes within +-2,
    poses to 1e-3 up to the first accepted BA event and 5e-3 after, and
    the BA events' outcomes equal."""
    rows = [r for r in ref.metrics.records
            if r.get("kind") == "frame" and "success" in r]
    assert len(rows) == len(port["rows"])
    for x, y in zip(rows, port["rows"]):
        x = _as_inserted(x)
        for k in ("keyframe", "success", "ran_maintenance"):
            assert x[k] == y[k], (x["frame"], k, x[k], y[k])
        for k in ("num_inliers", "map_size"):
            assert abs(x[k] - y[k]) <= 2, (x["frame"], k, x[k], y[k])
    events = [r for r in ref.metrics.records if r.get("kind") == "ba"]
    assert _ba_outcomes(events) == _ba_outcomes(port["ba"])
    accepted = [e["frame"] for e in events if e["ba_result_accepted"]]
    first = min(accepted) if accepted else len(rows)
    err = np.abs(ref.poses() - port["poses"]).max(axis=(1, 2))
    assert err[:first + 1].max() <= 1e-3, err
    assert err.max() <= 5e-3, err
