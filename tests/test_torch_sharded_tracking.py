"""The port's SLAM system with the map sharded over 2 and 4 CPU ranks
(``SLAMSystem(mesh=)``, BASELINE config 4), against the reference's
unsharded system and the port's single-device one
(tests/sharded_cases.py runs both groups once).

  * With hypothesis sharding on (the default) and the reference's RANSAC
    samples injected, 12 frames with BA on are held to the reference's
    unsharded ``SLAMSystem`` with tests/test_sharded_tracking.py's bounds:
    num_matches and success equal, inliers and associations within 3, map
    size within 8, poses within 5e-3.
  * With it off, every non-map stage is replicated and the map collectives
    are exact, so the runs at D = 2 and D = 4 are bit-identical to the
    port's single-device run: poses and every per-frame count. Then
    ``run_global_ba(mesh=)``'s sharded solve is held to the single-device
    solve of the same problem with tests/test_torch_ba.py's bounds.
  * Checkpoints with a mesh: ``save_state`` partway through that run
    writes what a single-device save writes, and a fresh meshed system
    loaded from it finishes the run as the uninterrupted one does.
  * Every rank holds the same trajectory (the host decisions read only
    replicated values).
  * ``process`` on the mesh, through ``scan_driver.track_frame`` (the
    plumbing that replays the step graph on an NCCL mesh, eager here),
    equals the frozen eager mesh path (``torch_frozen.EagerProcess``)
    frame by frame, with window BA, structure refinement and maintenance
    in the run, hypothesis sharding on and off; gloo's collectives are
    not captured (``mesh.capturable`` says no, ``step_graph`` refuses the
    mesh, the system has no step graph).
  * Maintenance through the sharded map: capacity 128 in 32-slot shards
    over 4 ranks, 22 frames: maintenance runs, no insert drops, and the
    run is bit-identical to the single-device port.
  * ``cli run --mesh 2`` on the CPU spawns its ranks and writes its
    outputs.
"""
import json

import numpy as np
import pytest

from tests import sharded_cases
from vslam_tpu_torch import cli

D_ALL = (2, 4)


@pytest.fixture(scope="module")
def res(tmp_path_factory):
    return sharded_cases.results(tmp_path_factory)


@pytest.mark.parametrize("D", D_ALL)
def test_sharded_tracking_matches_reference(res, D):
    ref = res["ref"]["slam"]
    got = res[f"d{D}"][0]["slam_hyp"]
    for a, b in zip(ref["infos"][1:], got["infos"][1:]):
        assert a["num_matches"] == b["num_matches"], (a, b)
        assert a["success"] == b["success"], (a, b)
        assert abs(a["num_inliers"] - b["num_inliers"]) <= 3, (a, b)
        assert abs(a["num_associated"] - b["num_associated"]) <= 3, (a, b)
        assert abs(a["map_size"] - b["map_size"]) <= 8, (a, b)
    assert len(got["infos"]) == len(ref["infos"]) == 12
    np.testing.assert_allclose(got["poses"], ref["poses"], atol=5e-3)
    assert any(x.get("keyframe") for x in got["infos"][1:])       # premise


@pytest.mark.parametrize("D", D_ALL)
def test_bit_identical_when_replicated(res, D):
    want = res["port"]["slam_off"]
    got = res[f"d{D}"][0]["slam_off"]
    np.testing.assert_array_equal(got["poses"], want["poses"])
    assert got["infos"] == want["infos"]
    assert got["events"] == want["events"]
    assert got["map_size"] == want["map_size"]         # the global cursor


@pytest.mark.parametrize("D", D_ALL)
def test_ranks_agree(res, D):
    ranks = res[f"d{D}"]
    for key in ("slam_hyp", "slam_off"):
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[key]["poses"],
                                          ranks[0][key]["poses"])
            assert r[key]["infos"] == ranks[0][key]["infos"]


@pytest.mark.parametrize("D", D_ALL)
def test_sharded_global_ba(res, D):
    got = res[f"d{D}"][0]["slam_off"]
    st, ref = got["global_stats"], got["global_ref"]
    np.testing.assert_array_equal(st["accepted"], ref["accepted"])
    np.testing.assert_allclose(st["initial_cost"], ref["initial_cost"],
                               rtol=1e-5)
    np.testing.assert_allclose(st["costs"], ref["costs"], rtol=1e-5)
    np.testing.assert_allclose(got["global_T_cw"], got["global_ref_T_cw"],
                               atol=1e-5)
    assert st["final_cost"] < st["initial_cost"]
    cov = got["global_coverage"]
    assert cov["dropped_points"] == cov["dropped_obs"] == 0
    assert np.isfinite(got["global_kf"]).all()


@pytest.mark.parametrize("D", D_ALL)
def test_sharded_checkpoint_resume(res, D):
    """save_state before frame 7 of the sharded run writes the file a
    single-device save writes (values: a gathered -0.0 comes back +0.0);
    every rank's fresh meshed system loaded from it re-shards the map and
    finishes the run as the uninterrupted one does, window BA included."""
    want = res["port"]["slam_off"]["ckpt"]
    for r in res[f"d{D}"]:
        arrays, meta = r["slam_off"]["ckpt"]
        assert meta == want[1]
        assert arrays.keys() == want[0].keys()
        for k, v in want[0].items():
            np.testing.assert_array_equal(arrays[k], v, err_msg=k)
        full, resumed = r["slam_off"], r["resumed"]
        start = len(full["infos"]) - len(resumed["infos"])
        assert start == meta["frame_idx"] == 7
        np.testing.assert_array_equal(resumed["poses"], full["poses"])
        assert resumed["infos"] == full["infos"][start:]
        after = [e for e in full["events"] if e["frame"] >= start]
        assert resumed["events"] == after
        assert any(e["kind"] == "ba" for e in after)             # premise


@pytest.mark.parametrize("D", D_ALL)
@pytest.mark.parametrize("hyp", [True, False])
def test_sharded_process_matches_frozen_eager(res, D, hyp):
    for rank in res[f"d{D}"]:
        got = rank["process"][hyp]
        assert got["premises"] is None, got["premises"]
        assert got["differs"] is None, got["differs"]
    ranks = [r["process"][hyp]["poses"] for r in res[f"d{D}"]]
    for poses in ranks[1:]:
        np.testing.assert_array_equal(poses, ranks[0])


@pytest.mark.parametrize("D", D_ALL)
def test_gloo_mesh_is_not_captured(res, D):
    for rank in res[f"d{D}"]:
        assert rank["capturable"] is False
        assert rank["step_graph_refused"] is True
        assert all(x["step_graph"] is None
                   for x in rank["process"].values())


def test_sharded_tracking_through_maintenance(res):
    got = res["d4"][0]["maint"]
    want = res["port"]["maint"]
    assert got["maintenance_runs"] >= 1, "premise: maintenance must trigger"
    assert got["dropped"] == 0
    assert got["maintenance_runs"] == want["maintenance_runs"]
    np.testing.assert_array_equal(got["poses"], want["poses"])
    assert got["infos"] == want["infos"]


def test_cli_mesh_flag(tmp_path):
    out = tmp_path / "out"
    rc = cli.main(["run", "--synthetic", "--small", "--frames", "8",
                   "--mesh", "2", "--seed", "3", "--device", "cpu",
                   "--out", str(out)])
    assert rc == 0
    summary = json.loads((out / "summary.json").read_text())
    assert summary["frames"] == 8 and summary["map_points"] > 0
    assert summary["ate_rmse"] < 0.5
