"""The port's long-run and BA tools (``vslam_tpu_torch.tools``) on the CPU,
against the repository's ``bench_ba.py`` and ``scripts/endurance*.py``:
``make_problem`` equal to the reference's, the assembly race, the scaling
model's formula, the sharded-solver parity on gloo ranks, the endurance
reports' keys against the reference artifacts', and each ``check``
against the reference's own reports."""
import copy
import json
import pathlib

import numpy as np
import pytest
import torch

import bench_ba as ref_bench
from vslam_tpu_torch.tools import bench_ba, endurance, endurance_device

REPO = pathlib.Path(__file__).resolve().parents[1]
ARTIFACTS = REPO / "artifacts"


def _load(name):
    return json.loads((ARTIFACTS / name / "endurance.json").read_text())


@pytest.mark.parametrize("corridor", [False, True], ids=["box", "corridor"])
def test_make_problem_matches_reference(corridor):
    want, want_K = ref_bench.make_problem(4, 256, 8, corridor=corridor)
    got, got_K = bench_ba.make_problem(4, 256, 8, corridor=corridor)
    np.testing.assert_array_equal(got_K, want_K)
    for f in ("obs_cam", "obs_mask", "obs_uv", "points", "point_mask",
              "cam_fixed", "cam_mask"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    np.testing.assert_allclose(got.T_cw.numpy(), np.asarray(want.T_cw),
                               atol=1e-6)
    assert got.obs_mask.sum() > 256 and got.point_mask.any()


def test_race_on_the_cpu():
    """Both assemblies solve the same problem to the same cost."""
    problem, K = bench_ba.make_problem(4, 256, 8)
    race = bench_ba.race_assemblies(problem, K)
    o, s = race["onehot"], race["scatter"]
    assert o["initial_cost"] == s["initial_cost"]
    assert abs(o["final_cost"] - s["final_cost"]) <= 1e-5 * s["final_cost"]
    assert o["final_cost"] < 0.1 * o["initial_cost"]
    for r in race.values():
        assert r["lm_iterations_per_sec"] > 0
        assert len(r["accepted"]) == 16
        assert r["accepted_steps"] == sum(r["accepted"])
    split = bench_ba.measure_breakdown(problem, K, "onehot")
    assert [r["stage"] for r in split] == [
        "gn+schur_assembly", "dense_camera_solve", "landmark_backsub",
        "cost_eval"]
    for r in split:          # no device time on the CPU: not measured
        assert r["device_ms"] is None and r["ms"] == round(r["host_ms"], 4)


def _lm_row(accepted, costs, initial):
    return {"accepted": accepted, "costs": costs, "initial_cost": initial}


@pytest.mark.parametrize("b,parted", [
    (_lm_row([True, True, False, False], [50.0, 40.0, 40.0, 40.0], 100.0),
     None),
    (_lm_row([True, False, True, False], [50.0, 50.0, 40.0, 40.0], 100.0),
     "iteration 1"),
    (_lm_row([True, True, True, False],
             [50.0, 40.0, 40.0 - 1e-6, 40.0 - 1e-6], 100.0), None),
    (_lm_row([True, True, True, True],
             [50.0, 40.0, 40.0 - 1e-6, 30.0], 100.0), "iteration 3"),
], ids=["equal", "parted", "tie", "moved-after-tie"])
def test_path_disagreement(b, parted):
    """Flags compared up to a rounding tie (a gain below 1e-6), and after
    one both runs must stay converged."""
    a = _lm_row([True, True, False, False], [50.0, 40.0, 40.0, 40.0], 100.0)
    got = bench_ba.path_disagreement(a, b)
    assert (got is None) if parted is None else got.startswith(parted), got


def test_scaling_model_is_the_reference_formula(monkeypatch):
    split = [{"stage": "a", "ms": 13.7457, "kind": "parallel"},
             {"stage": "b", "ms": 0.51, "kind": "replicated"},
             {"stage": "c", "ms": 0.3844, "kind": "parallel"}]
    monkeypatch.setattr(ref_bench, "ICI_BYTES_PER_S", 450e9)
    for cams in (20, 256):
        want = ref_bench.scaling_model(split, cams)
        got = bench_ba.scaling_model(split, cams, 450e9)
        assert got["link_bytes_per_sec"] == want.pop("ici_bytes_per_sec")
        rows = got.pop("rows")
        assert all(r.pop("kind") == "modeled" for r in rows)
        assert rows == want.pop("rows")
        got.pop("link_bytes_per_sec")
        assert got == want


def test_parity_on_gloo_ranks():
    problem, K = bench_ba.make_problem(4, 256, 8)
    out = bench_ba.parity(problem, K, ranks=(1, 2), timeout=600.0)
    assert [r["devices"] for r in out["parity"]] == [1, 2]
    for r in out["parity"]:
        assert r["max_Tcw_diff_vs_single"] < 1e-3
        assert abs(r["final_cost"] - out["single_final_cost"]) \
            <= 1e-4 * out["single_final_cost"]


@pytest.mark.parametrize("main", [bench_ba.main, endurance.main,
                                  endurance_device.main],
                         ids=["bench_ba", "endurance", "endurance_device"])
def test_tools_exit_2_without_a_card(main, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["--out", str(tmp_path / "x")]) == 2
    assert not any(tmp_path.iterdir())


def test_endurance_device_report_keys(tmp_path):
    """A 12-frame small-config run in chunks of 5: the reference artifact's
    keys plus ``device`` and ``window_ba_skipped``."""
    report, det = endurance_device.run("cpu", frames=12, out=str(tmp_path),
                                       chunk=5)
    want = set(_load("endurance_device_r05"))
    assert set(report) == want | {"device", "window_ba_skipped"}
    assert set(report["global_ba_coverage"]) == \
        set(_load("endurance_device_r05")["global_ba_coverage"])
    assert report["backend"] == "cpu" and report["driver"] == "chunked(5)"
    assert report["frames"] == 12 and report["success_rate"] == 1.0
    assert len(det["system"].poses()) == 12
    rows = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert sum('"kind": "frame"' in r for r in rows) == 12
    assert json.loads((tmp_path / "endurance.json").read_text()) == report


def test_endurance_report_keys(tmp_path):
    """A 12-frame run of each segment (revisit and sweep in chunks of
    10): the reference artifact's keys, ``fps_vs_map_size_cpu_host``
    renamed to ``fps_vs_map_size``, plus ``device``."""
    report = endurance.run("cpu", str(tmp_path), frames=12, seeds=(7,),
                           seed_frames=12, chunk=10, revisit_frames=12,
                           revisit_seeds=(2,))
    want = _load("endurance_r05")
    assert set(report) == (set(want) - {"fps_vs_map_size_cpu_host"}) \
        | {"fps_vs_map_size", "device"}
    assert [set(r) for r in report["fps_vs_map_size"]] == [
        {"frame", "map_size", "map_alive", "fps"}]
    assert set(report["seed_sweep"]) == set(want["seed_sweep"])
    assert set(report["seed_sweep"]["seeds"][0]) == \
        set(want["seed_sweep"]["seeds"][0])
    # frame rows after the bootstrap, as the reference counts them
    assert report["frames"] == 11 and report["success_rate"] == 1.0
    for name in ("revisit.json", "seeds.json", "summary.json",
                 "no_ba_control/summary.json"):
        assert (tmp_path / name).exists(), name


@pytest.mark.parametrize("name,check", [
    ("endurance_device_full_r05",
     lambda r: endurance_device.check(r, full=True)),
    ("endurance_device_r05", lambda r: endurance_device.check(r, full=False)),
    ("endurance_r05", endurance.check)])
def test_checks_accept_the_reference_reports(name, check):
    report = _load(name)
    check(report)
    bad = copy.deepcopy(report)
    bad["dropped_inserts_total"] = 1
    with pytest.raises(AssertionError, match="dropped_inserts_total"):
        check(bad)
