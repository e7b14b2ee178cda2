"""The port's command line (python -m vslam_tpu_torch.cli) against the
reference's, on the CPU: the synthetic run writes every output the
reference writes, ``eval`` prints the reference's numbers, and the
configuration precedence of tests/test_cli.py holds."""
import argparse
import dataclasses
import json

import numpy as np
import pytest
import torch

from vslam_tpu import cli as jcli
from vslam_tpu.utils import trajectory as jtrajectory
from vslam_tpu_torch import cli
from vslam_tpu_torch.config import CameraConfig, VSLAMConfig
from vslam_tpu_torch.datasets import synthetic

torch.set_num_threads(2)

OUTPUTS = ("trajectory_tum.txt", "trajectory_kitti.txt", "map.png",
           "map.html", "map.ply", "metrics.jsonl", "summary.json")
RUN = ["run", "--synthetic", "--small", "--frames", "8", "--synthetic-points",
       "1500"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for name, main, extra in (("port", cli.main, ["--device", "cpu"]),
                              ("ref", jcli.main, [])):
        d = tmp_path_factory.mktemp(name)
        assert main(RUN + extra + ["--out", str(d)]) == 0
        out[name] = d
    return out


def test_run_synthetic_writes_every_output(runs):
    for name in OUTPUTS:
        assert (runs["port"] / name).stat().st_size > 0, name
    summary = json.loads((runs["port"] / "summary.json").read_text())
    want = json.loads((runs["ref"] / "summary.json").read_text())
    assert set(summary) == set(want)
    assert summary["frames"] == want["frames"] == 8
    assert summary["ate_rmse"] < 0.5 and summary["map_points"] > 0
    _, est = jtrajectory.load_tum(str(runs["port"] / "trajectory_tum.txt"))
    assert est.shape == (8, 4, 4) and np.isfinite(est).all()
    rows = [json.loads(line) for line in
            (runs["port"] / "metrics.jsonl").read_text().splitlines()]
    assert [r["frame"] for r in rows if r["kind"] == "frame"] == list(range(8))


def test_eval_prints_the_reference_numbers(tmp_path, capsys):
    gt = synthetic.make_trajectory(20, step=0.5, seed=1)
    est = gt.copy()
    rng = np.random.RandomState(0)
    est[:, :3, 3] = 1.3 * est[:, :3, 3] + rng.randn(20, 3) * 0.05
    jtrajectory.save_tum(str(tmp_path / "gt.txt"), gt)
    jtrajectory.save_tum(str(tmp_path / "est.txt"), est)
    args = ["eval", "--est", str(tmp_path / "est.txt"),
            "--gt", str(tmp_path / "gt.txt")]
    printed = []
    for main, extra in ((cli.main, ["--device", "cpu"]), (jcli.main, [])):
        capsys.readouterr()
        assert main(args + extra) == 0
        printed.append(json.loads(capsys.readouterr().out))
    got, want = printed
    assert set(got) == set(want) == {"ate_rmse", "rpe_trans", "rpe_rot_deg"}
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-9, k
    assert want["ate_rmse"] > 0.01                                # premise


def test_mesh_is_refused(monkeypatch):
    """``--platform`` is not the port's flag; ``--mesh N`` on CUDA with
    fewer than N devices (one, whatever the host has) exits 2 before
    spawning anything."""
    with pytest.raises(SystemExit):
        cli.main(["run", "--synthetic", "--mesh", "4", "--platform", "cpu"])
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert cli.main(["run", "--synthetic", "--mesh", "2",
                     "--device", "cuda"]) == 2


def _args(**kw):
    ns = argparse.Namespace(small=False, config=None, no_ba=False)
    for k, v in kw.items():
        setattr(ns, k, v)
    return ns


def test_dataset_camera_overrides_json_config(tmp_path):
    """tests/test_cli.py: --config JSON must not clobber the dataset's
    calibration."""
    cfg_json = VSLAMConfig().replace(
        camera=CameraConfig(width=64, height=48, fx=1.0, fy=1.0, cx=1.0,
                            cy=1.0))
    p = tmp_path / "cfg.json"
    p.write_text(cfg_json.to_json())
    ds_cam = CameraConfig(width=1241, height=376, fx=718.0, fy=718.0,
                          cx=607.0, cy=185.0)
    cfg = cli._build_cfg(_args(config=str(p)), camera=ds_cam)
    assert cfg.camera == ds_cam
    assert cfg.frontend == cfg_json.frontend


def test_json_config_applies_without_dataset():
    assert cli._build_cfg(_args()) == VSLAMConfig()


def test_stream_viewer(tmp_path):
    """tests/test_cli.py's MapStream case on the port's copy: deltas
    replay to the final cloud, and a shrinking cloud writes a reset."""
    from vslam_tpu_torch.viz.stream import MapStream

    st = MapStream(str(tmp_path))
    for frame, (n, k) in enumerate(((4, 2), (7, 3), (2, 4)), 1):
        st.update({"points": np.arange(3 * n, dtype=np.float32).reshape(n, 3),
                   "colors": np.full((n, 3), 0.5, np.float32),
                   "poses": np.tile(np.eye(4, dtype=np.float32), (k, 1, 1))},
                  frame=frame)
    recs = [json.loads(line) for line in
            (tmp_path / "stream.jsonl").read_text().splitlines()]
    pts = []
    for rec in recs:
        if rec.get("reset"):
            pts = []
        pts.extend(rec.get("points", []))
    assert len(pts) == 2 and any(r.get("reset") for r in recs)
    assert [len(r["points"]) for r in recs[:2]] == [4, 3]
    assert (tmp_path / "live.html").exists()


def test_run_with_both_frontend_variants(tmp_path):
    """``run --config F.json`` whose frontend section turns on ``oriented``
    and ``track_carry`` tracks the synthetic sequence and writes
    summary.json. F.json is the small config with the two flags (a JSON
    config replaces the whole config, so a frontend-only file would run
    the full-size defaults)."""
    from vslam_tpu_torch.config import small_config

    cfg = small_config()
    cfg = cfg.replace(frontend=dataclasses.replace(
        cfg.frontend, oriented=True, track_carry=True))
    p = tmp_path / "F.json"
    p.write_text(cfg.to_json())
    assert json.loads(p.read_text())["frontend"]["oriented"] is True
    out = tmp_path / "out"
    assert cli.main(RUN + ["--device", "cpu", "--config", str(p),
                           "--out", str(out)]) == 0
    summary = json.loads((out / "summary.json").read_text())
    assert summary["frames"] == 8 and summary["map_points"] > 0
    assert summary["ate_rmse"] < 0.5


def test_run_without_matplotlib(tmp_path, monkeypatch, capsys):
    """Where matplotlib is not installed the run writes every other output
    and says that it skipped map.png (``viz.render.render_png`` imports
    matplotlib; the rest needs only numpy)."""
    import sys

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    run = ["run", "--synthetic", "--small", "--frames", "4",
           "--synthetic-points", "1500", "--device", "cpu"]
    assert cli.main(run + ["--out", str(tmp_path)]) == 0
    assert "map.png not written" in capsys.readouterr().err
    assert not (tmp_path / "map.png").exists()
    for name in OUTPUTS:
        if name != "map.png":
            assert (tmp_path / name).stat().st_size > 0, name
