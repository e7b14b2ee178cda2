"""The port's sharded primitives (vslam_tpu_torch.parallel) on spawned CPU
process groups of 2 and 4 ranks (gloo), against the reference's sharded
and single-device functions on the 8-device virtual mesh
(tests/sharded_cases.py builds the inputs and runs both groups once).

Tolerances are those the reference suite asserts between its sharded and
unsharded runs (tests/test_parallel.py), and tests/test_torch_ba.py's for
the solve:
  * association: point ids and distances exactly equal;
  * the shard-local map operations, gathered back: every field of the map,
    the alive count and the gathered rows exactly equal to the reference's
    single-device ``point_map`` results;
  * hypothesis-sharded pose RANSAC on the reference's (512, 8) batch:
    inlier masks agree on > 99% of matches, R and t within 1e-3, against
    the reference's ``ransac_pose`` and the port's single-device run;
  * sharded fundamental RANSAC: precision > 0.9, recall > 0.7;
  * landmark-sharded BA: accept flags equal, costs to 1e-5 relative, T_cw
    to 1e-5, live points to 1e-3, against the reference's sharded solve
    and the port's single-device solve. The D = 2 group joined through
    ``multihost.initialize`` from torchrun's environment variables, so it
    also holds tests/test_multiprocess.py's check (two processes, cameras
    within 1e-3 of the single-device solve).
"""
import numpy as np
import pytest
import torch

from tests import sharded_cases
from vslam_tpu_torch.parallel import mesh as mesh_mod

D_ALL = (2, 4)


@pytest.fixture(scope="module")
def res(tmp_path_factory):
    return sharded_cases.results(tmp_path_factory)


@pytest.mark.parametrize("D", D_ALL)
def test_association_exact(res, D):
    want = res["ref"]["assoc"]
    np.testing.assert_array_equal(want[0], res["ref"]["assoc_single"][0])
    for rank in res[f"d{D}"]:
        pid, dist = rank["assoc"]
        np.testing.assert_array_equal(pid, want[0])
        np.testing.assert_array_equal(dist, want[1])
    assert int((want[0] >= 0).sum()) > 40                     # premise


@pytest.mark.parametrize("D", D_ALL)
def test_map_ops_exact(res, D):
    want = res["ref"]["mapops"]
    for rank, got in enumerate(r["mapops"] for r in res[f"d{D}"]):
        for k, w in want["map"].items():
            g = got["map"][k]
            assert g.shape == w.shape and g.dtype == w.dtype, k
            np.testing.assert_array_equal(g, w, err_msg=k)
        assert got["alive"] == want["alive"]
        np.testing.assert_array_equal(got["rows"], want["rows"])
        np.testing.assert_array_equal(got["prov"], want["prov"])
        assert got["local_capacity"] == 1024 // D
        assert got["local_size"] == int(want["map"]["size"])
    # premises: the insert crossed the last shard boundaries and overflowed
    # the capacity; dead slots are left out of the count
    assert int(want["map"]["size"]) == 1024
    assert want["alive"] < 1024


def _assert_pose_agrees(got, want):
    agree = (got["inliers"] == want["inliers"]).mean()
    assert agree > 0.99, agree
    np.testing.assert_allclose(got["R"], want["R"], atol=1e-3)
    np.testing.assert_allclose(got["t"], want["t"], atol=1e-3)


@pytest.mark.parametrize("D", D_ALL)
def test_pose_hypsharded_selects_same_model(res, D):
    for rank in res[f"d{D}"]:
        got = rank["pose"]
        assert bool(got["success"])
        _assert_pose_agrees(got, res["ref"]["pose"])
        _assert_pose_agrees(got, res["port"]["pose"])


@pytest.mark.parametrize("D", D_ALL)
def test_fundamental_sharded_quality(res, D):
    true_inl = res["fund_vis"] & ~res["fund_outliers"]
    for rank in res[f"d{D}"]:
        inl = rank["fund"]["inliers"]
        assert rank["fund"]["success"]
        precision = (inl & true_inl).sum() / max(inl.sum(), 1)
        recall = (inl & true_inl).sum() / max(true_inl.sum(), 1)
        assert precision > 0.9, precision
        assert recall > 0.7, recall
    np.testing.assert_array_equal(res[f"d{D}"][0]["fund"]["inliers"],
                                  res[f"d{D}"][-1]["fund"]["inliers"])


def _assert_solves_agree(got, want):
    """tests/test_torch_ba.py's bounds."""
    np.testing.assert_array_equal(got["accepted"], want["accepted"])
    np.testing.assert_allclose(got["initial_cost"], want["initial_cost"],
                               rtol=1e-5)
    np.testing.assert_allclose(got["costs"], want["costs"], rtol=1e-5)
    np.testing.assert_allclose(got["final_cost"], want["final_cost"],
                               rtol=1e-5)
    np.testing.assert_allclose(got["T_cw"], want["T_cw"], atol=1e-5)
    live = want["point_mask"]
    np.testing.assert_array_equal(got["point_mask"], live)
    np.testing.assert_allclose(got["points"][live], want["points"][live],
                               atol=1e-3)


@pytest.mark.parametrize("D", D_ALL)
def test_sharded_ba_matches_reference(res, D):
    for rank in res[f"d{D}"]:
        got = rank["ba"]
        _assert_solves_agree(got, res["ref"]["ba_sharded"])
        _assert_solves_agree(got, res["port"]["ba"])
        assert np.abs(got["T_cw"] - res["port"]["ba"]["T_cw"]).max() < 1e-3
    assert got["final_cost"] < 0.1 * got["initial_cost"]          # premise


def test_make_mesh_refuses_without_its_backend():
    """No silent fallback: on this CPU-only torch, a ``cuda`` mesh raises
    (NCCL is missing) and a multi-rank mesh without a process group
    raises; neither creates a group."""
    import torch.distributed as dist

    with pytest.raises(RuntimeError, match="NCCL"):
        mesh_mod.make_mesh("map", 1, device_type="cuda")
    with pytest.raises(RuntimeError, match="no process group"):
        mesh_mod.make_mesh("map", 2, device_type="cpu")
    assert not dist.is_initialized()
    assert mesh_mod.pad_to_multiple(130, 64) == 192
    assert torch.equal(mesh_mod.replicated(None, torch.ones(2)),
                       torch.ones(2))


class _Graph:
    """Stands in for a captured CUDA graph: counts its ``reset``s."""

    def __init__(self):
        self.resets = 0

    def reset(self):
        self.resets += 1


def test_shutdown_frees_graphs_that_captured_collectives():
    """``multihost.shutdown`` frees every live graph noted by
    ``mesh.keep_captured`` (NCCL's teardown waits for them), whoever
    holds it, once, and forgets graphs nothing holds; with no group it
    leaves nothing."""
    import gc

    import torch.distributed as dist
    from vslam_tpu_torch.parallel import multihost

    held, dropped = _Graph(), _Graph()
    mesh_mod.keep_captured(held)
    mesh_mod.keep_captured(dropped)
    del dropped
    gc.collect()
    multihost.shutdown()
    assert held.resets == 1
    assert mesh_mod.free_captured() == 0         # nothing noted is left
    assert held.resets == 1
    assert not dist.is_initialized()


def test_cli_mesh_run_leaves_the_group_when_it_raises(monkeypatch, tmp_path):
    """``cli run --mesh`` leaves the group (``multihost.shutdown``) also
    when the run raises, and the error reaches the caller."""
    from vslam_tpu_torch import cli
    from vslam_tpu_torch.parallel import multihost

    calls = []

    def fail(args):
        raise RuntimeError("planted")

    monkeypatch.setattr(cli, "_run", fail)
    monkeypatch.setattr(multihost, "shutdown", lambda: calls.append(1))
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="planted"):
        cli.main(["run", "--synthetic", "--small", "--mesh", "1",
                  "--device", "cpu", "--out", str(tmp_path)])
    assert calls == [1]
