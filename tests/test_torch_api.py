"""The port's small public helpers against the JAX reference on the CPU:
camera projection, ``transform_points``, the ``MapState`` column views,
``FrameFeatures.capacity``, ``TwoViewResult`` and ``print_trace_summary``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vslam_tpu.core import camera as jcam
from vslam_tpu.core import lie as jlie
from vslam_tpu.core import types as jtypes
from vslam_tpu_torch import interop
from vslam_tpu_torch.core import camera as cam
from vslam_tpu_torch.core import lie
from vslam_tpu_torch.core import types
from vslam_tpu_torch.utils import profiling

ATOL = 1e-5


def _poses(rng, n):
    xi = (rng.randn(n, 6) * [0.5, 0.5, 0.5, 0.2, 0.2, 0.2]).astype(np.float32)
    return np.array(jlie.se3_exp(jnp.asarray(xi)))


@pytest.fixture
def scene():
    rng = np.random.RandomState(11)
    K = np.array([[500.0, 0, 320], [0, 480.0, 240], [0, 0, 1]], np.float32)
    X = (rng.randn(2, 64, 3) * [4.0, 3.0, 2.0] + [0, 0, 9.0]).astype(
        np.float32)
    X[0, :3, 2] = [0.0, 1e-12, -1e-10]      # depths at the safe division
    uv = (rng.rand(2, 64, 2) * [640, 480]).astype(np.float32)
    depth = (rng.rand(2, 64) * 20 + 0.5).astype(np.float32)
    return K, _poses(rng, 2), X, uv, depth


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=1e-6)


def test_K_matrix_matches_reference():
    got = cam.K_matrix(500.0, 480.0, 320.5, 240.25)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jcam.K_matrix(500.0, 480.0, 320.5, 240.25)))


def test_projection_functions_match_reference(scene):
    K, T_wc, X, uv, depth = scene
    t = torch.from_numpy
    P = cam.projection_matrix(t(K), t(T_wc))
    Pj = jcam.projection_matrix(jnp.asarray(K), jnp.asarray(T_wc))
    _close(P, Pj)
    got_uv, got_z = cam.project(P, t(X))
    want_uv, want_z = jcam.project(Pj, jnp.asarray(X))
    # relative: the near-zero depths divide by 1e-9
    np.testing.assert_allclose(got_uv.numpy(), np.asarray(want_uv),
                               rtol=1e-5, atol=ATOL)
    _close(got_z, want_z)
    got_uv, got_z = cam.project_camframe(t(K), t(X))
    want_uv, want_z = jcam.project_camframe(jnp.asarray(K), jnp.asarray(X))
    np.testing.assert_allclose(got_uv.numpy(), np.asarray(want_uv),
                               rtol=1e-5, atol=ATOL)
    _close(got_z, want_z)
    assert np.isfinite(got_uv.numpy()).all()

    K_inv = np.linalg.inv(K).astype(np.float32)
    _close(cam.backproject(t(K_inv), t(uv), t(depth)),
           jcam.backproject(jnp.asarray(K_inv), jnp.asarray(uv),
                            jnp.asarray(depth)))
    _close(cam.pixel_to_normalized(t(K_inv), t(uv)),
           jcam.pixel_to_normalized(jnp.asarray(K_inv), jnp.asarray(uv)))


@pytest.mark.parametrize("margin", [0.0, 17.0])
def test_in_image_matches_reference(scene, margin):
    rng = np.random.RandomState(3)
    uv = (rng.rand(500, 2) * [700, 540] - [30, 30]).astype(np.float32)
    uv[:4] = [[0, 0], [640, 100], [17, 463], [639.9, 479.9]]  # the edges
    got = cam.in_image(torch.from_numpy(uv), 640, 480, margin)
    want = jcam.in_image(jnp.asarray(uv), 640, 480, margin)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_transform_points_matches_reference(scene):
    _, T_wc, X, _, _ = scene
    _close(lie.transform_points(torch.from_numpy(T_wc), torch.from_numpy(X)),
           jlie.transform_points(jnp.asarray(T_wc), jnp.asarray(X)))


def test_map_views_match_reference():
    """Each column view of a reference map converted by ``from_jax`` equals
    the reference's view, bit for bit."""
    rng = np.random.RandomState(5)
    m = jtypes.empty_map(64, 4).replace(
        pt=jnp.asarray(rng.randn(64, jtypes.PT_COLS).astype(np.float32)))
    tree = jax.tree_util.tree_map(np.asarray, m)
    port = interop.from_jax(tree, types.MapState)
    for name in ("xyz", "color", "conf", "first_uv", "first_C", "first_P"):
        got, want = getattr(port, name), np.asarray(getattr(m, name))
        assert tuple(got.shape) == want.shape, name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    assert port.capacity == m.capacity and port.obs_slots == m.obs_slots


def test_frame_features_and_two_view_result():
    jf = jtypes.empty_features(37)
    pf = types.empty_features(37, "cpu")
    assert pf.capacity == jf.capacity == 37
    assert [f.name for f in dataclasses.fields(types.TwoViewResult)] \
        == [f.name for f in dataclasses.fields(jtypes.TwoViewResult)]
    z = torch.zeros(())
    r = types.TwoViewResult(
        matches=torch.zeros((5, 2), dtype=torch.int32),
        match_mask=torch.ones(5, dtype=torch.bool), F=torch.eye(3),
        E=torch.eye(3), R=torch.eye(3), t=torch.zeros(3),
        num_inliers=z.int(), success=z.bool())
    assert r.replace(num_inliers=torch.tensor(4)).num_inliers == 4


def test_print_trace_summary(tmp_path, capsys):
    """One line per event name of a CPU trace, by total time."""
    with profiling.device_trace(str(tmp_path)):
        a = torch.randn(128, 128)
        for _ in range(3):
            a = torch.relu(a @ a)
    profiling.print_trace_summary(str(tmp_path), top=5)
    lines = capsys.readouterr().out.splitlines()
    rows = profiling.summarize_trace(str(tmp_path), top=5)
    assert 0 < len(lines) == len(rows) <= 5
    for line, (name, ms, cnt) in zip(lines, rows):
        assert line.split()[0] == f"{ms:.2f}" and f"x{cnt:5d}" in line
        assert line.endswith(name[:110])
    assert any("relu" in name for name, _, _ in
               profiling.summarize_trace(str(tmp_path), top=100))
