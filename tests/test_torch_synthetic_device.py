"""The port's on-device renderer (vslam_tpu_torch.datasets.synthetic_device)
against the reference's on the same numpy arrays, and the statistics of
``make_corridor_scene_device`` (its random stream differs from the
reference's, so the scene is held to shapes, ranges and moments)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from vslam_tpu.datasets import synthetic as jsyn
from vslam_tpu.datasets import synthetic_device as jsd
from vslam_tpu_torch.config import small_config
from vslam_tpu_torch.datasets import synthetic_device

torch.set_num_threads(2)

CFG = small_config()
K = CFG.camera.K()
W, H = CFG.camera.width, CFG.camera.height


def _render_both(xyz, patches, Km, pose, w, h):
    want = np.asarray(jsd.render_frame_device(
        jnp.asarray(xyz), jnp.asarray(patches), jnp.asarray(Km),
        jnp.asarray(pose), w, h))
    got = synthetic_device.render_frame_device(
        torch.from_numpy(xyz), torch.from_numpy(patches),
        torch.from_numpy(Km), torch.from_numpy(pose), w, h).numpy()
    return want, got


def test_render_frame_device_matches_reference_without_overlap():
    """tests/test_loaders.py's no-overlap scene: every pixel to 2e-5
    against the reference's device renderer and its host renderer."""
    Km = np.array([[200.0, 0, 128], [0, 200.0, 96], [0, 0, 1]], np.float32)
    gx, gy = np.meshgrid(np.linspace(-4, 4, 4), np.linspace(-2.5, 2.5, 3))
    xyz = np.stack([gx.ravel(), gy.ravel(),
                    np.full(12, 20.0)], axis=1).astype(np.float32)
    base = jsyn.make_scene(num_points=12, seed=5)
    scene = jsyn.Scene(xyz=xyz, patches=base.patches, color=base.color)
    poses = jsyn.make_trajectory(3, step=0.5, seed=5).astype(np.float32)
    for i in range(3):
        want, got = _render_both(xyz, scene.patches, Km, poses[i], 256, 192)
        np.testing.assert_allclose(got, want, atol=2e-5)
        host = jsyn.render_frame(Km, poses[i], scene, 256, 192)
        np.testing.assert_allclose(got, host, atol=2e-5)
        assert (got != 0.35).mean() > 0.01                  # premise


def test_render_frame_device_matches_reference_with_overlap():
    """A corridor of 3000 landmarks (overlapping splats, z-buffer ties
    between landmarks are measure-zero): >= 99.9% of pixels to 2e-5 on
    every frame."""
    poses = jsyn.make_trajectory(12, step=0.6, seed=3).astype(np.float32)
    sc = jsyn.make_corridor_scene(poses, num_points=3000, seed=3)
    for i in range(0, 12, 3):
        want, got = _render_both(sc.xyz, sc.patches, K, poses[i], W, H)
        close = np.abs(got - want) <= 2e-5
        assert close.mean() >= 0.999, (i, close.mean())
        assert (want != 0.35).mean() > 0.3                  # premise: overlaps


def test_corridor_scene_device_statistics():
    """make_corridor_scene_device: deterministic given its generator, the
    reference's shapes and types, landmarks ahead of the trajectory, the
    smoothed binary texture and the X-junction of the host design, with
    moments close to the reference's own device scene."""
    poses = jsyn.make_trajectory(30, step=0.6, seed=1).astype(np.float32)
    P, ps = 20000, 9
    make = lambda seed: synthetic_device.make_corridor_scene_device(
        torch.Generator().manual_seed(seed), torch.from_numpy(poses), P)
    xyz, patches = make(4)
    x2, p2 = make(4)
    assert torch.equal(xyz, x2) and torch.equal(patches, p2)
    assert not torch.equal(make(5)[0], xyz)
    jx, jp = (np.asarray(a) for a in jsd.make_corridor_scene_device(
        jax.random.PRNGKey(4), jnp.asarray(poses), P))
    xyz, patches = xyz.numpy(), patches.numpy()
    assert xyz.shape == jx.shape == (P, 3) and xyz.dtype == jx.dtype
    assert patches.shape == jp.shape == (P, ps, ps)
    assert patches.dtype == jp.dtype
    c, q = ps // 2, 2
    for p in (patches, jp):
        hi = np.concatenate([p[:, c - q:c, c - q:c], p[:, c:c + q, c:c + q]],
                            axis=1)
        lo = np.concatenate([p[:, c - q:c, c:c + q], p[:, c:c + q, c - q:c]],
                            axis=1)
        assert hi.min() >= 0.9 and hi.max() <= 1.0
        np.testing.assert_allclose(lo, 1.0 - hi, atol=1e-6)
        # every quadrant cell of one landmark holds the same value
        assert np.ptp(hi.reshape(P, -1), axis=1).max() == 0.0
        body = p.copy()
        body[:, c - q:c + q, c - q:c + q] = np.nan
        body = body[~np.isnan(body)]
        assert body.min() >= 0.15 - 1e-6 and body.max() <= 0.85 + 1e-6
        # the 3x3 box mean of 0.15 / 0.85 cells takes 10 values
        assert len(np.unique(np.round(body * 9 / 0.7 - 0.15 * 9 / 0.7))) \
            <= 10
    np.testing.assert_allclose(patches.mean(), jp.mean(), atol=5e-3)
    np.testing.assert_allclose(patches.std(), jp.std(), atol=5e-3)
    # landmarks lie ahead of the path: depth along the anchor's forward
    # axis in [4, 45], lateral spread 14 and vertical 5 (Gaussian)
    for a in (xyz, jx):
        rel = a - poses[:, :3, 3].mean(0)
        assert np.isfinite(a).all()
        assert abs(a[:, 0].std() - jx[:, 0].std()) < 0.05 * jx[:, 0].std()
        assert abs(a[:, 1].std() - jx[:, 1].std()) < 0.05 * jx[:, 1].std()
        assert abs(rel[:, 2].mean() - (jx - poses[:, :3, 3].mean(0))[:, 2]
                   .mean()) < 0.5
