"""The port's front end (vslam_tpu_torch.frontend) against the reference.

The same rendered frames go through both frameworks. The shift-MAC filters
keep the reference's order of operations, so Sobel and blur are bit-exact
against the reference run op by op. The reference's ``detect`` runs under
``jax.jit``, where XLA fuses the corner-response arithmetic and rounds its
last bit differently; the sub-pixel offsets built on it then differ by an
ulp of the pixel coordinate. Hence keypoints are held to 2 f32 ulps of
their coordinate (3.1e-5 px at 256 px), and masks and descriptors exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vslam_tpu.config import small_config
from vslam_tpu.datasets import synthetic
from vslam_tpu.frontend import descriptors as jdesc
from vslam_tpu.frontend import features as jfeat
from vslam_tpu.frontend.frame import extract_features as jextract
from vslam_tpu_torch.frontend import descriptors, features
from vslam_tpu_torch.frontend.frame import extract_features

torch.set_num_threads(2)

CFG = small_config()
W, H = CFG.camera.width, CFG.camera.height


def _frames(n=3, seed=0):
    scene = synthetic.make_scene(num_points=600, seed=seed,
                                 extent=(14, 6, 40), z_min=6.0)
    poses = synthetic.make_trajectory(n, step=0.6, seed=seed)
    return synthetic.render_sequence(CFG.camera.K(), poses, scene, W, H)


@pytest.mark.parametrize("name", ["sobel_x", "sobel_y", "blur"])
def test_filters_bit_exact(name):
    img = _frames(1)[0]
    fn = {
        "sobel_x": lambda f, x: f.sobel_gradients(x)[0],
        "sobel_y": lambda f, x: f.sobel_gradients(x)[1],
        "blur": lambda f, x: f.gaussian_blur(x, CFG.frontend.blur_sigma),
    }[name]
    want = np.asarray(fn(jfeat, jnp.asarray(img)))
    got = fn(features, torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(got, want)


def test_corner_response_and_nms():
    img = _frames(1)[0]
    want = np.asarray(jfeat.corner_response(jnp.asarray(img)))
    got = features.corner_response(torch.from_numpy(img)).numpy()
    # op-by-op reference: only sqrt/ordering ulps differ
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-8)
    keep_j = np.asarray(jfeat.nms(jnp.asarray(want), 3))
    keep_t = features.nms(torch.tensor(want), 3).numpy()
    np.testing.assert_array_equal(keep_t, keep_j)


@pytest.mark.parametrize("seed", [0, 3])
def test_extract_features_matches_reference(seed):
    for img in _frames(2, seed):
        want = jextract(jnp.asarray(img), CFG.frontend, H, W)
        got = extract_features(torch.from_numpy(img), CFG.frontend, H, W)
        mask = np.asarray(want.mask)
        np.testing.assert_array_equal(got.mask.numpy(), mask)
        assert mask.sum() > 100
        ref_uv = np.asarray(want.uv)[mask]
        tol = 2 * np.spacing(np.abs(ref_uv).astype(np.float32))
        assert (np.abs(got.uv.numpy()[mask] - ref_uv) <= tol).all()
        np.testing.assert_array_equal(
            got.desc.numpy().view(np.uint32), np.asarray(want.desc))
        np.testing.assert_allclose(got.score.numpy()[mask],
                                   np.asarray(want.score)[mask], rtol=1e-5)


def test_dense_upright_brief_bit_exact_on_same_keypoints():
    """The port samples at the keypoints; the reference builds dense bit
    planes. On the same keypoints (incl. border and half-pixel ones) the
    descriptors agree bit for bit."""
    rng = np.random.RandomState(1)
    img = jfeat.gaussian_blur(jnp.asarray(_frames(1)[0]), 2.0)
    uv = np.concatenate([
        rng.uniform(0, [W, H], (200, 2)),
        [[0, 0], [W - 1, H - 1], [10.5, 20.5], [11.5, 3.5]]]).astype(
            np.float32)
    want = np.asarray(jdesc.describe_dense_upright(img, jnp.asarray(uv),
                                                   CFG.frontend))
    got = descriptors.describe_dense_upright(
        torch.tensor(np.asarray(img)), torch.from_numpy(uv),
        CFG.frontend)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_pack_unpack_bits_match_reference():
    rng = np.random.RandomState(2)
    bits = rng.rand(64, 256) < 0.5
    want = np.asarray(jdesc.pack_bits(jnp.asarray(bits)))
    packed = descriptors.pack_bits(torch.from_numpy(bits))
    np.testing.assert_array_equal(packed.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(
        descriptors.unpack_bits(packed).numpy(),
        np.asarray(jdesc.unpack_bits(jnp.asarray(want))))
    assert np.array_equal(descriptors.brief_pattern(),
                          jdesc.brief_pattern())
