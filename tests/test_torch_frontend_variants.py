"""The port's front-end variants against the reference: mapped-track carry
(``refine_tracked``, ``detect_with_carry``), the intensity-centroid
orientations and steered BRIEF (``FrontendConfig.oriented``), their
dispatch in ``extract_features``, then ``track_step`` and the chunked
driver with both flags on.

Tolerances:
  * masks, keypoint order and carried-keypoint survival are exact;
    coordinates to 2 f32 ulps where the reference's jitted detector
    rounds its corner response differently (trap h, as in
    tests/test_torch_frontend.py), and exactly where both sides are fed
    the reference's own response;
  * the dense orientation map's moments are the reference's shift-MAC
    sums in the reference's order, so angles differ by atan2's ulps: 1e-5
    rad where the moment's magnitude exceeds 1e-2. The gather oracle sums
    961 samples in another order: 1e-3 rad where its moment exceeds 0.1
    (measured 1.6e-4; at 1e-2, 2.6e-3);
  * inside the reference's jitted ``extract_features`` / ``track_step``
    XLA fuses the moment sums and rounds them differently (trap h):
    angles there to 1e-4 rad over the same floor (measured 1.4e-5);
  * steered BRIEF rounds rotated offsets to the nearest pixel, and cos /
    sin differ by an ulp or so between the frameworks. A bit may differ
    only where ``torch_scenes.describe_ties`` finds a rounding tie that
    can flip it: within 5e-6 px (plus, where the two sides' angles differ,
    15 px times that difference: the pattern's reach) plus one f32 ulp of
    a half-integer. All other bits are exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_scenes as scenes

from tests.test_torch_tracker import _reference_samples
from vslam_tpu.config import small_config
from vslam_tpu.datasets import synthetic
from vslam_tpu.frontend import descriptors as jdesc
from vslam_tpu.frontend import features as jfeat
from vslam_tpu.frontend.frame import extract_features as jextract
from vslam_tpu.pipeline import tracker as jtracker
from vslam_tpu_torch.frontend import descriptors, features
from vslam_tpu_torch.frontend.frame import extract_features
from vslam_tpu_torch.pipeline import slam, tracker

torch.set_num_threads(2)

CFG = small_config()
FE = CFG.frontend
W, H = CFG.camera.width, CFG.camera.height
BOTH = CFG.replace(frontend=dataclasses.replace(FE, oriented=True,
                                                track_carry=True))
SLACK = 5e-6            # tie slack: the same angles fed to both sides
FLOOR = 1e-2            # centroid-moment magnitude below which angles drift
PATTERN = jdesc.brief_pattern(FE.descriptor_bits, FE.patch_radius)


def _frames(n=3, seed=0):
    scene = synthetic.make_scene(num_points=600, seed=seed,
                                 extent=(14, 6, 40), z_min=6.0)
    poses = synthetic.make_trajectory(n, step=0.6, seed=seed)
    return synthetic.render_sequence(CFG.camera.K(), poses, scene, W, H)


def _ulps2(got, want):
    return (np.abs(got - want) <= 2 * np.spacing(np.abs(want))).all()


def _carry(case, uv0, ok0, resp):
    """Predicted positions and mask of a carry scenario (numpy)."""
    n = uv0.shape[0]
    carry = uv0 + np.float32([1.0, 0.5])      # motion-model error shape
    mask = ok0.copy()
    if case == "background":
        # one live prediction on the flattest interior pixel: the
        # response / quality gates, not the mask, must reject it
        b = FE.border + 3
        inner = resp[b:-b, b:-b]
        y, x = np.unravel_index(np.argmin(np.abs(inner)), inner.shape)
        carry[n - 1] = [x + b, y + b]
        mask[n - 1] = True
    if case == "converging":
        # four carries predicted within a pixel of one corner: all but
        # the lowest index must yield
        for j in range(1, 5):
            carry[j] = uv0[0] + np.float32([0.3 * j, -0.2 * j])
            mask[j] = True
    return carry, mask


@pytest.mark.parametrize("case", ["offset", "background", "converging"])
def test_refine_tracked_exact_on_the_reference_response(case):
    """Fed the reference's response map, every output is bit-exact: the
    window gather, the first-index argmax and the sub-pixel offsets are
    the same f32 operations."""
    f = _frames(2)
    resp = np.asarray(jfeat.corner_response(jnp.asarray(f[1])))
    uv0, _, ok0 = (np.asarray(a) for a in
                   jfeat.detect(jnp.asarray(f[0]), FE, H, W))
    carry, mask = _carry(case, uv0, ok0, resp)
    want = jfeat.refine_tracked(jnp.asarray(resp), jnp.asarray(carry),
                                jnp.asarray(mask), FE.border, H, W)
    got = features.refine_tracked(torch.from_numpy(resp),
                                  torch.from_numpy(carry),
                                  torch.from_numpy(mask), FE.border, H, W)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert np.asarray(want[2]).sum() > 20                       # premise


@pytest.mark.parametrize("case", ["offset", "background", "converging"])
def test_detect_with_carry_matches_reference(case):
    """Masks and order exact, coordinates to 2 ulps, scores to 1e-5."""
    f = _frames(2)
    resp = np.asarray(jfeat.corner_response(jnp.asarray(f[1])))
    uv0, _, ok0 = (np.asarray(a) for a in
                   jfeat.detect(jnp.asarray(f[0]), FE, H, W))
    carry, mask = _carry(case, uv0, ok0, resp)
    want = [np.asarray(a) for a in jfeat.detect_with_carry(
        jnp.asarray(f[1]), FE, H, W, jnp.asarray(carry), jnp.asarray(mask))]
    got = [a.numpy() for a in features.detect_with_carry(
        torch.from_numpy(f[1]), FE, H, W, torch.from_numpy(carry),
        torch.from_numpy(mask))]
    ok = want[2]
    np.testing.assert_array_equal(got[2], ok)
    assert _ulps2(got[0][ok], want[0][ok])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5)
    assert ok.sum() > 100                                       # premise
    near = lambda p: np.abs(want[0][ok] - p).max(axis=1)
    if case == "background":
        assert near(carry[-1]).min() > 3.0
    if case == "converging":
        assert (near(want[0][ok][0]) <= FE.nms_radius).sum() == 1


def test_carried_keypoints_rank_by_index():
    """The reference's f32 priority sc + 1e9 rounds every carried score to
    one value, so the carried keypoints come first in carry-index order,
    not by score; the port keeps the collapse (a stable sort)."""
    f = _frames(2)
    uv0, sc0, ok0 = (np.asarray(a) for a in
                     jfeat.detect(jnp.asarray(f[0]), FE, H, W))
    sc_t = np.asarray(jfeat.refine_tracked(
        jfeat.corner_response(jnp.asarray(f[1])), jnp.asarray(uv0),
        jnp.asarray(ok0), FE.border, H, W)[1])
    assert len(set(np.float32(sc_t[ok0] + np.float32(1e9)))) == 1
    assert len(set(sc_t[ok0])) > 10                             # premise
    rev = slice(None, None, -1)                      # scores now ascending
    uv_r, ok_r = np.ascontiguousarray(uv0[rev]), np.ascontiguousarray(
        ok0[rev])
    got = features.detect_with_carry(torch.from_numpy(f[1]), FE, H, W,
                                     torch.from_numpy(uv_r),
                                     torch.from_numpy(ok_r))
    want = jfeat.detect_with_carry(jnp.asarray(f[1]), FE, H, W,
                                   jnp.asarray(uv_r), jnp.asarray(ok_r))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert _ulps2(got[0].numpy()[np.asarray(want[2])],
                  np.asarray(want[0])[np.asarray(want[2])])
    lead = got[1].numpy()[:20]
    assert not (np.diff(lead) <= 0).all()     # not sorted by score


def test_gather_samplers_match_reference():
    """Nearest sampling exact (round half to even, clip, flat index on both
    sides); bilinear to 1e-6 (the same f32 expression, op by op). The
    coordinates cover the borders, beyond them, integers and half-integers."""
    img = _frames(1)[0]
    rng = np.random.RandomState(6)
    y = np.concatenate([rng.uniform(-4, H + 4, 198), [0, H - 1, 2.5, -0.5,
                                                     H - 1.5, 7.0]])
    x = np.concatenate([rng.uniform(-4, W + 4, 198), [0, W - 1, 3.5, W - 0.5,
                                                     -2.0, 8.5]])
    y, x = (a.astype(np.float32).reshape(2, -1, 3) for a in (y, x))
    for name, tol in (("_gather_nearest", 0.0), ("_gather_bilinear", 1e-6)):
        want = np.asarray(getattr(jdesc, name)(
            jnp.asarray(img), jnp.asarray(y), jnp.asarray(x)))
        got = getattr(descriptors, name)(torch.from_numpy(img),
                                         torch.from_numpy(y),
                                         torch.from_numpy(x)).numpy()
        assert got.shape == want.shape == y.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=name)


def _moment_magnitude(img):
    m01, m10 = descriptors.centroid_moments(torch.from_numpy(img),
                                            FE.patch_radius)
    return torch.hypot(m01, m10).numpy()


def _oracle_magnitude(img, uv):
    """|(m01, m10)| of compute_orientations' circular patch, float64."""
    gy, gx, circ = descriptors._centroid_grids(FE.patch_radius)
    y = np.clip(np.round(uv[:, 1, None, None] + gy), 0, H - 1).astype(int)
    x = np.clip(np.round(uv[:, 0, None, None] + gx), 0, W - 1).astype(int)
    v = img[y, x].astype(np.float64) * circ
    return np.hypot((v * gy).sum(axis=(1, 2)), (v * gx).sum(axis=(1, 2)))


def _angle_diff(a, b):
    return np.abs(np.angle(np.exp(1j * (np.asarray(a, np.float64) - b))))


def test_orientations_match_reference():
    f = _frames(1)[0]
    blur = np.asarray(jfeat.gaussian_blur(jnp.asarray(f), FE.blur_sigma))
    strong = _moment_magnitude(blur) > FLOOR
    want = np.asarray(jdesc.orientation_map(jnp.asarray(blur),
                                            FE.patch_radius))
    got = descriptors.orientation_map(torch.from_numpy(blur),
                                      FE.patch_radius).numpy()
    assert _angle_diff(got, want)[strong].max() <= 1e-5
    assert strong.mean() > 0.5                                  # premise

    rng = np.random.RandomState(1)
    uv = np.concatenate([rng.uniform(0, [W, H], (300, 2)),
                         [[0, 0], [W - 1, H - 1], [10.5, 20.5]]]
                        ).astype(np.float32)
    xi = np.clip(np.round(uv[:, 0]).astype(int), 0, W - 1)
    yi = np.clip(np.round(uv[:, 1]).astype(int), 0, H - 1)
    at = descriptors.orientations_at(torch.from_numpy(blur),
                                     torch.from_numpy(uv), FE.patch_radius)
    want_at = np.asarray(jdesc.orientations_at(jnp.asarray(blur),
                                               jnp.asarray(uv),
                                               FE.patch_radius))
    assert _angle_diff(at.numpy(), want_at)[strong[yi, xi]].max() <= 1e-5
    oracle = descriptors.compute_orientations(
        torch.from_numpy(blur), torch.from_numpy(uv), FE.patch_radius)
    want_o = np.asarray(jdesc.compute_orientations(
        jnp.asarray(blur), jnp.asarray(uv), FE.patch_radius))
    strong_o = _oracle_magnitude(blur, uv) > 0.1
    assert _angle_diff(oracle.numpy(), want_o)[strong_o].max() <= 1e-3


def test_orientation_reference_cases_on_the_port():
    """tests/test_frontend.py's orientation cases on the port alone: the
    dense map rotates by exactly 90 degrees with the image, and tracks the
    circular-patch gather oracle within 15 degrees (median)."""
    rng = np.random.RandomState(4)
    img = np.cumsum(np.cumsum(rng.randn(128, 128).astype(np.float32), 0), 1)
    a0 = descriptors.orientation_map(torch.from_numpy(img), 15).numpy()
    a1 = descriptors.orientation_map(
        torch.from_numpy(np.rot90(img).copy()), 15).numpy()
    inner = slice(20, 108)
    d = _angle_diff(a1[inner, inner], np.rot90(a0)[inner, inner] - np.pi / 2)
    assert np.percentile(d, 90) < 1e-3, np.percentile(d, 90)

    rng = np.random.RandomState(3)
    img = (np.cumsum(np.cumsum(rng.randn(H, W).astype(np.float32), 0), 1)
           / 50.0)
    uv = np.stack([rng.uniform(30, W - 30, 64),
                   rng.uniform(30, H - 30, 64)], 1).astype(np.float32)
    ref = descriptors.compute_orientations(torch.from_numpy(img),
                                           torch.from_numpy(uv), 15).numpy()
    got = descriptors.orientations_at(torch.from_numpy(img),
                                      torch.from_numpy(uv), 15).numpy()
    assert np.median(_angle_diff(got, ref)) < np.deg2rad(15.0)


def _slack(angle_a, angle_b, uv_a, uv_b):
    """(N, 1) tie slack per keypoint for descriptors steered by two angles
    at two positions that may differ (by ulps)."""
    return (SLACK + 15.0 * _angle_diff(angle_a, angle_b)
            + np.abs(uv_a - uv_b).max(axis=1))[:, None]


def _assert_bits_equal_but_ties(got, want, blur, uv, angle, slack=SLACK):
    """Descriptor words (N, 8) equal except bits with a live rounding tie;
    returns the number of tied pairs."""
    gb = descriptors.unpack_bits(torch.from_numpy(got.view(np.int32)))
    wb = descriptors.unpack_bits(torch.from_numpy(
        np.ascontiguousarray(want).view(np.int32)))
    tied, live = scenes.describe_ties(blur, uv, angle, PATTERN, slack)
    flips = (gb != wb).numpy()
    assert not (flips & ~live).any(), np.argwhere(flips & ~live)[:5]
    return int(tied.sum())


def test_describe_with_injected_angles():
    """Steered BRIEF at angles 0, +-pi/2, +-pi, random ones, and keypoints
    on and near the border, the same angle tensor fed to both sides."""
    f = _frames(1)[0]
    blur = np.asarray(jfeat.gaussian_blur(jnp.asarray(f), FE.blur_sigma))
    rng = np.random.RandomState(5)
    n = 240
    uv = rng.uniform(0, [W, H], (n, 2)).astype(np.float32)
    uv[:6] = [[0, 0], [W - 1, H - 1], [2.5, 100.0], [W - 3, 7.5],
              [128.0, 0.5], [17.25, H - 1.5]]
    angle = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    angle[:30] = np.tile(np.float32([0.0, np.pi / 2, -np.pi / 2, np.pi,
                                     -np.pi]), 6)
    want = np.asarray(jdesc.describe(jnp.asarray(blur), jnp.asarray(uv),
                                     jnp.asarray(angle), FE))
    got = descriptors.describe(torch.from_numpy(blur), torch.from_numpy(uv),
                               torch.from_numpy(angle), FE).numpy()
    tied = _assert_bits_equal_but_ties(got, want, blur, uv, angle)
    assert tied < 0.001 * n * FE.descriptor_bits, tied
    want_img = jdesc.describe_from_image(jnp.asarray(f), jnp.asarray(uv),
                                         FE)
    got_img = descriptors.describe_from_image(torch.from_numpy(f),
                                              torch.from_numpy(uv), FE)
    ok = _oracle_magnitude(blur, uv) > 0.1
    assert _angle_diff(got_img[1].numpy(), np.asarray(want_img[1]))[ok] \
        .max() <= 1e-3


@pytest.mark.parametrize("variant", ["oriented", "carry", "oriented+carry"])
def test_extract_features_variants_match_reference(variant):
    fe = dataclasses.replace(FE, oriented=variant != "carry")
    f = _frames(2, seed=3)
    kw, jkw = {}, {}
    if "carry" in variant:
        uv0, _, ok0 = (np.asarray(a) for a in
                       jfeat.detect(jnp.asarray(f[0]), fe, H, W))
        carry = uv0 + np.float32([1.0, 0.5])
        kw = dict(carry_uv=torch.from_numpy(carry),
                  carry_mask=torch.from_numpy(ok0))
        jkw = dict(carry_uv=jnp.asarray(carry), carry_mask=jnp.asarray(ok0))
    want = jextract(jnp.asarray(f[1]), fe, H, W, **jkw)
    got = extract_features(torch.from_numpy(f[1]), fe, H, W, **kw)
    mask = np.asarray(want.mask)
    np.testing.assert_array_equal(got.mask.numpy(), mask)
    w_uv = np.asarray(want.uv)
    assert _ulps2(got.uv.numpy()[mask], w_uv[mask])
    blur = np.asarray(jfeat.gaussian_blur(jnp.asarray(f[1]), fe.blur_sigma))
    if fe.oriented:
        strong = _moment_magnitude(blur)[
            np.clip(np.round(w_uv[:, 1]).astype(int), 0, H - 1),
            np.clip(np.round(w_uv[:, 0]).astype(int), 0, W - 1)] > FLOOR
        assert _angle_diff(got.angle.numpy(), np.asarray(want.angle))[
            mask & strong].max() <= 1e-4
        w_angle = np.asarray(want.angle)[mask]
        _assert_bits_equal_but_ties(
            got.desc.numpy()[mask], np.asarray(want.desc)[mask], blur,
            w_uv[mask], w_angle, _slack(got.angle.numpy()[mask], w_angle,
                                        got.uv.numpy()[mask], w_uv[mask]))
    else:
        np.testing.assert_array_equal(got.desc.numpy().view(np.uint32),
                                      np.asarray(want.desc))
        assert not got.angle.any()
    assert (got.desc.numpy()[~mask] == 0).all()
    assert mask.sum() > 100                                     # premise


# a scene (seed) on which steered BRIEF meets no live rounding tie in any
# of the 7 frames, so the two trackers see the same descriptors
TRACK_SEED, TRACK_FRAMES = 10, 7


def test_track_step_both_flags_matches_reference():
    """track_step with oriented and track_carry on, the reference's RANSAC
    samples injected, frame by frame: success and keypoint masks equal,
    descriptors bit-equal (the premise asserts the scene has no live
    rounding tie), inlier counts and map sizes exact, the pose to 1e-3
    (f32 rounding along the pose chain, as tests/test_torch_tracker.py)."""
    scene = synthetic.make_scene(num_points=600, seed=TRACK_SEED,
                                 extent=(14, 6, 40), z_min=6.0)
    poses = synthetic.make_trajectory(TRACK_FRAMES, step=0.6,
                                      seed=TRACK_SEED)
    frames = synthetic.render_sequence(CFG.camera.K(), poses, scene, W, H)
    sj = jtracker.bootstrap(jnp.asarray(frames[0]), BOTH)
    st = tracker.bootstrap(frames[0], BOTH, "cpu")
    ops = tracker.default_map_ops(BOTH, W, H)
    for i in range(1, TRACK_FRAMES):
        fi = int(sj.frame_idx)
        sj, oj = jtracker.track_step(sj, jnp.asarray(frames[i]), BOTH)
        st, ot = tracker._step_impl(st, frames[i], BOTH, ops,
                                    pose_fn=_reference_samples(fi))
        m = np.asarray(sj.prev.mask)
        blur = np.asarray(jfeat.gaussian_blur(jnp.asarray(frames[i]),
                                              FE.blur_sigma))
        np.testing.assert_array_equal(ot.kp_mask.numpy(), m)
        angle, uv = np.asarray(sj.prev.angle)[m], np.asarray(sj.prev.uv)[m]
        _, live = scenes.describe_ties(
            blur, uv, angle, PATTERN, _slack(st.prev.angle.numpy()[m], angle,
                                             st.prev.uv.numpy()[m], uv))
        assert not live.any(), f"premise: a live tie in frame {i}"
        assert bool(ot.success) == bool(oj.success) is True
        np.testing.assert_array_equal(st.prev.desc.numpy().view(np.uint32),
                                      np.asarray(sj.prev.desc))
        assert int(ot.num_inliers) == int(oj.num_inliers), i
        assert int(ot.map_size) == int(oj.map_size), i
        np.testing.assert_allclose(ot.pose.numpy(), np.asarray(oj.pose),
                                   atol=1e-3, err_msg=f"frame {i}")
    assert int(oj.map_size) > 100


def test_process_chunk_equals_process_both_flags():
    """On the CPU the chunk loops over the frame body that process runs:
    with both flags on, flags, counters and poses equal (1e-6)."""
    frames = np.stack(_frames(9, seed=2))
    runs = []
    for chunked in (False, True):
        s = slam.SLAMSystem(BOTH, "cpu", enable_ba=False)
        if chunked:
            s.process(frames[0])
            s.process_chunk(frames[1:5])
            s.process_chunk(frames[5:])
        else:
            for fr in frames:
                s.process(fr)
        rows = [r for r in s.metrics.records
                if r.get("kind") == "frame" and "success" in r]
        runs.append((rows, s.poses()))
    (a, pa), (b, pb) = runs
    assert len(a) == len(b) == len(frames) - 1
    for x, y in zip(a, b):
        for k in ("success", "num_inliers", "num_matches", "map_size",
                  "num_associated", "num_new_points"):
            assert x[k] == y[k], (x["frame"], k)
        assert (x["keyframe"] and x["success"]) == y["keyframe"]
    np.testing.assert_allclose(pb, pa, atol=1e-6)
    assert sum(r["success"] for r in a) == len(a)
