"""The port's generic tools against the reference: the Hamming formulations
and ``match_pairs``, the SVD 8-point fit, ``essential_from_fundamental``
and ``recover_pose``, the generic ``ransac`` and ``ransac_fundamental``;
then ``utils.profiling`` and the agreement checks of ``ops.bench_kernels``
and ``ops.bench_stages`` on the CPU.

Integers (distances, inlier sets and counts, cheirality votes) are exact.
Geometry is held to f32 tolerances: both sides run the same algorithms on
the same samples (the reference's (H, S) sets injected), but sums run in
another order in the two frameworks. The order of recover_pose's four
candidates follows the SVD's signs, so votes are compared sorted.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_geometry import _true_fundamental, _two_view_setup
from vslam_tpu.geometry import epipolar as jepi
from vslam_tpu.geometry import ransac as jransac
from vslam_tpu.matching import hamming as jham
from vslam_tpu.matching import matcher as jmatcher
from vslam_tpu_torch.config import MatchingConfig, small_config
from vslam_tpu_torch.geometry import epipolar, ransac
from vslam_tpu_torch.matching import hamming, matcher
from vslam_tpu_torch.ops import bench_kernels, bench_stages
from vslam_tpu_torch.ops import hamming as k1
from vslam_tpu_torch.utils import profiling

torch.set_num_threads(2)


def _t(a):
    return torch.tensor(np.asarray(a))


def _up_to_sign(a, b):
    return min(np.abs(a - b).max(), np.abs(a + b).max())


def _descriptors(seed, n1, n2):
    """Random uint32 descriptors with all-zero and all-one rows mixed in."""
    rng = np.random.RandomState(seed)
    d1 = rng.randint(0, 2 ** 32, (n1, 8), dtype=np.uint64).astype(np.uint32)
    d2 = rng.randint(0, 2 ** 32, (n2, 8), dtype=np.uint64).astype(np.uint32)
    d1[0], d2[0] = 0, 0
    d1[1:2], d2[-1] = 0xFFFFFFFF, 0xFFFFFFFF
    return d1, d2


@pytest.mark.parametrize("n1,n2", [(64, 48), (1, 9), (130, 257)])
def test_hamming_formulations_match_reference(n1, n2):
    """hamming_matmul (K1's plain version, which K1's wrapper runs on a
    CPU tensor) == hamming_popcount == the reference's hamming_matmul,
    exactly (distances 0 and 256 included)."""
    d1, d2 = _descriptors(n1 + n2, n1, n2)
    want = np.asarray(jham.hamming_matmul(jnp.asarray(d1), jnp.asarray(d2)))
    t1, t2 = torch.from_numpy(d1.view(np.int32)), \
        torch.from_numpy(d2.view(np.int32))
    for fn in (hamming.hamming_matmul, hamming.hamming_popcount,
               k1.hamming_cuda):
        got = fn(t1, t2)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(fn))
    assert want.min() == 0 and want.max() == 256                # premise


def test_hamming_pairwise_and_match_pairs_match_reference():
    d1, d2 = _descriptors(5, 96, 96)
    want = np.asarray(jham.hamming_pairwise(jnp.asarray(d1),
                                            jnp.asarray(d2)))
    got = hamming.hamming_pairwise(torch.from_numpy(d1.view(np.int32)),
                                   torch.from_numpy(d2.view(np.int32)))
    np.testing.assert_array_equal(got.numpy(), want)

    rng = np.random.RandomState(6)
    near = d1.copy()
    near[:, 0] ^= rng.randint(0, 16, 96).astype(np.uint32)
    mask = rng.rand(96) < 0.9
    cfg = MatchingConfig(lowe_ratio=0.9)
    ref = jmatcher.match(jnp.asarray(d1), jnp.asarray(mask),
                         jnp.asarray(near), jnp.asarray(mask), cfg)
    res = matcher.match(torch.from_numpy(d1.view(np.int32)),
                        torch.from_numpy(mask),
                        torch.from_numpy(near.view(np.int32)),
                        torch.from_numpy(mask), cfg)
    pairs = matcher.match_pairs(res)
    assert pairs.dtype == torch.int32 and pairs.shape == (96, 2)
    np.testing.assert_array_equal(pairs.numpy(),
                                  np.asarray(jmatcher.match_pairs(ref)))
    assert np.asarray(ref.mask).sum() > 50                      # premise


def test_fundamental_svd_matches_reference():
    """method="svd": to 1e-4 of the reference's (up to F's sign, which
    follows each LAPACK's SVD; a minimal sample's null vector moves by the
    f32 rounding of A times its conditioning, measured 1.7e-5), and the
    reference's own 1e-4 bound on the true F; batched over a leading axis
    too."""
    K, T1, T2, uv1, uv2, vis, _, _ = _two_view_setup(noise=0.0)
    idx = np.where(vis)[0]
    sets = np.stack([idx[:8], idx[8:16], idx[16:24]])
    F_true = _true_fundamental(K, T1, T2)
    got = epipolar.fundamental_from_8pt(_t(uv1[sets]), _t(uv2[sets]),
                                        method="svd").numpy()
    for h, s in enumerate(sets):
        want = np.asarray(jepi.fundamental_from_8pt(
            jnp.asarray(uv1[s]), jnp.asarray(uv2[s]), method="svd"))
        assert _up_to_sign(got[h], want) < 1e-4
        assert _up_to_sign(got[h], F_true) < 1e-4
        assert np.abs(np.linalg.svd(got[h])[1][2]) < 1e-6      # rank 2
    with pytest.raises(ValueError):
        epipolar.fundamental_from_8pt(_t(uv1[idx[:8]]), _t(uv2[idx[:8]]),
                                      method="qr")


def test_essential_and_recover_pose_match_reference():
    """E to 1e-6 of its largest entry (f32 rounding of K^T F K and the
    3x3 Jacobi SVD); the four candidates' votes equal as sorted lists; the
    chosen (R, t) to 1e-5 of the reference's and to its own 5e-3 bound on
    the true motion."""
    K, T1, T2, uv1, uv2, vis, _, _ = _two_view_setup(noise=0.2)
    F = _true_fundamental(K, T1, T2).astype(np.float32)
    E_want = np.asarray(jepi.essential_from_fundamental(jnp.asarray(F),
                                                        jnp.asarray(K)))
    E = epipolar.essential_from_fundamental(_t(F), _t(K))
    np.testing.assert_allclose(E.numpy(), E_want,
                               atol=1e-6 * np.abs(E_want).max())
    R_w, t_w, v_w = jepi.recover_pose(jnp.asarray(E_want), jnp.asarray(K),
                                      jnp.asarray(uv1), jnp.asarray(uv2),
                                      jnp.asarray(vis))
    R, t, votes = epipolar.recover_pose(E, _t(K), _t(uv1), _t(uv2),
                                        _t(vis))
    assert votes.dtype == torch.int32
    assert sorted(votes.tolist()) == sorted(np.asarray(v_w).tolist())
    np.testing.assert_allclose(R.numpy(), np.asarray(R_w), atol=1e-5)
    np.testing.assert_allclose(t.numpy(), np.asarray(t_w), atol=1e-5)
    T_21 = np.linalg.inv(T2) @ T1
    t_true = T_21[:3, 3] / np.linalg.norm(T_21[:3, 3])
    np.testing.assert_allclose(R.numpy(), T_21[:3, :3], atol=5e-3)
    np.testing.assert_allclose(t.numpy(), t_true, atol=5e-3)


def _line_data(seed=3, n=200, outliers=0.3):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-5, 5, n)
    y = 0.7 * x - 1.2 + rng.randn(n) * 0.05
    bad = rng.rand(n) < outliers
    y = np.where(bad, rng.uniform(-8, 8, n), y)
    valid = rng.rand(n) < 0.95
    return np.stack([x, y], 1).astype(np.float32), valid


def test_generic_ransac_matches_reference_with_injected_samples():
    """A robust line fit (2-point samples, a tuple model) through both
    frameworks' generic ``ransac`` on the reference's (H, 2) samples:
    inliers and their count exact, the model and score to f32
    tolerance. The reference vmaps a per-sample fit; the port's takes the
    (H, S, 2) batch."""
    pts, valid = _line_data()
    key = jax.random.PRNGKey(4)
    H, thr = 64, 0.04

    def jfit(s):
        a = (s[1, 1] - s[0, 1]) / (s[1, 0] - s[0, 0])
        return a, s[0, 1] - a * s[0, 0]

    def jres(m, d):
        return (d[:, 1] - m[0] * d[:, 0] - m[1]) ** 2

    def fit(s):
        a = (s[:, 1, 1] - s[:, 0, 1]) / (s[:, 1, 0] - s[:, 0, 0])
        return a, s[:, 0, 1] - a * s[:, 0, 0]

    def res(m, d):
        return (d[None, :, 1] - m[0][:, None] * d[None, :, 0]
                - m[1][:, None]) ** 2

    want = jransac.ransac(key, jfit, jres, jnp.asarray(pts), jnp.asarray(pts),
                          jnp.asarray(valid), H, 2, thr, min_inliers=8)
    idx = jransac.sample_minimal_sets(key, jnp.asarray(valid, jnp.float32),
                                      H, 2)
    got = ransac.ransac_from_samples(_t(idx).long(), fit, res, _t(pts),
                                     _t(pts), _t(valid), thr, min_inliers=8)
    np.testing.assert_array_equal(got.inliers.numpy(),
                                  np.asarray(want.inliers))
    assert int(got.num_inliers) == int(want.num_inliers) > 100
    assert bool(got.success)
    for g, w in zip(got.model, want.model):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5)
    np.testing.assert_allclose(float(got.best_score),
                               float(want.best_score), rtol=1e-4)


@pytest.mark.parametrize("refine", [False, True])
def test_ransac_fundamental_matches_reference_with_injected_samples(refine):
    """The reference's (H, 8) samples (drawn from the key its
    ransac_fundamental draws from) through the port: inliers and count
    exact, F to 1e-3 up to sign (the winner is an 8-point Jacobi fit on
    noisy points, whose f32 rounding its conditioning amplifies: measured
    1.9e-4; the reference holds that path to 5e-3 of the true F)."""
    K, T1, T2, uv1, uv2, vis, _, _ = _two_view_setup(noise=0.3,
                                                      outlier_frac=0.4)
    key = jax.random.PRNGKey(0)
    H = 256
    want = jransac.ransac_fundamental(key, jnp.asarray(uv1),
                                      jnp.asarray(uv2), jnp.asarray(vis),
                                      num_hypotheses=H, refine=refine)
    idx = jransac.sample_minimal_sets(key, jnp.asarray(vis, jnp.float32),
                                      H, 8)
    got = ransac.ransac_fundamental_from_samples(
        _t(idx).long(), _t(uv1), _t(uv2), _t(vis), refine=refine)
    np.testing.assert_array_equal(got.inliers.numpy(),
                                  np.asarray(want.inliers))
    assert int(got.num_inliers) == int(want.num_inliers)
    assert bool(got.success) == bool(want.success) is True
    assert _up_to_sign(got.model.numpy(), np.asarray(want.model)) < 1e-3


def test_ransac_fundamental_on_the_ports_generator():
    """tests/test_geometry.py's bounds on the port's own random stream:
    40% outliers, 512 hypotheses, precision > 0.9 and recall > 0.7."""
    K, T1, T2, uv1, uv2, vis, _, is_out = _two_view_setup(noise=0.3,
                                                          outlier_frac=0.4)
    res = ransac.ransac_fundamental(torch.Generator().manual_seed(0),
                                    _t(uv1), _t(uv2), _t(vis),
                                    num_hypotheses=512, inlier_threshold=2.0)
    assert bool(res.success)
    inl = res.inliers.numpy()
    true_inl = vis & ~is_out
    precision = (inl & true_inl).sum() / max(inl.sum(), 1)
    recall = (inl & true_inl).sum() / max(true_inl.sum(), 1)
    assert precision > 0.9, precision
    assert recall > 0.7, recall


def test_summarize_trace_reads_device_trace(tmp_path):
    """A CPU trace written by device_trace is found and totalled by name;
    StageTimer records one time per stage."""
    a = torch.randn(128, 128)
    with profiling.device_trace(str(tmp_path)):
        for _ in range(3):
            b = a @ a
    assert list(tmp_path.glob("*" + profiling.TRACE_SUFFIX))
    rows = profiling.summarize_trace(str(tmp_path))
    names = {name: (ms, n) for name, ms, n in rows}
    assert names["aten::mm"][1] == 3 and names["aten::mm"][0] > 0
    assert [r[1] for r in rows] == sorted((r[1] for r in rows),
                                          reverse=True)
    timer = profiling.StageTimer()
    for _ in range(2):
        with timer.stage("mm", result=b):
            b = a @ a
    assert set(timer.summary()) == {"mm"} and len(timer.times["mm"]) == 2


def test_bench_tools_agree_on_the_cpu():
    """The races' agreement checks at small sizes (K1 and K2 take their
    plain versions on the CPU), every stage of bench_stages once on the
    small config, and both tools' refusal without a CUDA device."""
    rng = np.random.RandomState(2)
    d1, d2 = (bench_kernels.random_descriptors(rng, n, "cpu")
              for n in (40, 70))
    assert all(bench_kernels.hamming_agreement(d1, d2).values())
    cfg = small_config()
    args = bench_kernels.associate_inputs(cfg, 1500, 256, "cpu")
    agree = bench_kernels.associate_agreement(args, cfg)
    assert agree["equal"] and agree["hits_strict"] > 0 \
        and agree["hits_reacq"] > 0, agree
    names = []
    for name, fn, _ in bench_stages.stages("cpu", 1500, cfg):
        fn()
        names.append(name)
    assert names[-2:] == ["track_step default", "track_step oriented+carry"]
    assert bench_kernels.main(["--device", "cpu"]) == 2
    assert bench_stages.main(["--device", "cpu"]) == 2
