"""The port's geometry (Jacobi, RANSAC pose, triangulation, PnP) against the
reference on the same numpy-seeded inputs.

Tolerances are f32 ones: both sides run the same algorithms (the same
fixed-sweep Jacobi, the same RANSAC samples injected on both sides), but
reductions and matrix products sum in another order in the two frameworks,
so results agree to rounding (~1e-7 relative per operation), amplified by
the conditioning of each solve. Counts over a threshold (inliers, votes)
may differ by the few samples that sit on the threshold.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vslam_tpu.core import lie as jlie
from vslam_tpu.datasets import synthetic
from vslam_tpu.geometry import pnp as jpnp
from vslam_tpu.geometry import ransac as jransac
from vslam_tpu.geometry import triangulation as jtri
from vslam_tpu.ops import jacobi as jjacobi
from vslam_tpu_torch.core import lie
from vslam_tpu_torch.geometry import pnp, ransac, triangulation
from vslam_tpu_torch.ops import bench_kernels, jacobi

torch.set_num_threads(2)

K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize("n,sweeps", [(9, 8), (9, 4), (4, 7), (3, 10)])
def test_jacobi_eigh_matches_reference(n, sweeps):
    """Same sweeps, same rotations: eigenvalues to 1e-5 relative of the
    spectrum's scale, eigenvectors (same sign convention) to 1e-4."""
    rng = np.random.RandomState(n * sweeps)
    X = rng.randn(64, n + 3, n).astype(np.float32)
    A = np.einsum("bji,bjk->bik", X, X)
    w_j, V_j = jjacobi.jacobi_eigh(jnp.asarray(A), sweeps=sweeps)
    w_t, V_t = jacobi.jacobi_eigh(_t(A), sweeps=sweeps)
    scale = np.abs(np.asarray(w_j)).max(axis=-1, keepdims=True)
    np.testing.assert_allclose(w_t.numpy() / scale, np.asarray(w_j) / scale,
                               atol=1e-5)
    np.testing.assert_allclose(V_t.numpy(), np.asarray(V_j), atol=1e-4)


@pytest.mark.parametrize("n", range(2, jacobi.MAX_N + 1))
def test_jacobi_partner_table_is_the_schedule(n):
    """The table csrc/jacobi.cu reads: round for round the pairs of
    ``_round_robin_schedule``, every other index its own partner."""
    table = jacobi._partner_table(n)
    sched = jacobi._round_robin_schedule(n)
    assert len(table) == len(sched)
    for row, pairs in zip(table, sched):
        assert len(row) == n
        assert all(row[row[i]] == i for i in range(n))
        assert sorted((i, p) for i, p in enumerate(row) if i < p) \
            == sorted(pairs)
    t = jacobi._table(n, torch.device("cpu"))
    assert t.dtype == torch.int8 and t.tolist() == [list(r) for r in table]


@pytest.mark.parametrize("shape,sweeps", [((9, 9), 6), ((5, 3, 3), 10),
                                          ((2, 3, 4, 4), 7)])
def test_jacobi_eigh_on_cpu_is_the_loop(shape, sweeps):
    """On a CPU tensor ``jacobi_eigh`` is ``jacobi_eigh_plain``, bit for
    bit, and launches nothing."""
    g = torch.Generator().manual_seed(sweeps)
    X = torch.randn(shape[:-2] + (shape[-1] + 2, shape[-1]), generator=g)
    A = X.mT @ X
    before = jacobi.launches
    w, V = jacobi.jacobi_eigh(A, sweeps)
    w_p, V_p = jacobi.jacobi_eigh_plain(A, sweeps)
    assert jacobi.launches == before
    assert torch.equal(w, w_p) and torch.equal(V, V_p)


@pytest.mark.parametrize("bad", ["f64", "n10", "n1", "not_square",
                                 "vector", "cpu"])
def test_jacobi_kernel_wrapper_refuses_out_of_scope(bad):
    """``jacobi_eigh_cuda`` raises, before any launch, on what the kernel
    does not take (the device is checked last, so this runs on the CPU)."""
    A = {"f64": torch.eye(3, dtype=torch.float64), "n10": torch.eye(10),
         "n1": torch.eye(1), "not_square": torch.ones((2, 3, 4)),
         "vector": torch.ones(3), "cpu": torch.eye(3)}[bad]
    with pytest.raises(ValueError):
        jacobi.jacobi_eigh_cuda(A)


def test_step_eigh_inputs_are_the_step_calls():
    """``jacobi.STEP_CALLS``, the table the card's parity checks and the
    kernel races read, is the (shape, sweeps) of every ``jacobi_eigh`` call
    a default-config step's RANSAC and triangulations make, in order."""
    calls = bench_kernels.step_eigh_inputs("cpu")
    assert [(tuple(A.shape), s) for A, s in calls] \
        == list(jacobi.STEP_CALLS)
    assert all(A.dtype == torch.float32 and torch.isfinite(A).all()
               for A, _ in calls)


@pytest.mark.parametrize("shape,sweeps,want", [
    ((2, 3, 3), 1, (4 * 2 * (18 + 3), 2 * 1 * 3 * (13 + 54))),
    ((9, 9), 4, (4 * (162 + 9), 4 * 36 * (13 + 162))),
    ((5, 4, 4), 7, (4 * 5 * (32 + 4), 5 * 7 * 6 * (13 + 72)))])
def test_eigh_work_counts_the_loops_arithmetic(shape, sweeps, want):
    """Bytes: A read, eigenpairs written; operations: per pair of a round
    13 for (c, s) and 18 n for the row pass, column pass and V."""
    assert bench_kernels.eigh_work(shape, sweeps) == want


def _two_view(seed=7, outliers=0.15, noise=0.4):
    scene = synthetic.make_scene(num_points=800, seed=seed)
    poses = synthetic.make_trajectory(2, step=0.8, seed=seed)
    uv1, uv2, vis, xyz = synthetic.correspondences(
        K, poses[0], poses[1], scene.xyz, 640, 480, noise_px=noise)
    rng = np.random.RandomState(seed)
    bad = rng.rand(len(uv2)) < outliers
    uv2 = np.where(bad[:, None], rng.uniform(0, 480, uv2.shape), uv2)
    return (uv1.astype(np.float32), uv2.astype(np.float32), vis, xyz,
            poses)


@pytest.mark.parametrize("seed", [7, 11])
def test_ransac_pose_with_injected_samples(seed):
    """ransac_pose on the reference's own (H, 8) samples: same winner
    inlier set (to 2 matches at the 2 px Sampson boundary), R and t to
    1e-3 (the LM polish amplifies rounding by its conditioning)."""
    uv1, uv2, vis, _, _ = _two_view(seed)
    H = 256
    key = jax.random.PRNGKey(seed)
    idx = jransac.sample_minimal_sets(key, jnp.asarray(vis, jnp.float32),
                                      H, 8)
    want = jax.jit(jransac.ransac_pose, static_argnames="num_hypotheses")(
        key, jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(vis),
        jnp.asarray(K), num_hypotheses=H)
    got = ransac.ransac_pose_from_samples(
        _t(idx).long(), _t(uv1), _t(uv2), _t(vis), _t(K))
    assert bool(got.success) == bool(want.success) is True
    assert abs(int(got.num_inliers) - int(want.num_inliers)) <= 2
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), atol=1e-3)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), atol=1e-3)
    # cheirality votes of the stage-2 winner: counts over a threshold, so a
    # match at the boundary may flip with the last bit of F; and the order
    # of the 4 (R, t) candidates follows the SVD's sign choice, which can
    # differ between two near-identical leaders — compare them sorted
    np.testing.assert_allclose(np.sort(got.votes.numpy()),
                               np.sort(np.asarray(want.votes)), atol=3)


def test_sample_minimal_sets_draws_only_valid():
    g = torch.Generator().manual_seed(0)
    w = torch.zeros(100)
    w[[3, 17, 42, 99]] = 1.0
    idx = ransac.sample_minimal_sets(g, w, 512, 8)
    assert idx.shape == (512, 8)
    assert set(idx.unique().tolist()) == {3, 17, 42, 99}


def test_triangulate_dlt_matches_reference():
    """Shared and per-point projection matrices: points to 1e-4 relative
    (7-sweep 4x4 Jacobi on row-normalized systems), gates exactly."""
    uv1, uv2, vis, xyz, poses = _two_view(3, outliers=0.0)
    P1 = K @ np.linalg.inv(poses[0])[:3]
    P2 = K @ np.linalg.inv(poses[1])[:3]
    X_j, w_j = jtri.triangulate_dlt(jnp.asarray(P1), jnp.asarray(P2),
                                    jnp.asarray(uv1), jnp.asarray(uv2))
    Pn = np.broadcast_to(P1, (len(uv1), 3, 4)).astype(np.float32)
    X_t, w_t = triangulation.triangulate_dlt(_t(Pn), _t(P2.astype(np.float32)),
                                             _t(uv1), _t(uv2))
    Xj = np.asarray(X_j)[vis]
    np.testing.assert_allclose(X_t.numpy()[vis], Xj,
                               rtol=1e-4, atol=1e-4 * np.abs(Xj).max())
    C1 = poses[0][:3, 3].astype(np.float32)
    C2 = poses[1][:3, 3].astype(np.float32)
    g_j = jtri.triangulation_gate(jnp.asarray(P1), jnp.asarray(P2),
                                  jnp.asarray(C1), jnp.asarray(C2), X_j,
                                  jnp.asarray(uv1), jnp.asarray(uv2), w_j)
    g_t = triangulation.triangulation_gate(
        _t(P1.astype(np.float32)), _t(P2.astype(np.float32)), _t(C1),
        _t(C2), _t(X_j), _t(uv1), _t(uv2), _t(w_j))
    np.testing.assert_array_equal(g_t.numpy(), np.asarray(g_j))
    assert np.asarray(g_j).sum() > 100


def test_refine_pose_matches_reference():
    """Weighted pose-only GN from a perturbed start: T_cw to 1e-4, inlier
    count exact, RMSE to 1e-3 px."""
    rng = np.random.RandomState(4)
    uv1, _, vis, xyz, poses = _two_view(5, outliers=0.0)
    T_cw = np.linalg.inv(poses[0]).astype(np.float32)
    uv = (uv1 + rng.randn(*uv1.shape) * 0.5).astype(np.float32)
    mask = vis & (rng.rand(len(vis)) < 0.8)
    w = rng.uniform(0.2, 1.0, len(vis)).astype(np.float32)
    xi = np.array([0.05, -0.03, 0.1, 0.01, -0.02, 0.015], np.float32)
    T0 = np.asarray(jlie.se3_exp(jnp.asarray(xi))) @ T_cw
    want = jpnp.refine_pose(jnp.asarray(T0), jnp.asarray(xyz),
                            jnp.asarray(uv), jnp.asarray(mask),
                            jnp.asarray(K), weights=jnp.asarray(w))
    got = pnp.refine_pose(_t(T0), _t(xyz), _t(uv), _t(mask), _t(K),
                          weights=_t(w))
    np.testing.assert_allclose(got.T_cw.numpy(), np.asarray(want.T_cw),
                               atol=1e-4)
    assert int(got.num_inliers) == int(want.num_inliers) > 100
    assert abs(float(got.rmse) - float(want.rmse)) < 1e-3


def test_lie_matches_reference():
    rng = np.random.RandomState(0)
    xi = (rng.randn(32, 6) * 0.5).astype(np.float32)
    T_j = np.asarray(jlie.se3_exp(jnp.asarray(xi)))
    T_t = lie.se3_exp(_t(xi)).numpy()
    np.testing.assert_allclose(T_t, T_j, atol=1e-5)
    np.testing.assert_allclose(lie.se3_log(_t(T_j)).numpy(),
                               np.asarray(jlie.se3_log(jnp.asarray(T_j))),
                               atol=1e-4)
    np.testing.assert_allclose(lie.inv_T(_t(T_j)).numpy(),
                               np.asarray(jlie.inv_T(jnp.asarray(T_j))),
                               atol=1e-5)
    np.testing.assert_allclose(
        lie.orthonormalize_T(_t(T_j * 1.01)).numpy(),
        np.asarray(jlie.orthonormalize_T(jnp.asarray(T_j * 1.01))),
        atol=1e-5)
