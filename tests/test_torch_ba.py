"""The port's bundle adjustment (vslam_tpu_torch.optimizer.ba) against the
reference on tests/test_ba.py's synthetic problems.

Parity, per problem and Schur assembly: the per-iteration LM accept flags
are equal, costs agree to 1e-5 relative, T_cw to 1e-5 and the points still
in the problem to 1e-3 absolute (f32 sums taken in another order; landmark
depth along a forward ray is the weakest direction, hence the looser point
bound). The rejection rounds of ``solve_robust`` keep and drop the same
observations and points.
Then test_ba.py's five bounds hold on the port alone.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_ba import K, _make_problem
from vslam_tpu.config import BAConfig as JBAConfig
from vslam_tpu.optimizer import ba as jba
from vslam_tpu_torch import interop
from vslam_tpu_torch.config import BAConfig
from vslam_tpu_torch.optimizer import ba

torch.set_num_threads(2)

KT = torch.from_numpy(K)
ASSEMBLIES = ["onehot", "scatter"]


def _port(problem):
    return interop.from_jax(jax.tree_util.tree_map(np.asarray, problem),
                            ba.BAProblem)


def _corrupted(seed=3):
    """test_ba.py's outlier case: 5% of observations moved 30-80 px."""
    problem, T_true, _, _ = _make_problem(seed=seed)
    rng = np.random.RandomState(9)
    uv = np.asarray(problem.obs_uv).copy()
    m = np.asarray(problem.obs_mask)
    corrupt = (rng.rand(*m.shape) < 0.05) & m
    uv[corrupt] += rng.uniform(30, 80, (corrupt.sum(), 2))
    return problem.replace(obs_uv=jnp.asarray(uv)), T_true


def _assert_solves_agree(got, want, rtol=1e-5, t_atol=1e-5):
    """Flags equal; costs, poses and the points still in the problem
    (``point_mask``: a point dropped by a rejection round is no part of
    the solution) within the given tolerances."""
    (ps, st), (pj, sj) = got, want
    np.testing.assert_array_equal(st.accepted.numpy(),
                                  np.asarray(sj.accepted))
    np.testing.assert_allclose(float(st.initial_cost),
                               float(sj.initial_cost), rtol=1e-5)
    np.testing.assert_allclose(st.costs.numpy(), np.asarray(sj.costs),
                               rtol=rtol)
    np.testing.assert_allclose(float(st.final_cost), float(sj.final_cost),
                               rtol=rtol)
    np.testing.assert_allclose(ps.T_cw.numpy(), np.asarray(pj.T_cw),
                               atol=t_atol)
    live = np.asarray(pj.point_mask)
    np.testing.assert_array_equal(ps.point_mask.numpy(), live)
    np.testing.assert_allclose(ps.points.numpy()[live],
                               np.asarray(pj.points)[live], atol=1e-3)


@pytest.mark.parametrize("assembly", ASSEMBLIES)
def test_solve_matches_reference(assembly):
    problem, _, _, _ = _make_problem()
    kw = dict(iterations=12, schur_assembly=assembly)
    want = jba.solve(problem, jnp.asarray(K), JBAConfig(**kw))
    got = ba.solve(_port(problem), KT, BAConfig(**kw))
    _assert_solves_agree(got, want)
    assert got[1].accepted.dtype == torch.bool
    assert got[1].accepted.shape == (12,)


@pytest.mark.parametrize("assembly", ASSEMBLIES)
def test_solve_robust_matches_reference(assembly):
    problem, _ = _corrupted()
    kw = dict(iterations=8, schur_assembly=assembly)
    want = jba.solve_robust(problem, jnp.asarray(K), JBAConfig(**kw),
                            reject_px=5.0, rounds=2)
    got = ba.solve_robust(_port(problem), KT, BAConfig(**kw), reject_px=5.0,
                          rounds=2)
    _assert_solves_agree(got, want)
    np.testing.assert_array_equal(got[0].obs_mask.numpy(),
                                  np.asarray(want[0].obs_mask))
    np.testing.assert_array_equal(got[0].point_mask.numpy(),
                                  np.asarray(want[0].point_mask))
    # the premise: rejection removed observations
    assert int(got[0].obs_mask.sum()) < int(np.asarray(problem.obs_mask)
                                            .sum())


def test_onehot_matches_scatter_on_the_port():
    """The two assemblies build the same reduced system (summed in another
    order): per-iteration flags equal, costs and poses within f32 noise;
    "auto" picks one-hot at this camera count."""
    problem = _port(_make_problem(seed=1)[0])
    runs = {a: ba.solve(problem, KT, BAConfig(iterations=10,
                                              schur_assembly=a))
            for a in ("onehot", "scatter", "auto")}
    (p1, s1), (p2, s2) = runs["onehot"], runs["scatter"]
    assert torch.equal(s1.accepted, s2.accepted)
    np.testing.assert_allclose(s1.costs.numpy(), s2.costs.numpy(), rtol=1e-5)
    np.testing.assert_allclose(p1.T_cw.numpy(), p2.T_cw.numpy(), atol=1e-5)
    np.testing.assert_allclose(p1.points.numpy(), p2.points.numpy(),
                               atol=1e-3)
    assert torch.equal(runs["auto"][0].T_cw, p1.T_cw)


def test_schur_systems_agree_with_reference():
    """One reduced system, built directly: S and b from both assemblies
    against the reference's, to f32 tolerance relative to S's scale."""
    problem, _, _, _ = _make_problem(seed=2)
    pt = _port(problem)
    lam = 1e-3
    r, w, J_c, J_p, _ = jba._gn_quantities(problem.T_cw, problem.points,
                                           problem, jnp.asarray(K), 2.0)
    rt, wt, Jct, Jpt, _ = ba._gn_quantities(pt.T_cw, pt.points, pt, KT, 2.0)
    for assembly in ASSEMBLIES:
        Sj, bj = jba._schur_reduce(r, w, J_c, J_p, problem,
                                   jnp.float32(lam), assembly=assembly)[:2]
        St, bt = ba._schur_reduce(rt, wt, Jct, Jpt, pt,
                                  torch.tensor(lam, dtype=torch.float32),
                                  assembly=assembly)[:2]
        Sj, bj = np.asarray(Sj), np.asarray(bj)
        scale = np.abs(Sj).max()
        np.testing.assert_allclose(St.numpy(), Sj, atol=1e-5 * scale)
        np.testing.assert_allclose(bt.numpy(), bj,
                                   atol=1e-5 * np.abs(bj).max())


def test_indefinite_system_gives_a_zero_step():
    """cholesky_ex leaves a partial factor on an indefinite matrix, and
    solving with it gives finite garbage: the solver must return zero."""
    rng = np.random.RandomState(0)
    A = rng.randn(12, 12).astype(np.float32)
    S = torch.from_numpy(A @ A.T)
    S[5, 5] = -50.0
    b = torch.from_numpy(rng.randn(12).astype(np.float32))
    assert int(torch.linalg.cholesky_ex(S)[1]) != 0
    assert torch.equal(ba._solve_dense(S, b), torch.zeros(12))
    spd = S.clone()
    spd[5, 5] = 50.0 + float(torch.linalg.eigvalsh(S).abs().max())
    x = ba._solve_dense(spd, b)
    np.testing.assert_allclose((spd @ x).numpy(), b.numpy(), atol=1e-3)


@pytest.mark.parametrize("assembly", ASSEMBLIES)
def test_non_positive_definite_step_is_rejected_as_reference(assembly):
    """A negative initial damping makes the first reduced system
    indefinite (its damped diagonal blocks go negative). The reference's
    Cholesky returns NaN there and its guard zeroes the step; the port
    must reject the same iteration, keep every output finite, and recover
    once the clipped damping turns positive."""
    problem, _, _, _ = _make_problem()
    kw = dict(iterations=4, init_damping=-10.0, schur_assembly=assembly)
    want = jba.solve(problem, jnp.asarray(K), JBAConfig(**kw))
    got = ba.solve(_port(problem), KT, BAConfig(**kw))
    assert not bool(got[1].accepted[0])
    assert bool(got[1].accepted[1:].all())
    np.testing.assert_array_equal(got[1].accepted.numpy(),
                                  np.asarray(want[1].accepted))
    assert float(got[1].costs[0]) == float(got[1].initial_cost)
    assert bool(torch.isfinite(got[0].T_cw).all())
    assert bool(torch.isfinite(got[0].points).all())
    # the recovery steps run at the clipped damping 1e-9, an almost
    # undamped and ill-conditioned f32 system: 1e-3 relative on costs
    _assert_solves_agree(got, want, rtol=1e-3, t_atol=1e-4)


# ---- tests/test_ba.py's bounds, on the port alone --------------------------

def _terr(T, T_true):
    return np.linalg.norm(np.asarray(T)[:, :3, 3] - T_true[:, :3, 3], axis=1)


def test_converges_to_ground_truth():
    problem, T_true, _, _ = _make_problem()
    solved, stats = ba.solve(_port(problem), KT, BAConfig(iterations=12))
    assert float(stats.final_cost) < float(stats.initial_cost) * 0.05
    init_err = _terr(problem.T_cw, T_true)[2:].mean()
    assert _terr(solved.T_cw, T_true)[2:].mean() < init_err * 0.3


def test_exact_recovery_zero_noise():
    problem, T_true, xyz_true, seen = _make_problem(noise_px=0.0)
    solved, stats = ba.solve(_port(problem), KT, BAConfig(iterations=15))
    assert float(stats.final_cost) < 1e-2
    perr = np.linalg.norm(solved.points.numpy() - xyz_true, axis=1)[seen]
    assert np.median(perr) < 1e-3, np.median(perr)
    assert _terr(solved.T_cw, T_true).max() < 1e-3


def test_gauge_cams_untouched():
    problem = _port(_make_problem()[0])
    solved, _ = ba.solve(problem, KT, BAConfig(iterations=5))
    assert torch.equal(solved.T_cw[:2], problem.T_cw[:2])


def test_perfect_init_stays():
    problem = _port(_make_problem(noise_px=0.0, pose_noise=0.0,
                                  point_noise=0.0)[0])
    solved, stats = ba.solve(problem, KT, BAConfig(iterations=4))
    assert float(stats.final_cost) <= float(stats.initial_cost) + 1e-3
    np.testing.assert_allclose(solved.T_cw.numpy(), problem.T_cw.numpy(),
                               atol=1e-3)


def test_robust_to_outlier_observations():
    problem, T_true = _corrupted()
    solved, _ = ba.solve_robust(_port(problem), KT, BAConfig(iterations=8),
                                reject_px=5.0, rounds=2)
    assert _terr(solved.T_cw, T_true)[2:].mean() \
        < _terr(problem.T_cw, T_true)[2:].mean() * 0.5

