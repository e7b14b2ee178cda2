"""The port's keyframe store and window-problem construction against the
reference, on a store and map carried over from a reference SLAMSystem run
(tests/test_slam.py's scene, 14 frames: 6 keyframes in a 32-slot ring, so
26 empty slots tie at kf_order -1).

Integers (slots, ids, observation tables, masks, counters) must be exact;
floats must match to 1e-6: gathered and scattered values are copies, and
the rest is one rigid-transform inverse of the same f32 inputs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_slam import CFG as JCFG
from tests.test_slam import K, H, W
from vslam_tpu.datasets import synthetic
from vslam_tpu.optimizer import ba as jba
from vslam_tpu.pipeline import keyframes as jkf
from vslam_tpu.pipeline import slam as jslam
from vslam_tpu_torch import interop
from vslam_tpu_torch.config import small_config
from vslam_tpu_torch.core.types import PT_CONF, MapState
from vslam_tpu_torch.optimizer.ba import BAProblem
from vslam_tpu_torch.pipeline import keyframes

torch.set_num_threads(2)

CFG = small_config()
RING = max(CFG.pipeline.max_keyframes, 2 * CFG.ba.window)


def _np(x):
    return jax.tree_util.tree_map(np.asarray, x)


@pytest.fixture(scope="module")
def ref():
    scene = synthetic.make_scene(num_points=700, seed=2, extent=(14, 6, 45),
                                 z_min=6.0)
    poses = synthetic.make_trajectory(14, step=0.6, yaw_rate=0.01, seed=2)
    frames = synthetic.render_sequence(K, poses, scene, W, H)
    s = jslam.SLAMSystem(JCFG, enable_ba=True)
    for f in frames:
        s.process(f)
    assert int(s.kf_store.count) == 6 and s.kf_store.ring_size == RING
    return s


def _port_store(store):
    return interop.from_jax(_np(store), keyframes.KeyframeStore)


def _port_map(m):
    return interop.from_jax(_np(m), MapState)


def _port_wp(wp):
    w = _np(wp)
    t = lambda a: torch.from_numpy(np.array(a))
    return keyframes.WindowProblem(
        problem=interop.from_jax(w.problem, BAProblem),
        **{f: t(getattr(w, f)) for f in keyframes.WindowProblem._fields
           if f != "problem"})


def _assert_tree_equal(got: dict, want, what):
    for f, g in got.items():
        w = np.asarray(getattr(want, f))
        assert g.dtype == w.dtype and g.shape == w.shape, (what, f)
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g, w, atol=1e-6, rtol=0,
                                       err_msg=f"{what}.{f}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what}.{f}")


def test_empty_store_matches_reference():
    want = _np(jkf.empty_store(RING, CFG.frontend.max_keypoints))
    got = keyframes.empty_store(RING, CFG.frontend.max_keypoints, "cpu")
    _assert_tree_equal(interop.to_numpy(got), want, "store")


@pytest.mark.parametrize("count", [6, RING + 3])
def test_insert_keyframe_matches_reference(ref, count):
    """A new keyframe from the tracker's state, at count 6 (slot 6) and
    past a wrap of the ring (slot 3 overwritten)."""
    st = ref.state
    store = ref.kf_store.replace(count=jnp.int32(count))
    want = jkf.insert_keyframe(store, st.pose, jnp.int32(30), st.prev.uv,
                               st.prev_map_id, st.prev.mask)
    got = keyframes.insert_keyframe(
        _port_store(store), torch.from_numpy(np.asarray(st.pose)),
        torch.tensor(30, dtype=torch.int32),
        torch.from_numpy(np.asarray(st.prev.uv)),
        torch.from_numpy(np.asarray(st.prev_map_id)),
        torch.from_numpy(np.asarray(st.prev.mask)))
    _assert_tree_equal(interop.to_numpy(got), _np(want), "store")
    assert int(got.count) == count + 1


MODES = {
    "window-free3-prov99": dict(free_tail=3, prov_min_obs=99),
    "window-free3-prov3": dict(free_tail=3, prov_min_obs=3),
    "window-gauge2": dict(free_tail=None, prov_min_obs=3),
    "structure-free0-prov2": dict(free_tail=0, prov_min_obs=2),
    "global-ring": dict(window=RING, free_tail=None, prov_min_obs=3),
    "global-capped": dict(window=RING, max_points=96, prov_min_obs=2),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_build_window_problem_matches_reference(ref, mode):
    kw = MODES[mode]
    # two obs slots per point in the capped case, so obs are dropped too
    kslots = 2 if mode == "global-capped" else CFG.ba.max_obs_per_point
    jcfg = JCFG.replace(ba=dataclasses.replace(JCFG.ba,
                                               max_obs_per_point=kslots))
    tcfg = CFG.replace(ba=dataclasses.replace(CFG.ba,
                                              max_obs_per_point=kslots))
    want = _np(jkf.build_window_problem(ref.kf_store, ref.state.map, jcfg,
                                        **kw))
    got = keyframes.build_window_problem(
        _port_store(ref.kf_store), _port_map(ref.state.map), tcfg, **kw)
    _assert_tree_equal(interop.to_numpy(got.problem), want.problem,
                       f"{mode}.problem")
    for f in keyframes.WindowProblem._fields[1:]:
        g = getattr(got, f).numpy()
        w = np.asarray(getattr(want, f))
        assert g.dtype == w.dtype and g.shape == w.shape, (mode, f)
        np.testing.assert_array_equal(g, w, err_msg=f"{mode}.{f}")
    # premises: provisional landmarks are in play, and the capped global
    # problem really truncates
    assert want.sel_prov.any() and want.problem.point_mask.any()
    if mode == "global-capped":
        assert want.n_dropped_points > 0 and want.n_dropped_obs > 0


@pytest.fixture(scope="module")
def solved_window(ref):
    wp = jkf.build_window_problem(ref.kf_store, ref.state.map, JCFG,
                                  free_tail=JCFG.ba.free_cams,
                                  prov_min_obs=3)
    solved, _ = jba.solve_robust(wp.problem, jnp.asarray(K), JCFG.ba)
    return wp, solved


def test_apply_window_result_matches_reference(ref, solved_window):
    wp, solved = solved_window
    s_j, m_j, T_j = jkf.apply_window_result(ref.kf_store, ref.state.map, wp,
                                            solved)
    s_t, m_t, T_t = keyframes.apply_window_result(
        _port_store(ref.kf_store), _port_map(ref.state.map), _port_wp(wp),
        interop.from_jax(_np(solved), BAProblem))
    _assert_tree_equal(interop.to_numpy(s_t), _np(s_j), "store")
    _assert_tree_equal(interop.to_numpy(m_t), _np(m_j), "map")
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), atol=1e-6)
    # premise: the write-back moved poses and promoted landmarks
    assert not np.array_equal(np.asarray(s_j.poses),
                              np.asarray(ref.kf_store.poses))
    assert (np.asarray(ref.state.map.prov) & ~np.asarray(m_j.prov)).any()


@pytest.mark.parametrize("span_deg", [0.5, 2.0])
def test_apply_structure_result_matches_reference(ref, span_deg):
    wp = jkf.build_window_problem(ref.kf_store, ref.state.map, JCFG,
                                  free_tail=0, prov_min_obs=2)
    solved, _ = jba.solve_robust(wp.problem, jnp.asarray(K), JCFG.ba,
                                 reject_px=3.0, rounds=2)
    span = float(np.deg2rad(np.float32(span_deg)))
    m_j, n_j = jkf.apply_structure_result(ref.state.map, wp, solved,
                                          jnp.deg2rad(jnp.float32(span_deg)))
    m_t, n_t = keyframes.apply_structure_result(
        _port_map(ref.state.map), _port_wp(wp),
        interop.from_jax(_np(solved), BAProblem), span)
    got, want = interop.to_numpy(m_t), _np(m_j)
    # the confidence column is arccos of a max ray dot product near 1:
    # 2 ulps of the dot (sums in another order) move it by up to ~1e-5
    # rad at 1-degree spans, so it is held to 3e-5; every other column
    # is a copy and held to 1e-6
    np.testing.assert_allclose(got["pt"][:, PT_CONF],
                               np.asarray(want.pt)[:, PT_CONF], atol=3e-5,
                               rtol=0)
    got["pt"] = np.delete(got["pt"], PT_CONF, axis=1)
    want = want.replace(pt=np.delete(np.asarray(want.pt), PT_CONF, axis=1))
    _assert_tree_equal(got, want, "map")
    assert int(n_t) == int(n_j)
    if span_deg == 0.5:
        assert int(n_j) > 0                  # premise: promotions happen
