"""Checkpoints of the port (vslam_tpu_torch.utils.checkpoint) in the
reference's format: a resumed run equals an uninterrupted one
(tests/test_checkpoint.py's case), and each package loads the other's
checkpoints with every leaf equal and descriptors bit-identical.
"""
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vslam_tpu.config import small_config as jsmall
from vslam_tpu.pipeline import slam as jslam
from vslam_tpu.utils import checkpoint as jcheckpoint
from vslam_tpu_torch import interop
from vslam_tpu_torch.config import small_config
from vslam_tpu_torch.datasets import synthetic
from vslam_tpu_torch.pipeline import slam
from vslam_tpu_torch.utils import checkpoint

torch.set_num_threads(2)

CFG = small_config()
K = CFG.camera.K()
W, H = CFG.camera.width, CFG.camera.height


@pytest.fixture(scope="module")
def frames():
    scene = synthetic.make_scene(num_points=600, seed=4, extent=(14, 6, 40),
                                 z_min=6.0)
    poses = synthetic.make_trajectory(12, step=0.6, seed=4)
    return synthetic.render_sequence(K, poses, scene, W, H)


def _leaves(tree, prefix):
    """Nested dicts of numpy arrays -> {"prefix/a/b": array}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = v
    return out


def _assert_same(want: dict, got: dict):
    assert sorted(want) == sorted(got)
    for k in want:
        w, g = np.asarray(want[k]), np.asarray(got[k])
        assert w.dtype == g.dtype and w.shape == g.shape, (k, w.dtype, g.dtype)
        np.testing.assert_array_equal(g, w, err_msg=k)


def test_resume_matches_uninterrupted(frames, tmp_path):
    full = slam.SLAMSystem(CFG, "cpu", seed=7)
    for f in frames:
        full.process(f)
    want = (full.poses(), int(full.state.map.size), full._kf_count)
    # MKL's float32 results depend on buffer placement: release the first
    # system before the second runs (tests/test_torch_scan_driver.py)
    del full
    gc.collect()

    first = slam.SLAMSystem(CFG, "cpu", seed=7)
    for f in frames[:6]:
        first.process(f)
    ckpt = str(tmp_path / "state")
    checkpoint.save_state(ckpt, first)
    del first
    gc.collect()

    resumed = slam.SLAMSystem(CFG, "cpu", seed=7)
    checkpoint.load_state(ckpt, resumed)
    assert resumed.frame_idx == 6
    for f in frames[6:]:
        resumed.process(f)
    np.testing.assert_allclose(resumed.poses(), want[0], atol=1e-5)
    assert int(resumed.state.map.size) == want[1]
    assert resumed._kf_count == want[2]


def _port_arrays(s):
    out = _leaves(interop.to_numpy(s.state), "state")
    out.update(_leaves(interop.to_numpy(s.kf_store), "kf"))
    return out


def _ref_arrays(s):
    state, _ = jcheckpoint._flatten_with_paths(s.state)
    kf, _ = jcheckpoint._flatten_with_paths(s.kf_store)
    out = {f"state/{k}": v for k, v in state.items()}
    out.update({f"kf/{k}": v for k, v in kf.items()})
    return out


def test_reference_checkpoint_loads_into_the_port(frames, tmp_path):
    ref = jslam.SLAMSystem(jsmall(), seed=3)
    for f in frames[:5]:
        ref.process(jnp.asarray(f))
    ckpt = str(tmp_path / "ref")
    jcheckpoint.save_state(ckpt, ref)

    port = slam.SLAMSystem(CFG, "cpu")
    checkpoint.load_state(ckpt, port)
    want = _ref_arrays(ref)
    key = want.pop("state/key")
    _assert_same(want, _port_arrays(port))
    assert want["state/map/desc"].dtype == np.uint32            # premise
    assert int(ref.state.map.size) > 0 and int(ref.kf_store.count) >= 2
    np.testing.assert_array_equal(np.stack(port.trajectory),
                                  np.stack(ref.trajectory))
    assert (port.frame_idx, port._kf_count) == (ref.frame_idx, ref._kf_count)
    # the reference's key, PRNGKey(3), seeds the port's generator with 3
    assert np.asarray(key).tolist() == [0, 3]
    assert port.state.key.initial_seed() == 3
    # and the port tracks on from the reference's state
    info = port.process(frames[5])
    assert info["frame"] == 5 and info["success"]


def test_port_checkpoint_loads_into_the_reference(frames, tmp_path):
    port = slam.SLAMSystem(CFG, "cpu", seed=3)
    for f in frames[:5]:
        port.process(f)
    ckpt = str(tmp_path / "port")
    checkpoint.save_state(ckpt, port)

    ref = jslam.SLAMSystem(jsmall())
    jcheckpoint.load_state(ckpt, ref)
    got = _ref_arrays(ref)
    key = got.pop("state/key")
    _assert_same(_port_arrays(port), got)
    assert got["state/map/desc"].dtype == np.uint32
    assert int(port.state.map.size) > 0 and int(port.kf_store.count) >= 2
    np.testing.assert_array_equal(np.stack(ref.trajectory),
                                  np.stack(port.trajectory))
    assert (ref.frame_idx, ref._kf_count) == (port.frame_idx, port._kf_count)
    # the port's seed as the reference lays it out: PRNGKey(3)
    np.testing.assert_array_equal(key, jax.random.PRNGKey(3))
    assert isinstance(ref.state.key, jax.Array)
