"""The port's copies of the framework-free modules, its state interop with
the reference, and its independence from jax.

``vslam_tpu_torch`` keeps its own copies of ``config.py``,
``datasets/synthetic.py``, ``utils/evaluate.py`` and ``utils/metrics.py``
because importing ``vslam_tpu`` loads jax, which a GPU host running the
port need not have; these tests hold each copy equal to the original
(``utils/metrics.py``, which adds spans and host syncs, to what it logs).
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vslam_tpu import config as jconfig
from vslam_tpu.config import small_config as jsmall
from vslam_tpu.datasets import synthetic as jsyn
from vslam_tpu.pipeline import keyframes as jkf
from vslam_tpu.pipeline import tracker as jtracker
from vslam_tpu.utils import evaluate as jeval
from vslam_tpu_torch import config, interop
from vslam_tpu_torch.datasets import synthetic
from vslam_tpu_torch.optimizer.ba import BAProblem
from vslam_tpu_torch.pipeline.keyframes import KeyframeStore
from vslam_tpu_torch.pipeline.tracker import TrackerState
from vslam_tpu_torch.utils import evaluate

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("make", ["VSLAMConfig", "small_config"])
def test_config_copy_equals_reference(make):
    a = dataclasses.asdict(getattr(config, make)())
    b = dataclasses.asdict(getattr(jconfig, make)())
    assert a == b
    cfg = getattr(config, make)()
    assert config.VSLAMConfig.from_json(cfg.to_json()) == cfg
    np.testing.assert_array_equal(cfg.camera.K(),
                                  getattr(jconfig, make)().camera.K())


def test_synthetic_copy_equals_reference():
    K = jsmall().camera.K()
    for mod_a, mod_b in ((synthetic, jsyn),):
        sa = mod_a.make_scene(num_points=300, seed=4)
        sb = mod_b.make_scene(num_points=300, seed=4)
        for f in ("xyz", "patches", "color"):
            np.testing.assert_array_equal(getattr(sa, f), getattr(sb, f))
        pa = mod_a.make_trajectory(4, step=0.6, seed=4)
        np.testing.assert_array_equal(pa,
                                      mod_b.make_trajectory(4, step=0.6,
                                                            seed=4))
        np.testing.assert_array_equal(
            mod_a.render_sequence(K, pa, sa, 256, 192),
            mod_b.render_sequence(K, pa, sb, 256, 192))
        for x, y in zip(mod_a.correspondences(K, pa[0], pa[1], sa.xyz, 256,
                                              192, noise_px=0.3),
                        mod_b.correspondences(K, pa[0], pa[1], sb.xyz, 256,
                                              192, noise_px=0.3)):
            np.testing.assert_array_equal(x, y)
        ca = mod_a.make_corridor_scene(pa, num_points=200, seed=2)
        cb = mod_b.make_corridor_scene(pa, num_points=200, seed=2)
        np.testing.assert_array_equal(ca.xyz, cb.xyz)


def test_evaluate_copy_equals_reference():
    rng = np.random.RandomState(0)
    gt = jsyn.make_trajectory(20, step=0.5, seed=1).astype(np.float64)
    est = gt.copy()
    est[:, :3, 3] = 1.7 * est[:, :3, 3] + rng.randn(20, 3) * 0.05
    a, b = evaluate.ate_rmse(est, gt), jeval.ate_rmse(est, gt)
    assert a[0] == b[0]
    np.testing.assert_array_equal(a[2], b[2])
    assert evaluate.rpe(est, gt) == jeval.rpe(est, gt)


def test_metrics_copy_equals_reference():
    """The port's logger (the reference's plus spans and host syncs) logs
    the same records and summary."""
    from vslam_tpu.utils.metrics import MetricsLogger as JLogger
    from vslam_tpu_torch.utils.metrics import MetricsLogger
    logs = []
    for cls in (MetricsLogger, JLogger):
        m = cls()
        for i in range(3):
            m.log(kind="frame", frame=i, num_inliers=10 * i, wall_s=0.5, t=0)
        m.log(kind="ba", frame=2, t=0)
        logs.append((m.records, m.summary()))
    assert logs[0] == logs[1]


# the framework-free modules the port copies byte for byte
COPIES = ("utils/metrics.py", "utils/trajectory.py", "utils/native.py",
          "datasets/loaders.py", "viz/__init__.py", "viz/render.py",
          "viz/frames.py", "viz/stream.py")


@pytest.mark.parametrize("path", COPIES[1:])
def test_copies_equal_the_originals(path):
    """Each copy is its original, byte for byte; the relative imports
    (``..config``, ``..utils.native``, ``..utils.trajectory``) resolve
    inside the port."""
    got = (REPO / "vslam_tpu_torch" / path).read_bytes()
    assert got == (REPO / "vslam_tpu" / path).read_bytes()


def test_trajectory_copy_round_trips(tmp_path):
    """The port's trajectory I/O reads what the reference writes (TUM and
    KITTI) and the other way round."""
    from vslam_tpu.utils import trajectory as jtraj
    from vslam_tpu_torch.utils import trajectory
    poses = jsyn.make_trajectory(6, step=0.5, seed=2)
    for save, load in ((jtraj.save_tum, trajectory.load_tum),
                       (trajectory.save_tum, jtraj.load_tum)):
        save(str(tmp_path / "t.txt"), poses)
        _, got = load(str(tmp_path / "t.txt"))
        np.testing.assert_allclose(got, poses, atol=1e-6)
    trajectory.save_kitti(str(tmp_path / "k.txt"), poses)
    np.testing.assert_allclose(jtraj.load_kitti(str(tmp_path / "k.txt")),
                               poses, atol=1e-6)


def _assert_leaves_equal(want, got, path):
    for f in dataclasses.fields(want):
        w = getattr(want, f.name)
        g = got[f.name]
        assert g.dtype == w.dtype and g.shape == w.shape, (path, f.name)
        np.testing.assert_array_equal(g, w, err_msg=f"{path}.{f.name}")


def test_keyframe_store_and_ba_problem_round_trip():
    """A reference KeyframeStore (two keyframes inserted, empty slots at
    -1) and a reference BAProblem carry across and back unchanged."""
    rng = np.random.RandomState(0)
    n = 64
    store = jkf.empty_store(6, n)
    for i in range(2):
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = rng.randn(3)
        store = jkf.insert_keyframe(
            store, jnp.asarray(pose), jnp.int32(5 * i),
            jnp.asarray(rng.rand(n, 2).astype(np.float32) * 100),
            jnp.asarray(rng.randint(-1, 50, n).astype(np.int32)),
            jnp.asarray(rng.rand(n) < 0.8))
    from tests.test_ba import _make_problem
    problem = _make_problem(n_cams=4, n_points=30)[0]
    for ref, cls in ((store, KeyframeStore), (problem, BAProblem)):
        ref = jax.tree_util.tree_map(np.asarray, ref)
        port = interop.from_jax(ref, cls)
        assert isinstance(port, cls)
        _assert_leaves_equal(ref, interop.to_numpy(port), cls.__name__)
    assert int(port.num_cams) == 4
    st = interop.from_jax(jax.tree_util.tree_map(np.asarray, store),
                          KeyframeStore)
    assert st.ring_size == 6 and int(st.count) == 2
    assert st.kf_order.tolist() == [0, 1, -1, -1, -1, -1]


def test_state_round_trip_through_interop():
    """A reference tracker state (after one step, so map, tracks and
    descriptors are populated) -> port state -> numpy: every leaf equal,
    descriptors bit-identical uint32, the packed map layout kept."""
    cfg = jsmall()
    scene = jsyn.make_scene(num_points=600, seed=0, extent=(14, 6, 40),
                            z_min=6.0)
    poses = jsyn.make_trajectory(3, step=0.6, seed=0)
    frames = jsyn.render_sequence(cfg.camera.K(), poses, scene, 256, 192)
    sj = jtracker.bootstrap(jnp.asarray(frames[0]), cfg)
    sj, _ = jtracker.track_step(sj, jnp.asarray(frames[1]), cfg)
    ref = jax.tree_util.tree_map(np.asarray, sj)
    st = interop.from_jax(ref, TrackerState)
    assert st.map.desc.dtype == torch.int32
    assert st.map.pt.shape == (cfg.map.capacity, 24)
    assert st.map.desc.shape == (cfg.map.capacity * cfg.map.obs_per_point, 8)
    assert isinstance(st.key, torch.Generator)
    back = interop.to_numpy(st)

    def check(want, got, path):
        for f in dataclasses.fields(want):
            w = getattr(want, f.name)
            if dataclasses.is_dataclass(w):
                check(w, got[f.name], f"{path}.{f.name}")
            elif f.name != "key":
                g = got[f.name]
                assert g.dtype == w.dtype and g.shape == w.shape, path
                np.testing.assert_array_equal(g, w, err_msg=f"{path}.{f.name}")
    check(ref, back, "state")
    assert int(ref.map.size) > 0 and ref.pend_valid.any()
    # dicts with the same field names convert too
    st2 = interop.from_jax(back, TrackerState)
    assert torch.equal(st2.map.desc, st.map.desc)


def test_port_imports_without_jax():
    """Every module of vslam_tpu_torch imports with jax and flax blocked."""
    code = (
        "import sys, importlib, pkgutil\n"
        "for m in ('jax', 'jaxlib', 'flax'):\n"
        "    sys.modules[m] = None\n"
        "import vslam_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__,"
        " 'vslam_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert 'vslam_tpu' not in sys.modules\n"
        "print(' '.join(names))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    names = set(r.stdout.split())
    assert len(names) >= 40
    for m in ("cli", "pipeline.scan_driver", "datasets.synthetic_device",
              "datasets.loaders", "utils.checkpoint", "utils.trajectory",
              "utils.native", "viz.render", "viz.frames", "viz.stream"):
        assert f"vslam_tpu_torch.{m}" in names, m


def test_chip_smoke_refuses_without_a_gpu(tmp_path):
    """chip_smoke.py exits nonzero with no result line when no CUDA device
    is visible, and when it sits alone in a directory."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0 and '"ok"' not in r.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    r = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                       env=dict(env, PYTHONPATH=""), capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0 and '"ok"' not in r.stdout


@pytest.mark.parametrize("D", [2, 4])
def test_map_shards_concatenate_to_the_map(D):
    """``interop.map_shard``: a reference map's shards, concatenated along
    every point-indexed field, equal ``from_jax`` of the whole map; the
    cursor is each shard's, replicated."""
    from vslam_tpu.core.types import empty_map as jempty_map
    from vslam_tpu.mapping import point_map as jpoint_map
    from vslam_tpu_torch.core.types import MapState

    rng = np.random.RandomState(D)
    n = 300
    m = jpoint_map.insert_points(
        jempty_map(512, 3), jnp.asarray(rng.randn(n, 3).astype(np.float32)),
        jnp.asarray(rng.rand(n, 3).astype(np.float32)),
        jnp.asarray(rng.randint(0, 2 ** 32, (n, 8), dtype=np.uint32)),
        jnp.asarray(rng.rand(n) < 0.9), 4)
    tree = jax.tree_util.tree_map(np.asarray, m)
    whole = interop.from_jax(tree, MapState)
    shards = [interop.map_shard(tree, i, D) for i in range(D)]
    for f in ("pt", "desc", "desc_count", "alive", "last_seen", "prov"):
        got = torch.cat([getattr(s, f) for s in shards])
        assert torch.equal(got, getattr(whole, f)), f
    assert all(s.capacity == 512 // D and s.obs_slots == 3 for s in shards)
    assert all(int(s.size) == int(whole.size) > 0 for s in shards)
