"""The reference's random stream in the port, and the revisit segment run
on it against the reference.

``utils.threefry`` reproduces ``jax.random``'s Threefry draws bit for bit,
so ``rng="threefry"`` gives the port the reference's own RANSAC samples.
On that stream, ``scripts/endurance.py``'s revisit scene (scene seed 2,
system seed 7, 100 frames, a keyframe every 2nd frame, window BA every
5th keyframe) runs through the reference's ``SLAMSystem.process`` and the
port's ``process_chunk`` in chunks of 10 (``tools.endurance``'s driver,
phase 15c of ``chip_smoke.py``), window BA on and off. Held:

  * per frame, the keyframe / success / maintenance decisions are equal;
  * every window-BA event has the same outcome (skipped and why, or solved
    and accepted or not), with initial and final costs within 1e-2
    relative: the pose chains part in their last f32 digits from the
    first frames on (tests/test_torch_tracker.py: 1e-3) and those
    differences compound over 100 frames. (The chunk driver logs an event
    one frame later than ``process``: after the chunk that ends on the
    keyframe);
  * poses within 5e-3 of the reference's over the first 40 frames, the
    tolerance of the 24-frame parity (tests/test_torch_slam.py); later a
    count over a threshold flips by one, a window problem differs by a
    landmark, and the chains part;
  * each run's ATE within 10% of the reference's;
  * the reference's revisit bound, BA on <= 1.05 x BA off + 1e-3, on both.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vslam_tpu.config import small_config as jsmall_config
from vslam_tpu.datasets import synthetic
from vslam_tpu.geometry import ransac as jransac
from vslam_tpu.pipeline import slam as jslam
from vslam_tpu_torch.geometry import ransac
from vslam_tpu_torch.pipeline import slam
from vslam_tpu_torch.tools import endurance
from vslam_tpu_torch.utils import checkpoint, evaluate, threefry

torch.set_num_threads(2)

SEED, SCENE, FRAMES, CHUNK = 7, 2, 100, 10
FLAGS = ("keyframe", "success", "ran_maintenance")


def _words(k):
    return np.asarray(k).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 32 - 1])
def test_threefry_matches_jax_random(seed):
    k, t = jax.random.PRNGKey(seed), threefry.key(seed)
    np.testing.assert_array_equal(t.numpy(), _words(k))
    for d in (0, 1, 99, 2 ** 31 + 3):
        np.testing.assert_array_equal(threefry.fold_in(t, d).numpy(),
                                      _words(jax.random.fold_in(k, d)))
    for got, want in zip(threefry.split(t), jax.random.split(k)):
        np.testing.assert_array_equal(got.numpy(), _words(want))
    np.testing.assert_array_equal(threefry.bits(t, (5, 3)).numpy(),
                                  _words(jax.random.bits(k, (5, 3))))
    for m in (1, 7, 300, 3072, 70000, 2 ** 31 - 1):
        np.testing.assert_array_equal(
            threefry.randint(t, (128, 8), m).numpy(),
            np.asarray(jax.random.randint(k, (128, 8), 0, m)))


@pytest.mark.parametrize("frame_idx", [1, 50])
def test_samples_match_reference(frame_idx):
    """The tracker's draw: fold_in(key, frame_idx), then the minimal sets
    over the match mask, index for index."""
    w = (np.random.RandomState(frame_idx).rand(3072) > 0.6).astype(np.float32)
    want = jransac.sample_minimal_sets(
        jax.random.fold_in(jax.random.PRNGKey(SEED), frame_idx),
        jnp.asarray(w), 128, 8)
    key = threefry.fold_in(threefry.key(SEED),
                           torch.tensor(frame_idx, dtype=torch.int32))
    got = ransac.sample_minimal_sets(key, torch.from_numpy(w), 128, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _config(cfg):
    cfg = cfg.replace(pipeline=dataclasses.replace(
        cfg.pipeline, keyframe_every=5, max_keyframes=256, local_ba_every=5),
        map=dataclasses.replace(cfg.map, capacity=1024))
    return endurance.revisit_config(cfg)


def _rows(s, kind):
    return [r for r in s.metrics.records if r.get("kind") == kind
            and (kind != "frame" or "success" in r)]


@pytest.fixture(scope="module")
def revisit():
    """Both systems over the revisit scene, window BA on and off."""
    jcfg, tcfg = _config(jsmall_config()), endurance.config()
    tcfg = endurance.revisit_config(tcfg)
    K = jcfg.camera.K()
    gt = synthetic.make_trajectory(FRAMES, step=0.35, yaw_rate=0.002,
                                   seed=SCENE)
    scene = synthetic.make_scene(num_points=900, seed=SCENE,
                                 extent=(16, 6, 60), z_min=6.0)
    frames = [synthetic.render_frame(K, gt[i], scene, jcfg.camera.width,
                                     jcfg.camera.height)
              for i in range(FRAMES)]
    runs = {}
    for ba in (True, False):
        ref = jslam.SLAMSystem(jcfg, seed=SEED, enable_ba=ba)
        for f in frames:
            ref.process(f)
        port = slam.SLAMSystem(tcfg, "cpu", seed=SEED, enable_ba=ba,
                               rng="threefry")
        endurance._drive(port, frames, CHUNK)
        runs[ba] = (ref, port)
    return runs, gt.astype(np.float64)


@pytest.mark.parametrize("ba", [True, False], ids=["ba", "no_ba"])
def test_revisit_decisions_match_reference(revisit, ba):
    ref, port = revisit[0][ba]
    rj, rt = _rows(ref, "frame"), _rows(port, "frame")
    assert len(rj) == len(rt) == FRAMES - 1
    for x, y in zip(rj, rt):
        for k in FLAGS:
            assert x[k] == y[k], (x["frame"], k, x[k], y[k])
    assert all(x["success"] for x in rj)


def test_revisit_ba_events_match_reference(revisit):
    ref, port = revisit[0][True]
    ej, et = _rows(ref, "ba"), _rows(port, "ba")
    assert [e["frame"] + 1 for e in ej] == [e["frame"] for e in et]
    for a, b in zip(ej, et):
        assert a.get("skipped") == b.get("skipped"), (a, b)
        assert a["ba_result_accepted"] == b["ba_result_accepted"], (a, b)
        if "skipped" not in a:
            for k in ("initial_cost", "final_cost"):
                np.testing.assert_allclose(b[k], a[k], rtol=1e-2,
                                           err_msg=f"frame {a['frame']}")
    # premise: the run skips events and accepts others
    assert any("skipped" in e for e in ej)
    assert sum(e["ba_result_accepted"] for e in ej) >= 2


def _ate(s, gt):
    return evaluate.ate_rmse(s.poses(), gt)[0]


@pytest.mark.parametrize("ba", [True, False], ids=["ba", "no_ba"])
def test_revisit_ate_matches_reference(revisit, ba):
    (ref, port), gt = revisit[0][ba], revisit[1]
    err = np.abs(ref.poses() - port.poses()).max(axis=(1, 2))
    assert err[:40].max() <= 5e-3, err
    a, b = _ate(ref, gt), _ate(port, gt)
    assert abs(a - b) <= 0.1 * a, (a, b)


def test_revisit_window_ba_within_reference_bound(revisit):
    runs, gt = revisit
    for i in (0, 1):         # the reference, then the port
        on, off = _ate(runs[True][i], gt), _ate(runs[False][i], gt)
        assert on <= 1.05 * off + 1e-3, (i, on, off)


def test_checkpoint_keeps_the_threefry_key(tmp_path):
    """A Threefry key is saved as the reference saves its key (the words of
    PRNGKey(seed)) and restored as a key, not a generator."""
    cfg = endurance.revisit_config(endurance.config())
    K = cfg.camera.K()
    gt = synthetic.make_trajectory(2, step=0.35, seed=SCENE)
    scene = synthetic.make_scene(num_points=300, seed=SCENE,
                                 extent=(16, 6, 60), z_min=6.0)
    s = slam.SLAMSystem(cfg, "cpu", seed=SEED, rng="threefry")
    s.process(synthetic.render_frame(K, gt[0], scene, cfg.camera.width,
                                     cfg.camera.height))
    path = checkpoint.save_state(str(tmp_path / "ck"), s)
    with np.load(path + ".npz") as npz:
        np.testing.assert_array_equal(npz["state/key"],
                                      np.asarray(jax.random.PRNGKey(SEED)))
    t = slam.SLAMSystem(cfg, "cpu", rng="threefry")
    checkpoint.load_state(path, t)
    assert isinstance(t.state.key, torch.Tensor)
    np.testing.assert_array_equal(t.state.key.numpy(),
                                  _words(jax.random.PRNGKey(SEED)))
