"""``SLAMSystem.process`` through ``scan_driver``'s step graph, and window
BA's ``solve_robust`` as a captured graph, against frozen copies of the
eager versions.

On the CPU ``process`` goes through the same plumbing as on a card
(``scan_driver.track_frame`` over ``step_body``, the packed row, the
``TrackOutput`` it returns) with the step run eagerly; here it is held to
``EagerProcess``, a frozen copy of the driver as it was before (eager
``tracker.track_step``, one ``torch.cat`` fetch): the same info dicts
(apart from ``wall_s``), metrics records, trajectory, keyframe store,
state and last output, exactly. The config adds structure refinement and
a map of 512 slots to the small config, so every case has a solved
window-BA event, a structure refinement and a maintenance pass.

The ``gpu`` cases hold, on the card, ``process`` replaying its captured
step to the same frames through the eager step, bit for bit, and the
captured ``solve_robust`` to the eager one. The module imports no jax;
run them there with

    python -m pytest tests/test_torch_process_graph.py -m gpu --noconftest -q
"""
import dataclasses

import numpy as np
import pytest
import torch

from vslam_tpu_torch.config import MapConfig, small_config
from vslam_tpu_torch.datasets import synthetic
from vslam_tpu_torch.ops import associate as k2
from vslam_tpu_torch.ops import hamming as k1
from vslam_tpu_torch.optimizer import ba
from vslam_tpu_torch.pipeline import keyframes, scan_driver, slam, tracker
from vslam_tpu_torch.utils import checkpoint

torch.set_num_threads(2)

_SMALL = small_config()
# structure refinement every 2nd keyframe; a 512-slot map, so maintenance
# runs (high-water 256)
CFG = _SMALL.replace(
    ba=dataclasses.replace(_SMALL.ba, structure_every=2),
    map=MapConfig(capacity=512, obs_per_point=4, block_size=32))
VARIANTS = CFG.replace(frontend=dataclasses.replace(
    CFG.frontend, oriented=True, track_carry=True))
CASES = {"torch": (CFG, "torch"), "threefry": (CFG, "threefry"),
         "variants": (VARIANTS, "torch")}
N_FRAMES = 16

# TrackOutput scalars fetched with the pose in one transfer per frame
_SCALARS = ("num_matches", "num_inliers", "num_associated",
            "num_tracked_map", "num_tracked_prov", "num_pnp_inliers",
            "num_refined", "num_promoted", "num_new_points",
            "num_dropped_inserts", "map_size", "map_alive", "scale",
            "success")


class EagerProcess(slam.SLAMSystem):
    """``SLAMSystem`` with ``process`` frozen as it was before the step
    went through ``scan_driver``: the eager ``tracker.track_step`` and one
    ``torch.cat`` fetch of the pose and counters."""

    def process(self, img):
        import time
        t0 = time.perf_counter()
        if self.state is None:
            state = tracker.bootstrap(img, self.cfg, self.device,
                                      seed=self._seed, rng=self._rng)
            self.state = state.replace(map=self._local(state.map))
            self.trajectory.append(np.eye(4, dtype=np.float32))
            info = {"kind": "frame", "frame": 0, "bootstrap": True,
                    "wall_s": time.perf_counter() - t0}
            self.metrics.log(**info)
            self.frame_idx = 1
            return info

        self.state, out = tracker.track_step(self.state, img, self.cfg,
                                             mesh=self.mesh,
                                             map_axis=self._map_axis)
        self.last_output = out
        host = torch.cat([
            out.pose.reshape(16).to(torch.float64),
            torch.stack([getattr(out, k).reshape(()).to(torch.float64)
                         for k in _SCALARS])]).cpu().numpy()
        pose = host[:16].reshape(4, 4).astype(np.float32)
        o = dict(zip(_SCALARS, host[16:].tolist()))
        self.trajectory.append(pose)
        counts = {k: int(o[k]) for k in _SCALARS[:-2]}
        success = bool(o["success"])

        inlier_ratio = counts["num_inliers"] / max(counts["num_matches"], 1.0)
        is_kf = (
            self.frame_idx % self.cfg.pipeline.keyframe_every == 0
            or inlier_ratio < self.cfg.pipeline.keyframe_min_inlier_ratio
        )
        ran_ba = False
        if is_kf and success:
            self.kf_store = keyframes.insert_keyframe(
                self.kf_store, self.state.pose,
                torch.full((), self.frame_idx, dtype=torch.int32,
                           device=self.device),
                self.state.prev.uv, self.state.prev_map_id,
                self.state.prev.mask)
            self._kf_count += 1
            se = self.cfg.ba.structure_every
            if (self.enable_ba and se > 0 and self._kf_count >= 3
                    and self._kf_count % se == 0):
                self._refine_structure()
            if (self.enable_ba and self._kf_count >= 3
                    and self._kf_count % self.cfg.pipeline.local_ba_every
                    == 0):
                ran_ba = True
                self._run_window_ba()

        self.dropped_inserts_total += counts["num_dropped_inserts"]
        ran_maintenance = False
        if counts["map_size"] >= self._maint_high_water:
            m2, pid2, obs2 = scan_driver._maintenance(
                self.whole_map(), self.state.prev_map_id,
                self.kf_store.obs_pid, self._maint_min_free)
            self.state = self.state.replace(map=self._local(m2),
                                            prev_map_id=pid2)
            self.kf_store = self.kf_store.replace(
                obs_pid=obs2, obs_mask=self.kf_store.obs_mask & (obs2 >= 0))
            self.maintenance_runs += 1
            ran_maintenance = True
            self.metrics.log(kind="map_maintenance", frame=self.frame_idx,
                             size_before=counts["map_size"],
                             size_after=int(m2.size))

        info = {"kind": "frame", "frame": self.frame_idx, **counts,
                "scale": o["scale"], "success": success,
                "keyframe": bool(is_kf), "ran_ba": ran_ba,
                "ran_maintenance": ran_maintenance,
                "wall_s": time.perf_counter() - t0}
        self.metrics.log(**info)
        self.frame_idx += 1
        return info


def _frames(n=N_FRAMES, seed=2):
    """tests/test_slam.py's scene."""
    K = CFG.camera.K()
    scene = synthetic.make_scene(num_points=700, seed=seed,
                                 extent=(14, 6, 45), z_min=6.0)
    poses = synthetic.make_trajectory(n, step=0.6, yaw_rate=0.01, seed=seed)
    return np.stack(synthetic.render_sequence(K, poses, scene,
                                              CFG.camera.width,
                                              CFG.camera.height))


def _tensors(obj, path=""):
    """(name, tensor) of every tensor of a dataclass of tensors, nested
    dataclasses included."""
    out = []
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out += _tensors(v, path + f.name + ".")
        elif isinstance(v, torch.Tensor):
            out.append((path + f.name, v))
    return out


def _strip(records):
    """Records without the host clock's keys."""
    return [{k: v for k, v in r.items() if k not in ("t", "wall_s",
                                                     "capture_s")}
            for r in records]


def _run(cls, cfg, rng, frames, dev):
    """``frames`` through a new ``cls`` system. Returns it, the info dicts
    and each tracked frame's ``last_output``."""
    s = cls(cfg, dev, rng=rng)
    infos, outs = [], []
    for f in frames:
        infos.append(s.process(torch.from_numpy(f).to(dev)))
        outs.append(s.last_output)
    return s, infos, outs[1:]


def _assert_same_run(a, ia, oa, b, ib, ob):
    """Two systems' runs equal: info dicts and metrics records (host clock
    apart), trajectory, keyframe store, state, RANSAC stream, and every
    frame's last output as the run ends (no later frame overwrote one)."""
    assert _strip(ia) == _strip(ib)
    assert _strip(a.metrics.records) == _strip(b.metrics.records)
    assert len(a.trajectory) == len(b.trajectory)
    for i, (x, y) in enumerate(zip(a.trajectory, b.trajectory)):
        assert np.array_equal(x, y), i
    for obj in ("state", "kf_store"):
        for (name, x), (_, y) in zip(_tensors(getattr(a, obj)),
                                     _tensors(getattr(b, obj))):
            assert x.dtype == y.dtype and torch.equal(x, y), (obj, name)
    if isinstance(a.state.key, torch.Generator):
        assert torch.equal(a.state.key.get_state(), b.state.key.get_state())
    assert len(oa) == len(ob) == len(ia) - 1
    for i, (p, q) in enumerate(zip(oa, ob), 1):
        for name, x, y in zip(tracker.TrackOutput._fields, p, q):
            assert torch.equal(x, y), (i, name)
    assert a.dropped_inserts_total == b.dropped_inserts_total
    assert a.maintenance_runs == b.maintenance_runs


def _premises(s, infos):
    """What the cases are for: a solved window-BA event, a structure
    refinement and a maintenance pass, and tracking throughout."""
    kinds = [r["kind"] for r in s.metrics.records]
    solved = [r for r in s.metrics.records
              if r["kind"] == "ba" and "skipped" not in r]
    assert solved, "premise: a solved window-BA event"
    assert "structure_refine" in kinds, "premise: a structure refinement"
    assert s.maintenance_runs >= 1, "premise: a maintenance pass"
    assert sum(x["success"] for x in infos[1:]) >= len(infos) - 3
    return solved


@pytest.fixture(scope="module")
def frames():
    return _frames()


@pytest.mark.parametrize("case", list(CASES))
def test_process_matches_frozen_eager_process(frames, case):
    """The CPU: ``process`` through ``scan_driver.track_frame`` equals the
    frozen eager driver, with window BA, structure refinement and
    maintenance in the run."""
    cfg, rng = CASES[case]
    a, ia, oa = _run(slam.SLAMSystem, cfg, rng, frames, "cpu")
    b, ib, ob = _run(EagerProcess, cfg, rng, frames, "cpu")
    _premises(a, ia)
    assert a.step_graph is None and a.ba_graphs == {}
    assert not any("capture_s" in x for x in ia)
    _assert_same_run(a, ia, oa, b, ib, ob)


def test_solve_wrapper_on_cpu_is_solve_robust(frames):
    """``SLAMSystem._solve_robust`` on the CPU is ``ba.solve_robust``:
    every output equal, at both of the system's settings (window BA and
    structure refinement), and no graph is made."""
    s = _run(slam.SLAMSystem, CFG, "torch", frames[:10], "cpu")[0]
    wp = keyframes.build_window_problem(
        s.kf_store, s.state.map, CFG, free_tail=CFG.ba.free_cams,
        prov_min_obs=99)
    for cfg_ba, reject_px in ((CFG.ba, 5.0),
                              (dataclasses.replace(CFG.ba, iterations=6),
                               3.0)):
        got_p, got = s._solve_robust(wp.problem, cfg_ba, reject_px, 2)
        want_p, want = ba.solve_robust(wp.problem, s._K, cfg_ba,
                                       reject_px=reject_px, rounds=2)
        _assert_same_solve(got_p, got, want_p, want)
    assert int(wp.problem.point_mask.sum()) > 0      # premise: a problem
    assert s.ba_graphs == {}


def _assert_same_solve(got_p, got, want_p, want):
    for name, x in _tensors(got_p):
        assert torch.equal(x, getattr(want_p, name)), name
    for name, x, y in zip(ba.BAStats._fields, got, want):
        assert torch.equal(x, y), name


# --- on the card ---------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs and the hand kernels "
                    "have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
def test_process_graph_bit_equal_to_eager_step_on_cuda(cuda, frames, case):
    """On the card: ``process`` replaying its captured step equals the
    same frames through the eager ``track_step`` with the same host logic
    (``EagerProcess``), bit for bit. The step graph is captured at the
    bootstrap frame, once, and replayed once per tracked frame: the
    kernels' wrappers launch only in the bootstrap frame's warm-up and
    capture. Every window solve replays a graph cached by its key: one for
    window BA, one for structure refinement."""
    cfg, rng = CASES[case]
    b, ib, ob = _run(EagerProcess, cfg, rng, frames, cuda)
    s = slam.SLAMSystem(cfg, cuda, rng=rng)
    ia = [s.process(torch.from_numpy(frames[0]).to(cuda))]
    g = s.step_graph
    assert g.graph is not None and ia[0]["capture_s"] == g.capture_s > 0
    before = (k1.launches, k2.launches)
    oa = []
    for f in frames[1:]:
        ia.append(s.process(torch.from_numpy(f).to(cuda)))
        oa.append(s.last_output)
    assert (k1.launches, k2.launches) == before   # no eager step ran
    assert g.replays == len(frames) - 1
    assert g.captured_launches == {"hamming": 1, "associate": 1}
    assert not any("capture_s" in x for x in ia[1:])
    _assert_same_run(s, ia, oa, b, ib, ob)
    solved = _premises(s, ia)
    n_struct = sum(r["kind"] == "structure_refine"
                   for r in s.metrics.records)
    assert len(s.ba_graphs) == 2
    assert sum(x.replays for x in s.ba_graphs.values()) \
        == len(solved) + n_struct


def _window_problem(dev, frames):
    s = _run(slam.SLAMSystem, CFG, "torch", frames[:10], dev)[0]
    wp = keyframes.build_window_problem(
        s.kf_store, s.state.map, CFG, free_tail=CFG.ba.free_cams,
        prov_min_obs=99)
    assert int(wp.problem.point_mask.sum()) > 0      # premise: a problem
    return s, wp.problem


@pytest.mark.gpu
def test_solve_graph_bit_equal_to_eager_on_cuda(cuda, frames):
    """Two eager ``solve_robust``s on the card are bit-equal to each
    other, and the captured solve is bit-equal to them: the solved poses
    and points, both masks and every ``BAStats`` field. A second call at
    the same key replays the cached graph and captures none; another
    ``reject_px`` is another key."""
    s, p = _window_problem(cuda, frames)
    s.ba_graphs.clear()
    want_p, want = ba.solve_robust(p, s._K, CFG.ba, reject_px=5.0, rounds=2)
    again_p, again = ba.solve_robust(p, s._K, CFG.ba, reject_px=5.0,
                                     rounds=2)
    _assert_same_solve(again_p, again, want_p, want)
    got_p, got = s._solve_robust(p, CFG.ba, 5.0, 2)
    _assert_same_solve(got_p, got, want_p, want)
    (g,) = s.ba_graphs.values()
    assert g.replays == 1 and g.capture_s > 0
    got_p, got = s._solve_robust(p, CFG.ba, 5.0, 2)
    _assert_same_solve(got_p, got, want_p, want)
    assert list(s.ba_graphs.values()) == [g] and g.replays == 2
    s._solve_robust(p, CFG.ba, 3.0, 2)
    assert len(s.ba_graphs) == 2


@pytest.mark.gpu
def test_restored_system_captures_on_first_tracked_frame(cuda, frames,
                                                          tmp_path):
    """A system restored by ``load_state`` has no step graph until its
    first tracked frame, which captures it (``capture_s`` in that frame's
    info) and replays it; from there it tracks as the system it was saved
    from, bit for bit."""
    cut = 6
    a = slam.SLAMSystem(CFG, cuda, rng="threefry")
    for f in frames[:cut]:
        a.process(torch.from_numpy(f).to(cuda))
    path = str(tmp_path / "ckpt")
    checkpoint.save_state(path, a)
    b = slam.SLAMSystem(CFG, cuda, rng="threefry")
    checkpoint.load_state(path, b)
    assert b.step_graph.graph is None
    ia, ib = [], []
    for f in frames[cut:]:
        x = torch.from_numpy(f).to(cuda)
        ia.append(a.process(x))
        ib.append(b.process(x))
    assert ib[0]["capture_s"] == b.step_graph.capture_s > 0
    assert b.step_graph.replays == len(frames) - cut
    assert _strip(ia) == _strip(ib)
    for x, y in zip(a.trajectory[cut:], b.trajectory[cut:]):
        assert np.array_equal(x, y)
    for (name, x), (_, y) in zip(_tensors(a.state), _tensors(b.state)):
        assert torch.equal(x, y), name
