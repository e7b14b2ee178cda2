"""Frozen copies of the port's eager drivers, and the comparisons that
hold the graph-driven ones to them.

``EagerProcess`` is ``SLAMSystem`` with ``process`` as it was before the
step went through ``scan_driver``: the eager ``tracker.track_step`` (with
the system's mesh, if any) and one ``torch.cat`` fetch.
``eager_batched_track_step`` is ``parallel.multi_sequence.
batched_track_step`` as it was before it could replay a graph: a loop of
eager ``track_step``s, then one ``all_gather`` a field. Both call the
step under ``utils.jit.disable_jit``, so on a card too it runs eagerly
(a direct call there replays a cached graph). numpy, torch and
the port only, never jax: the spawned ranks of tests/torch_dist.py and the
``gpu`` tests' spawned processes import it.
"""
import dataclasses

import numpy as np
import torch

from vslam_tpu_torch.config import MapConfig, small_config
from vslam_tpu_torch.datasets import synthetic
from vslam_tpu_torch.parallel.mesh import all_gather
from vslam_tpu_torch.pipeline import keyframes, scan_driver, slam, tracker
from vslam_tpu_torch.utils import jit

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

        with jit.disable_jit():
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


def frames(n=N_FRAMES, seed=2, cfg=CFG):
    """tests/test_slam.py's scene, seen by ``cfg``'s camera."""
    cam = cfg.camera
    scene = synthetic.make_scene(num_points=700, seed=seed,
                                 extent=(14, 6, 45), z_min=6.0)
    poses = synthetic.make_trajectory(n, step=0.6, yaw_rate=0.01, seed=seed)
    return np.stack(synthetic.render_sequence(cam.K(), poses, scene,
                                              cam.width, cam.height))


def tensors(obj, path=""):
    """(name, tensor) of every tensor of a dataclass of tensors, nested
    dataclasses included."""
    out = []
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out += tensors(v, path + f.name + ".")
        elif isinstance(v, torch.Tensor):
            out.append((path + f.name, v))
    return out


# what the frozen driver predates: the spans and sync count of a record,
# the step graph's stage times and the solves' device times
TRACING = ("spans", "syncs", "device_ms", "solve_device_ms")


def strip(records):
    """Records without the host clock's keys, the tracing's and the
    counters the carry notes (``scan_driver.NOTED``), which the frozen
    driver's ``TrackOutput`` fetch does not hold."""
    return [{k: v for k, v in r.items()
             if k not in ("t", "wall_s", "capture_s") + TRACING
             + scan_driver.NOTED}
            for r in records]


def run(cls, cfg, rng, frames, dev, mesh=None):
    """``frames`` through a new ``cls`` system (on ``mesh`` if given).
    Returns it, the info dicts and each tracked frame's ``last_output``."""
    s = cls(cfg, dev, rng=rng, mesh=mesh)
    infos, outs = [], []
    for f in frames:
        infos.append(s.process(torch.from_numpy(f).to(dev)))
        outs.append(s.last_output)
    return s, infos, outs[1:]


def assert_same_run(a, ia, oa, b, ib, ob):
    """Two systems' runs equal: info dicts and metrics records (host clock
    apart), trajectory, keyframe store, state, RANSAC stream, and every
    frame's last output as the run ends (no later frame overwrote one)."""
    assert strip(ia) == strip(ib)
    assert strip(a.metrics.records) == strip(b.metrics.records)
    assert len(a.trajectory) == len(b.trajectory)
    for i, (x, y) in enumerate(zip(a.trajectory, b.trajectory)):
        assert np.array_equal(x, y), i
    for obj in ("state", "kf_store"):
        for (name, x), (_, y) in zip(tensors(getattr(a, obj)),
                                     tensors(getattr(b, obj))):
            assert x.dtype == y.dtype and torch.equal(x, y), (obj, name)
    if isinstance(a.state.key, torch.Generator):
        assert torch.equal(a.state.key.get_state(), b.state.key.get_state())
    assert len(oa) == len(ob) == len(ia) - 1
    for i, (p, q) in enumerate(zip(oa, ob), 1):
        for name, x, y in zip(tracker.TrackOutput._fields, p, q):
            assert torch.equal(x, y), (i, name)
    assert a.dropped_inserts_total == b.dropped_inserts_total
    assert a.maintenance_runs == b.maintenance_runs


def premises(s, infos):
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


def eager_batched_track_step(state, imgs, cfg, mesh, axis_name: str):
    """``multi_sequence.batched_track_step`` as it was: each of this
    rank's sequences' eager ``track_step``, then the gather."""
    with jit.disable_jit():
        steps = [tracker.track_step(st, imgs[state.first + j], cfg)
                 for j, st in enumerate(state.states)]
    S = state.num_sequences
    out = tracker.TrackOutput(*(
        all_gather(mesh, axis_name, torch.stack(f)).reshape(
            (S,) + tuple(f[0].shape))
        for f in zip(*(o for _, o in steps))))
    return dataclasses.replace(state, states=[s for s, _ in steps]), out
