"""Full SLAM system: tracking + keyframing + map maintenance + window BA.

Port of ``vslam_tpu/pipeline/slam.py``. The host loop moves
images in and scalars out: each ordinary frame (neither a keyframe nor a
BA frame) costs one device-to-host transfer, the packed pose and counters
of the step; a BA attempt adds one more for its gate statistics before
deciding whether to solve. ``process_chunk`` runs T frames through the
chunked driver (``scan_driver``) with one transfer per chunk. The window-BA
guards are host-side numpy on the solved window, as in the reference, and
what they write back re-enters as float32 on the system's device. The
reference's comments give the measurements behind every guard and
constant; this file keeps the what.

Every host read of the driver goes through ``MetricsLogger.fetch``, which
counts it, and each stretch of its host work is a ``MetricsLogger.span``:
a frame's record holds its ``spans`` (upload, step, fetch, keyframe,
structure, ba.build / gates / solve / guards / apply, maintenance) and
``syncs`` (1 on an ordinary frame); with a step graph made with
``span=True``, also ``device_ms``, the replay's device ms by stage. Window
BA and structure refinement on a card time their solve with two CUDA
events (``solve_device_ms`` in their records).

On a card the system runs what ``jax.jit`` compiles in the reference as
CUDA graphs: ``process`` replays one captured ``track_step``
(``scan_driver.step_graph``, captured at the bootstrap frame) per frame,
``process_chunk`` one captured frame body per frame, and window BA and
structure refinement one captured ``solve_robust`` per event
(``_solve_robust``). These graphs are the system's own, held on it
beside ``utils.jit``'s process cache, which direct calls of
``track_step`` and the solves replay; ``utils.jit.disable_jit`` leaves
them as they are. The host's decisions and writes (keyframes, BA's
guards, maintenance) run eagerly between replays; the state is copied
into the graph at every call. A capture or replay that fails raises:
nothing falls back to the eager step. Global BA runs eagerly, under
``disable_jit`` (once a run, at a shape that depends on the run), and
the CPU runs everything eagerly.

With a mesh (``parallel.mesh.make_mesh``) every rank runs this same loop
and holds its block of the map (BASELINE config 4): each step is
``track_step(mesh=)``, and every host decision reads replicated values, so
all ranks take the same branches. On an NCCL mesh the step graph holds
the sharded step and its collectives; on a gloo mesh, whose collectives
cannot be captured (``parallel.mesh.capturable``), the step runs eagerly
(``step_graph`` is None), decided at construction. NCCL's teardown
(``destroy_process_group``) waits for every graph that captured its
collectives, so a rank leaves the group through
``parallel.multihost.shutdown``, which frees them first. Maintenance, the
window problems, their write-back, ``snapshot`` and checkpoints need the
whole map: they gather it (``sharded_map.gather_map_state``), run the
single-device function on every rank (stable sorts make it
deterministic) and shard the result again. That moves the whole map once
per event, about 30 MB at the default 131072 slots x 4 descriptors
(``pt`` 12.6 MB, ``desc`` 16.8 MB).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import VSLAMConfig
from ..optimizer import ba
from ..parallel import sharded_map
from ..parallel.mesh import axis_size, capturable
from ..utils import jit
from ..utils.metrics import MetricsLogger
from ..utils.profiling import use_graph_stream
from . import keyframes, scan_driver, tracker

# the counters of a frame's info, in ChunkScalars' order
_COUNTS = scan_driver.ChunkScalars._fields[1:13]


def _counters(cfg: VSLAMConfig):
    """The counters of a frame's info: ``_COUNTS``, and where the front end
    carries keypoints (``track_carry``) the ones the carry notes."""
    return _COUNTS + (scan_driver.NOTED if cfg.frontend.track_carry else ())


def _np(x: torch.Tensor) -> np.ndarray:
    """Host numpy copy of a tensor on any device."""
    return x.detach().cpu().numpy()


def _centers(T_cw: np.ndarray) -> np.ndarray:
    """Camera centers C = -R^T t of (W, 4, 4) world->camera transforms."""
    return -np.einsum("wji,wj->wi", T_cw[:, :3, :3], T_cw[:, :3, 3])


def _record(events, i: int) -> None:
    """Record ``events[i]`` (``SLAMSystem._timing_events``) on the current
    stream; nothing without events."""
    if events is not None:
        events[i].record()


def _solve_ms(events) -> Dict:
    """A record's ``solve_device_ms``: the device ms between two recorded
    timing events, read once a fetch has waited for them ({} without)."""
    if events is None:
        return {}
    return {"solve_device_ms": events[0].elapsed_time(events[1])}


def _window_gate_stats(problem: ba.BAProblem, sel_prov):
    """All pre-solve window gate quantities as four 0-d tensors (the
    caller fetches them in one transfer): free-camera observations, free
    cameras, deep-revisit observations, solid bridge observations."""
    fixed = problem.cam_fixed
    ofix = fixed[problem.obs_cam.long()]
    ofree_cam = ~ofix
    om = problem.obs_mask
    pm = problem.point_mask
    n_obs_free = (om & ofree_cam & pm[:, None]).sum()
    n_free = (problem.cam_mask & ~fixed).sum()
    nfix = (ofix & om).sum(dim=1)
    nfree_o = (ofree_cam & om).sum(dim=1)
    deep = pm & (nfix >= 2) & (nfree_o >= 1)
    deep_obs = (om & deep[:, None]).sum()
    bridge = ((ofix & om).any(dim=1) & (ofree_cam & om).any(dim=1)
              & pm & ~sel_prov)
    solid_obs = (ofix & om & bridge[:, None]).sum()
    return n_obs_free, n_free, deep_obs, solid_obs


class SLAMSystem:
    """Monocular SLAM over a frame stream, on one device or, with ``mesh``,
    with the map sharded over the mesh's ``cfg.mesh.axis_map`` axis.
    ``rng="threefry"`` draws RANSAC samples from the reference's own
    ``jax.random`` stream for ``seed`` (``tracker.init_state``)."""

    def __init__(self, cfg: VSLAMConfig, device="cuda",
                 metrics_path: Optional[str] = None, seed: int = 0,
                 enable_ba: bool = True, mesh=None, rng: str = "torch"):
        self.mesh = mesh
        self._map_axis = cfg.mesh.axis_map
        if mesh is not None:
            if self._map_axis not in mesh.mesh_dim_names:
                raise ValueError(f"mesh {mesh} has no axis "
                                 f"{self._map_axis!r}")
            n = axis_size(mesh, self._map_axis)
            if cfg.map.capacity % n or \
                    (cfg.map.capacity // n) % cfg.map.block_size:
                raise ValueError("per-shard capacity must be a multiple of "
                                 f"the block size: {cfg.map.capacity} over "
                                 f"{n}, block {cfg.map.block_size}")
        self.cfg = cfg
        self.device = torch.device(device)
        # all of this system's work on a card on one stream, from its
        # first (``scan_driver.ChunkGraph``)
        use_graph_stream(self.device)
        self.metrics = MetricsLogger(metrics_path)
        self.enable_ba = enable_ba
        self._seed = seed
        self._rng = rng
        self.state: Optional[tracker.TrackerState] = None
        # the ring holds up to max_keyframes so global BA covers the run
        self.kf_store = keyframes.empty_store(
            ring_size=max(cfg.pipeline.max_keyframes, 2 * cfg.ba.window),
            n_kp=cfg.frontend.max_keypoints, device=self.device)
        self.trajectory: List[np.ndarray] = []
        self.frame_idx = 0
        self._kf_count = 0
        self._K = tracker._K(cfg, self.device)
        self.last_ba_stats = None
        self.last_output = None     # the last step's TrackOutput (device)
        # map maintenance: compact when the cursor passes the high-water
        # mark, reclaiming at least min_free slots. The headroom covers a
        # worst-case single-frame insert burst (the keypoint budget), and
        # min_free clears the high-water mark with slack so one pass does
        # not leave the map above it.
        cap = cfg.map.capacity
        headroom = max(cap // 10, min(cap // 2, cfg.frontend.max_keypoints))
        self._maint_high_water = cap - headroom
        self._maint_min_free = max(cap // 8, headroom + max(cap // 16, 1))
        self.dropped_inserts_total = 0
        self.maintenance_runs = 0
        # on a card: process's captured step (with a mesh, one whose
        # collectives can be captured), process_chunk's captured frame
        # bodies by render_fn, the window solves' graphs by _solve_robust's
        # key
        self.step_graph = (
            scan_driver.step_graph(cfg, mesh=mesh, map_axis=self._map_axis)
            if self.device.type == "cuda"
            and (mesh is None or capturable(mesh)) else None)
        self.chunk_graphs: Dict = {}
        self.ba_graphs: Dict = {}

    # ------------------------------------------------------------------
    def process(self, img) -> Dict:
        """Feed one grayscale frame (H, W) float32 in [0, 1] (numpy or a
        tensor; a tensor already on the system's device is not copied).

        On a card the step is ``step_graph``'s replay (with a mesh too,
        unless its collectives cannot be captured): captured at the
        bootstrap frame (or, for a system restored by
        ``utils.checkpoint.load_state``, at its first tracked frame), whose
        info then holds the warm-up and capture's seconds as
        ``capture_s``."""
        t0 = time.perf_counter()
        m = self.metrics
        m.begin()
        with m.span("upload"):
            img = torch.as_tensor(img, dtype=torch.float32,
                                  device=self.device)
        g = self.step_graph
        if self.state is None:
            state = tracker.bootstrap(img, self.cfg, self.device,
                                      seed=self._seed, rng=self._rng)
            self.state = state.replace(map=self._local(state.map))
            self.trajectory.append(np.eye(4, dtype=np.float32))
            info = {"kind": "frame", "frame": 0, "bootstrap": True}
            if g is not None:
                # the warm-up's first uploads and the capture's syncs fall
                # in this frame, not in the first tracked one
                g.capture(self.state, None, img)
                info["capture_s"] = g.capture_s
            info.update(m.traced())
            info["wall_s"] = time.perf_counter() - t0
            m.log(**info)
            self.frame_idx = 1
            return info

        fresh = g is not None and g.graph is None
        with m.span("step"):
            self.state, out, row = scan_driver.track_frame(
                self.state, img, self.cfg, g, mesh=self.mesh,
                map_axis=self._map_axis)
        self.last_output = out
        # one device->host transfer: the pose and every counter
        sc = scan_driver.ChunkScalars.unpack(m.fetch(row)[None])
        # the fetch waited for the replay, so its stage events are done
        device_ms = g.stage_ms() if g is not None and g.span else None
        self.trajectory.append(sc.pose[0])
        counts = {k: int(getattr(sc, k)[0]) for k in _counters(self.cfg)}
        success = bool(sc.success[0])

        inlier_ratio = counts["num_inliers"] / max(counts["num_matches"], 1.0)
        is_kf = (
            self.frame_idx % self.cfg.pipeline.keyframe_every == 0
            or inlier_ratio < self.cfg.pipeline.keyframe_min_inlier_ratio
        )
        ran_ba = False
        if is_kf and success:
            with m.span("keyframe"):
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
                with m.span("structure"):
                    self._refine_structure()
            if (self.enable_ba and self._kf_count >= 3
                    and self._kf_count % self.cfg.pipeline.local_ba_every
                    == 0):
                ran_ba = True
                self._run_window_ba()

        self.dropped_inserts_total += counts["num_dropped_inserts"]
        ran_maintenance = False
        if counts["map_size"] >= self._maint_high_water:
            with m.span("maintenance"):
                m2, pid2, obs2 = scan_driver._maintenance(
                    self.whole_map(), self.state.prev_map_id,
                    self.kf_store.obs_pid, self._maint_min_free)
                self.state = self.state.replace(map=self._local(m2),
                                                prev_map_id=pid2)
                self.kf_store = self.kf_store.replace(
                    obs_pid=obs2,
                    obs_mask=self.kf_store.obs_mask & (obs2 >= 0))
                size_after = int(m.fetch(m2.size))
            self.maintenance_runs += 1
            ran_maintenance = True
            m.log(kind="map_maintenance", frame=self.frame_idx,
                  size_before=counts["map_size"], size_after=size_after)

        info = {"kind": "frame", "frame": self.frame_idx, **counts,
                "scale": float(sc.scale[0]), "success": success,
                "keyframe": bool(is_kf), "ran_ba": ran_ba,
                "ran_maintenance": ran_maintenance}
        if fresh:
            info["capture_s"] = g.capture_s
        if device_ms is not None:
            info["device_ms"] = device_ms
        info.update(m.traced())
        info["wall_s"] = time.perf_counter() - t0
        m.log(**info)
        self.frame_idx += 1
        return info

    def process_chunk(self, inputs, render_fn=None) -> Dict:
        """Feed T frames through the chunked driver (``scan_driver``):
        tracking, the keyframe decisions and ring inserts, and map
        maintenance run on the device; per-frame scalars come back to the
        host in one transfer per chunk. On CUDA the frame body is one
        captured graph, replayed once per frame.

        ``inputs``: (T, H, W) stacked frames, or with ``render_fn`` the
        (T, ...) renderer inputs (e.g. (T, 4, 4) poses for
        ``datasets.synthetic_device.render_frame_device``); numpy or a
        tensor (one upload per chunk unless already on the device).

        Window BA fires at chunk boundaries; with the chunk length aligned
        to keyframe_every * local_ba_every its events land on the frames
        the per-frame driver picks. Structure refinement
        (``structure_every``) does not run here, as in the reference, nor
        does the sharded map (``mesh``).

        Logs a ``kind: "chunk"`` record of what it returns, with the
        chunk's ``spans`` (a root ``process_chunk`` span) and ``syncs``.
        """
        if self.mesh is not None:
            raise ValueError("process_chunk: single-device map only")
        self.metrics.begin()
        with self.metrics.span("process_chunk"):
            info = self._chunk(inputs, render_fn)
        info.update(self.metrics.traced())
        self.metrics.log(kind="chunk", **info)
        return info

    def _chunk(self, inputs, render_fn) -> Dict:
        """``process_chunk``'s work: what it returns, without the spans."""
        t0 = time.perf_counter()
        if not isinstance(inputs, torch.Tensor):
            inputs = np.asarray(inputs, np.float32)
        inputs = torch.as_tensor(inputs, dtype=torch.float32,
                                 device=self.device)
        if self.state is None:
            first = render_fn(inputs[0]) if render_fn is not None \
                else inputs[0]
            self.state = tracker.bootstrap(first, self.cfg, self.device,
                                           seed=self._seed, rng=self._rng)
            self.trajectory.append(np.eye(4, dtype=np.float32))
            self.metrics.log(kind="frame", frame=0, bootstrap=True,
                             wall_s=time.perf_counter() - t0)
            self.frame_idx = 1
            inputs = inputs[1:]
            if inputs.shape[0] == 0:
                return {"frames": 1}

        graph = None
        if self.device.type == "cuda":
            graph = self.chunk_graphs.get(render_fn)
            if graph is None:
                graph = self.chunk_graphs[render_fn] = scan_driver.frame_graph(
                    self.cfg, self._maint_high_water, self._maint_min_free,
                    render_fn)
        fresh = graph is not None and graph.graph is None
        t1 = time.perf_counter()
        self.state, self.kf_store, rows = scan_driver.run_chunk(
            self.state, self.kf_store, inputs, self.cfg,
            self._maint_high_water, self._maint_min_free,
            render_fn=render_fn, graph=graph)
        capture_s = graph.capture_s if fresh else 0.0
        # one transfer
        sc = scan_driver.ChunkScalars.unpack(self.metrics.fetch(rows))
        # tracking time: the frames' steps through the rows' arrival on
        # the host (the fetch synchronizes), without a capture
        track_s = time.perf_counter() - t1 - capture_s
        T = sc.pose.shape[0]
        for i in range(T):
            self.trajectory.append(sc.pose[i])
            self.metrics.log(
                kind="frame", frame=self.frame_idx,
                **{k: int(getattr(sc, k)[i]) for k in _counters(self.cfg)},
                scale=float(sc.scale[i]), success=bool(sc.success[i]),
                keyframe=bool(sc.is_keyframe[i]), ran_ba=False,
                ran_maintenance=bool(sc.ran_maintenance[i]))
            self.frame_idx += 1
        self.dropped_inserts_total += int(sc.num_dropped_inserts.sum())
        self.maintenance_runs += int(sc.ran_maintenance.sum())
        kf_before = self._kf_count
        self._kf_count += int(sc.is_keyframe.sum())
        every = self.cfg.pipeline.local_ba_every
        ran_ba = False
        if (self.enable_ba and self._kf_count >= 3
                and self._kf_count // every > max(kf_before, 2) // every):
            ran_ba = True
            self._run_window_ba()
        return {"frames": T, "ran_ba": ran_ba, "track_s": track_s,
                "capture_s": capture_s, "wall_s": time.perf_counter() - t0}

    # ------------------------------------------------------------------
    def whole_map(self):
        """The whole map: ``state.map`` itself, or with a mesh every rank's
        block gathered (one ``all_gather`` per field)."""
        m = self.state.map
        if self.mesh is None:
            return m
        return sharded_map.gather_map_state(self.mesh, self._map_axis, m)

    def _local(self, m):
        """This rank's part of a whole map: ``m`` itself without a mesh."""
        if self.mesh is None:
            return m
        return sharded_map.shard_map_state(self.mesh, self._map_axis, m)

    # ------------------------------------------------------------------
    @staticmethod
    def _pin_window_gauge(wp, solved, fetch=_np):
        """Divide out the scale factor window BA applied to the free
        cameras: free-camera centers and the landmarks free cameras observe
        are rescaled about the newest anchored camera's center, unless
        >= 30 anchored-camera observations of non-provisional bridging
        landmarks show the scale direction is observed, or the factor is
        within 2% of 1. Rotations are untouched. ``fetch`` copies a tensor
        to the host (``MetricsLogger.fetch``, which counts it). Returns
        (solved, s)."""
        valid = fetch(wp.win_valid)
        fixed = fetch(wp.problem.cam_fixed)
        free = valid & ~fixed
        if free.sum() == 0 or (valid & fixed).sum() == 0:
            return solved, 1.0
        obs_cam = fetch(wp.problem.obs_cam)
        obs_mask = fetch(wp.problem.obs_mask)
        pmask = fetch(wp.problem.point_mask)
        obs_fixed = fixed[obs_cam] & obs_mask
        obs_free = (~fixed[obs_cam]) & obs_mask
        bridging = obs_fixed.any(axis=1) & obs_free.any(axis=1) & pmask
        solid = bridging & ~fetch(wp.sel_prov)
        if int(obs_fixed[solid].sum()) >= 30:
            return solved, 1.0
        T_cw_new = fetch(solved.T_cw)
        C_old = _centers(fetch(wp.problem.T_cw))
        C_new = _centers(T_cw_new)
        # scale factor = median baseline ratio over consecutive valid pairs
        # whose later camera is free
        idx = np.where(valid)[0]
        ratios = []
        for a, b in zip(idx[:-1], idx[1:]):
            if not free[b]:
                continue
            d_old = np.linalg.norm(C_old[b] - C_old[a])
            d_new = np.linalg.norm(C_new[b] - C_new[a])
            if d_old > 1e-6 and d_new > 1e-6:
                ratios.append(d_new / d_old)
        if not ratios:
            return solved, 1.0
        s = float(np.median(ratios))
        if not np.isfinite(s) or not (0.2 < s < 5.0) or abs(s - 1.0) < 0.02:
            return solved, s
        # pivot at the newest anchored valid camera (BA cannot move it)
        pivot = C_new[np.where(valid & fixed)[0][-1]]
        C_fix = pivot[None] + (C_new - pivot[None]) / s
        t_fix = -np.einsum("wij,wj->wi", T_cw_new[:, :3, :3], C_fix)
        T_out = T_cw_new.copy()
        T_out[free, :3, 3] = t_fix[free]
        # rescale only landmarks observed by free cameras: anchored-only
        # ones were solved against unmoved poses
        X = fetch(solved.points)
        pt_free = obs_free.any(axis=1) & pmask
        X_fix = np.where(pt_free[:, None],
                         pivot[None] + (X - pivot[None]) / s, X)
        back = lambda a, like: torch.as_tensor(
            np.asarray(a, np.float32)).to(like.device)
        return solved.replace(T_cw=back(T_out, solved.T_cw),
                              points=back(X_fix, solved.points)), s

    @staticmethod
    def _window_starved(wp) -> tuple:
        """Observation-starvation guard: fewer than 8 observations made by
        free cameras per free camera leaves the window (near-)unconstrained.
        Returns (starved, n_obs_free, n_free)."""
        fixed = _np(wp.problem.cam_fixed)
        obs_free_cam = ~fixed[_np(wp.problem.obs_cam)]
        n_obs = int((_np(wp.problem.obs_mask) & obs_free_cam
                     & _np(wp.problem.point_mask)[:, None]).sum())
        n_free = int((_np(wp.win_valid) & ~fixed).sum())
        return n_obs < 8 * max(n_free, 1), n_obs, n_free

    @staticmethod
    def _ba_event_accepted(wp, solved, fetch=_np) -> tuple:
        """Trust region on the whole (re-gauged) BA outcome: accept when the
        largest camera-center move lies between 8% (the correction
        deadband) and 50% of the median inter-keyframe baseline; ``fetch``
        as ``_pin_window_gauge`` takes it. Returns (accepted, max_move,
        median_baseline)."""
        C_old = _centers(fetch(wp.problem.T_cw))
        C_new = _centers(fetch(solved.T_cw))
        valid = fetch(wp.win_valid)
        move = np.linalg.norm(C_new - C_old, axis=1)[valid]
        steps = np.linalg.norm(np.diff(C_old[valid], axis=0), axis=1)
        baseline = float(np.median(steps)) if len(steps) else 1.0
        max_move = float(move.max()) if len(move) else 0.0
        return (max(0.08 * baseline, 1e-3) <= max_move
                <= max(0.5 * baseline, 1e-3)), max_move, baseline

    # ------------------------------------------------------------------
    def _solve_robust(self, problem: ba.BAProblem, ba_cfg, reject_px: float,
                      rounds: int):
        """``ba.solve_robust`` of a window problem. On a card the replay of
        a ``utils.jit.Graph`` cached in the system's own ``ba_graphs`` (a
        ``utils.jit`` cache, so its counts are this system's) by what
        ``jax.jit`` keys the reference's solve on: the config,
        ``reject_px``, ``rounds`` and each input's shape, dtype and
        device. The window's shapes come from the config, so one graph
        serves every event of a run. On the CPU, the eager solve."""
        if self.device.type != "cuda":
            return ba.solve_robust(problem, self._K, ba_cfg,
                                   reject_px=reject_px, rounds=rounds)
        return jit.call(ba._robust_impl, (problem, self._K),
                        dict(cfg=ba_cfg, reject_px=reject_px, rounds=rounds),
                        self.ba_graphs)

    # ------------------------------------------------------------------
    def _refine_structure(self):
        """Structure-only window refinement (``BAConfig.structure_every``):
        the sliding-window problem with every camera fixed, so the solve is
        batched multi-view triangulation; provisional landmarks that earn
        the ray span are written back and promoted. Poses are untouched."""
        cfg = self.cfg
        ba_cfg = dataclasses.replace(cfg.ba, iterations=6)
        whole = self.whole_map()
        wp = keyframes.build_window_problem(
            self.kf_store, whole, cfg.replace(ba=ba_cfg),
            free_tail=0, prov_min_obs=2)
        ev = self._timing_events()
        _record(ev, 0)
        solved, stats = self._solve_robust(wp.problem, ba_cfg, reject_px=3.0,
                                           rounds=2)
        _record(ev, 1)
        new_map, n_promoted = keyframes.apply_structure_result(
            whole, wp, solved,
            tracker._rad(0.5 * cfg.triangulation.promote_parallax_deg))
        self.state = self.state.replace(map=self._local(new_map))
        init, fin, n = self.metrics.fetch(torch.stack([
            stats.initial_cost.double(), stats.final_cost.double(),
            n_promoted.double()])).tolist()
        self.metrics.log(kind="structure_refine", frame=self.frame_idx,
                         initial_cost=init, final_cost=fin,
                         promoted=int(n), **_solve_ms(ev))

    # ------------------------------------------------------------------
    def _run_window_ba(self):
        m = self.metrics
        # prov_min_obs=99: provisional landmarks stay out of the
        # pose-moving solve (estimating them is _refine_structure's job)
        whole = self.whole_map()
        with m.span("ba.build"):
            wp = keyframes.build_window_problem(
                self.kf_store, whole, self.cfg,
                free_tail=self.cfg.ba.free_cams, prov_min_obs=99)
        with m.span("ba.gates"):
            # all pre-solve gate statistics in one transfer
            n_obs, n_free, deep_obs, solid_obs = m.fetch(torch.stack(
                _window_gate_stats(wp.problem, wp.sel_prov))).tolist()
            # starvation guard (see _window_starved)
            starved = n_obs < 8 * max(n_free, 1)
            # exploration gate: a pose-moving solve needs deep revisit
            # evidence
            shallow = deep_obs < 120
        if starved:
            m.log(kind="ba", frame=self.frame_idx, skipped="starved",
                  n_obs=n_obs, n_free=n_free, ba_result_accepted=False)
            return
        if shallow:
            m.log(kind="ba", frame=self.frame_idx, skipped="shallow",
                  deep_obs=deep_obs, ba_result_accepted=False)
            return
        ev = self._timing_events()
        with m.span("ba.solve"):
            _record(ev, 0)
            solved, stats = self._solve_robust(wp.problem, self.cfg.ba,
                                               reject_px=5.0, rounds=2)
            _record(ev, 1)
        with m.span("ba.guards"):
            solved, gauge_s = self._pin_window_gauge(wp, solved, m.fetch)
            ba_accepted, max_move, baseline = self._ba_event_accepted(
                wp, solved, m.fetch)
        s_corr = 1.0
        if ba_accepted:
            with m.span("ba.apply"):
                self.kf_store, new_map, T_corr = \
                    keyframes.apply_window_result(self.kf_store, whole, wp,
                                                  solved)
                # re-gauge the motion model from the newest keyframe gap,
                # only where the window's scale direction is observed
                idx = np.where(m.fetch(wp.win_valid))[0]
                if (self.cfg.ba.rescale_motion_model and solid_obs >= 30
                        and len(idx) >= 2):
                    C_old = _centers(m.fetch(wp.problem.T_cw))
                    C_new = _centers(m.fetch(solved.T_cw))
                    a, b = idx[-2], idx[-1]
                    g_old = float(np.linalg.norm(C_old[b] - C_old[a]))
                    g_new = float(np.linalg.norm(C_new[b] - C_new[a]))
                    if g_old > 1e-6 and g_new > 1e-6:
                        s_corr = float(np.clip(g_new / g_old, 0.5, 2.0))
                vel = self.state.vel.clone()
                vel[:3, 3] *= s_corr
                self.state = self.state.replace(
                    map=self._local(new_map), pose=T_corr @ self.state.pose,
                    vel=vel,
                    scale=(self.state.scale.double() * s_corr).float())
        self.last_ba_stats = stats
        init, fin, n_acc, d_pts, d_obs, evicted = m.fetch(torch.stack([
            stats.initial_cost.double(), stats.final_cost.double(),
            stats.accepted.sum().double(), wp.n_dropped_points.double(),
            wp.n_dropped_obs.double(),
            wp.n_evicted_keyframes.double()])).tolist()
        m.log(kind="ba", frame=self.frame_idx, initial_cost=init,
              final_cost=fin, accepted=int(n_acc),
              ba_result_accepted=ba_accepted, max_cam_move=max_move,
              median_baseline=baseline, gauge_s=gauge_s, scale_corr=s_corr,
              dropped_points=int(d_pts), dropped_obs=int(d_obs),
              evicted_keyframes=int(evicted), **_solve_ms(ev))

    def _timing_events(self):
        """Two timing CUDA events on a card (``_record`` puts them on the
        current stream, the graph stream), None elsewhere."""
        if self.device.type != "cuda":
            return None
        return [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    # ------------------------------------------------------------------
    def run_global_ba(self, mesh=None, axis_name: str = "map",
                      iterations: Optional[int] = None,
                      reject_px: float = 2.0, huber_delta: float = 1.5):
        """Global BA over every retained keyframe, tighter than window BA
        (reject 2 px, Huber 1.5). The problem is sized on the host from the
        keyframe store's observation graph (rounded up to buckets), so a
        full run optimizes with zero truncation; the Schur assembly is
        one-hot up to ``onehot_max_cams`` cameras and scatter beyond.

        With ``mesh``, as in the reference, the rejection rounds run on
        one device (every rank, replicated), then the landmark-sharded
        solve over ``axis_name`` (``parallel.sharded_ba``).

        Its ``kind: "global_ba"`` record holds a root ``global_ba`` span
        and the syncs."""
        self.metrics.begin()
        with self.metrics.span("global_ba"):
            stats, rec = self._global_ba(mesh, axis_name, iterations,
                                         reject_px, huber_delta)
        self.metrics.log(kind="global_ba", **rec, **self.metrics.traced())
        return stats

    def _global_ba(self, mesh, axis_name, iterations, reject_px,
                   huber_delta):
        """``run_global_ba``'s work: (stats, its record's fields)."""
        cfg = self.cfg
        fetch = self.metrics.fetch
        pid = fetch(self.kf_store.obs_pid)
        msk = fetch(self.kf_store.obs_mask) \
            & (fetch(self.kf_store.kf_order) >= 0)[:, None]
        live = pid[msk & (pid >= 0)]
        if live.size:
            n_unique = int(np.unique(live).size)
            max_obs = int(np.bincount(live).max())
        else:
            n_unique, max_obs = 1, 2
        bucket = lambda n, q: int(-(-max(n, 1) // q) * q)
        P = min(bucket(n_unique, 1024), int(self.cfg.map.capacity))
        Kslots = bucket(max_obs, 8)
        ba_cfg = dataclasses.replace(
            cfg.ba, iterations=iterations or cfg.ba.iterations,
            huber_delta=huber_delta, max_obs_per_point=Kslots)
        whole = self.whole_map()
        wp = keyframes.build_window_problem(
            self.kf_store, whole, cfg.replace(ba=ba_cfg),
            window=self.kf_store.ring_size, max_points=P)
        # eager: once a run, at a shape that depends on the run, so a
        # captured graph would never be replayed
        with jit.disable_jit():
            if mesh is not None:
                from ..parallel import sharded_ba
                p, _ = ba.solve_robust(wp.problem, self._K, ba_cfg,
                                       reject_px=reject_px, rounds=2)
                solved, stats = sharded_ba.solve_sharded(
                    mesh, axis_name, p, self._K, ba_cfg)
            else:
                solved, stats = ba.solve_robust(wp.problem, self._K, ba_cfg,
                                                reject_px=reject_px,
                                                rounds=3)
        self.kf_store, new_map, T_corr = keyframes.apply_window_result(
            self.kf_store, whole, wp, solved)
        self.state = self.state.replace(map=self._local(new_map),
                                        pose=T_corr @ self.state.pose)
        self.last_ba_stats = stats
        d_pts, d_obs, evicted = fetch(torch.stack([
            wp.n_dropped_points, wp.n_dropped_obs,
            wp.n_evicted_keyframes.to(torch.int32)])).tolist()
        self.last_global_ba_coverage = {
            "max_points": P, "obs_slots": Kslots,
            "unique_landmarks": n_unique, "dropped_points": d_pts,
            "dropped_obs": d_obs, "evicted_keyframes": evicted}
        init, fin = fetch(torch.stack([stats.initial_cost.double(),
                                       stats.final_cost.double()])).tolist()
        return stats, dict(initial_cost=init, final_cost=fin,
                           **self.last_global_ba_coverage)

    # ------------------------------------------------------------------
    def poses(self) -> np.ndarray:
        """(F, 4, 4) per-frame T_wc trajectory (odometry output)."""
        return np.stack(self.trajectory)

    def keyframe_poses(self) -> np.ndarray:
        """(Nkf, 4, 4) optimized keyframe poses, ordered by keyframe
        number."""
        order = _np(self.kf_store.kf_order)
        sel = order >= 0
        idx = np.argsort(order[sel])
        return _np(self.kf_store.poses)[sel][idx]

    def snapshot(self) -> Dict[str, np.ndarray]:
        """Immutable map/trajectory snapshot (host numpy) for
        visualization/export."""
        m = self.whole_map()
        size = int(m.size)
        alive = _np(m.alive)[:size]
        return {
            "points": _np(m.xyz)[:size][alive],
            "colors": _np(m.color)[:size][alive],
            "poses": self.poses(),
            "keyframe_poses": self.keyframe_poses(),
        }
