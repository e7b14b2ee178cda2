"""Chunked frame loop: T tracking steps with the keyframe decision, the
keyframe-ring insert and map maintenance made on the device.

Port of ``vslam_tpu/pipeline/scan_driver.py``. The reference runs the chunk
as one ``lax.scan`` program and branches with ``lax.cond``; here
``frame_body`` is a plain function on tensors that computes both sides of
each branch and selects per field with ``torch.where``, so it has no
host-dependent control flow:

  * the step, ``tracker._step_impl`` with ``default_map_ops``;
  * the keyframe decision ``(frame_idx % keyframe_every == 0) |
    (inliers / max(matches, 1) < min_ratio)`` on the tracker's pre-step
    ``frame_idx`` (the per-frame driver's own frame counter);
  * ``do_insert = is_keyframe & success``, then the ring insert;
  * maintenance (LRU evict + compact + id remap) when the map's insert
    cursor reaches ``high_water``; it is computed on every frame and kept
    only where the trigger fired.

``step_body`` is the step alone (no keyframe, no maintenance), the body
of ``tools.bench``'s carried loop and of ``SLAMSystem.process``, with or
without a mesh (the sharded map, BASELINE config 4); ``carried`` runs it
over a chunk as ``run_chunk`` runs ``frame_body``, ``track_frame`` over
one frame.

On a CPU device ``run_chunk`` is a Python loop over ``frame_body``. On a
CUDA device it is ``ChunkGraph``: the body captured once as a CUDA graph on
static buffers (one copy of the tracker state, one of the keyframe store,
one input slot, one scalars slot) and replayed once per frame, with the
state copied in before the chunk and out after it, so window BA and
``SLAMSystem.process`` may run eagerly between chunks. There is no eager
fallback on the card: a capture or replay that fails raises. A step with
a mesh is captured with its collectives when the mesh's are capturable
(``parallel.mesh.capturable``: NCCL); on a gloo mesh it runs eagerly.

Per frame only scalars leave the body: ``pack`` lays them out as one
float64 row (float64 holds every f32 and every count exactly), with the
counters the step ``utils.profiling.note``s (the carry's, ``NOTED``), and
the caller fetches all rows of a chunk in one transfer. The body's
``TrackOutput`` (the match and keypoint arrays ``cli run --save-frames``
draws) is kept for the chunk's last frame.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import ops
from ..config import VSLAMConfig
from ..core.types import device_constant
from ..mapping import point_map
from ..parallel.mesh import capturable, keep_captured
from ..utils import jit
from ..utils.jit import copy_into as _copy_into
from ..utils.jit import fields as _fields
from ..utils.jit import tensors as _tensors
from ..utils.jit import tree_map as _map
from ..utils.profiling import (graph_nodes, noting, recording_marks,
                               use_graph_stream)
from . import keyframes as kf_mod
from . import tracker


class ChunkScalars(NamedTuple):
    """Per-frame scalar outputs of one chunk (everything the per-frame
    driver logs, minus the per-match annotation arrays)."""
    pose: np.ndarray               # (T, 4, 4)
    num_matches: np.ndarray        # (T,)
    num_inliers: np.ndarray
    num_associated: np.ndarray
    num_tracked_map: np.ndarray
    num_tracked_prov: np.ndarray
    num_pnp_inliers: np.ndarray
    num_refined: np.ndarray
    num_promoted: np.ndarray
    num_new_points: np.ndarray
    num_dropped_inserts: np.ndarray
    map_size: np.ndarray
    map_alive: np.ndarray
    num_carried: np.ndarray        # noted by the carry; 0 without it
    num_keypoints: np.ndarray      # noted by the carry; 0 without it
    scale: np.ndarray
    success: np.ndarray
    is_keyframe: np.ndarray
    ran_maintenance: np.ndarray

    @classmethod
    def unpack(cls, rows: np.ndarray) -> "ChunkScalars":
        """(T, ROW) float64 rows (``pack``'s layout) -> host arrays with
        the reference's types: f32 pose and scale, int counts, bool flags."""
        rows = np.asarray(rows)
        cols = rows[:, 16:].T
        counts = [c.astype(np.int64) for c in cols[:14]]
        return cls(rows[:, :16].reshape(-1, 4, 4).astype(np.float32),
                   *counts, cols[14].astype(np.float32),
                   *(c > 0.5 for c in cols[15:]))


ROW = 16 + len(ChunkScalars._fields) - 1     # pose words + one per scalar
# the counters the step notes (``utils.profiling.note``) rather than outputs
NOTED = ("num_carried", "num_keypoints")


def pack(out: tracker.TrackOutput, is_keyframe, ran_maintenance,
         noted: dict):
    """One frame's ChunkScalars as a (ROW,) float64 vector. ``noted``: the
    float64 counters the step noted; one it did not note reads 0, a cached
    constant, so a step that notes nothing packs its row with the same
    kernels as before the counters."""
    dev = out.pose.device
    zero = device_constant(0.0, torch.float64, dev)
    names = ChunkScalars._fields[1:-2]
    return torch.cat([
        out.pose.reshape(16).to(torch.float64),
        torch.stack([noted.get(k, zero) if k in NOTED
                     else getattr(out, k).reshape(()).to(torch.float64)
                     for k in names]
                    + [is_keyframe.to(torch.float64),
                       ran_maintenance.to(torch.float64)])])


def _maintenance(m, prev_map_id, obs_pid, min_free: int):
    """Evict LRU landmarks until >= min_free slots are reclaimable, compact
    the map, and remap every id holder (tracker + keyframe observations);
    both drivers' maintenance."""
    m = point_map.evict_lru(m, min_free)
    m2, remap = point_map.compact(m)
    return (m2, point_map.remap_ids(prev_map_id, remap),
            point_map.remap_ids(obs_pid, remap))


def _each(state):
    """The tracker states of ``state``: itself, or the batched step's list
    of them."""
    return state if isinstance(state, list) else [state]


def _with_keys(state, keys):
    """``state`` (one tracker state or a list) with each one's RANSAC key
    replaced by the one of ``keys`` in its place (None keeps it)."""
    new = [st if k is None else st.replace(key=k)
           for st, k in zip(_each(state), keys)]
    return new if isinstance(state, list) else new[0]


def _select(cond, a, b):
    """Per tensor field ``torch.where(cond, a, b)`` (0-d ``cond``)."""
    return type(a)(**{
        k: _select(cond, v, getattr(b, k)) if dataclasses.is_dataclass(v)
        else torch.where(cond, v, getattr(b, k))
        if isinstance(v, torch.Tensor) else v
        for k, v in _fields(a)})


def frame_body(st: tracker.TrackerState, sr: kf_mod.KeyframeStore, x,
               cfg: VSLAMConfig, high_water: int, min_free: int,
               render_fn=None):
    """One frame of a chunk. ``x`` is the (H, W) image, or the renderer's
    input when ``render_fn`` is given. Returns (state, store, row, out),
    ``row`` the frame's ``pack``ed scalars, ``out`` its ``TrackOutput``."""
    img = render_fn(x) if render_fn is not None else x
    frame_no = st.frame_idx
    with noting() as noted:
        st2, out = tracker._step_impl(st, img, cfg, tracker.default_map_ops(
            cfg, cfg.camera.width, cfg.camera.height))

    # keyframe decision (the per-frame driver's, on the device): the flag
    # matches that driver's log; insertion additionally requires success
    ratio = out.num_inliers.to(torch.float32) / torch.clamp(
        out.num_matches.to(torch.float32), min=1.0)
    is_kf = ((frame_no % cfg.pipeline.keyframe_every == 0)
             | (ratio < cfg.pipeline.keyframe_min_inlier_ratio))
    do_insert = is_kf & out.success
    sr2 = _select(do_insert, kf_mod.insert_keyframe(
        sr, st2.pose, frame_no, st2.prev.uv, st2.prev_map_id,
        st2.prev.mask), sr)

    # map maintenance at the high-water mark (the per-frame driver's
    # trigger)
    need = st2.map.size >= high_water
    m2, pid2, obs2 = _maintenance(st2.map, st2.prev_map_id, sr2.obs_pid,
                                  min_free)
    st3 = st2.replace(map=_select(need, m2, st2.map),
                      prev_map_id=torch.where(need, pid2, st2.prev_map_id))
    sr3 = sr2.replace(
        obs_pid=torch.where(need, obs2, sr2.obs_pid),
        obs_mask=torch.where(need, sr2.obs_mask & (obs2 >= 0), sr2.obs_mask))
    return st3, sr3, pack(out, do_insert, need, noted), out


def step_body(st: tracker.TrackerState, sr, x, cfg: VSLAMConfig, mesh=None,
              map_axis: str = "map"):
    """One ``track_step`` alone, with no keyframe insert and no
    maintenance (bench.py's scan body; ``mesh`` / ``map_axis`` as
    ``track_step`` takes them, for the sharded ``process``). ``sr``
    passes through (None: no keyframe store). Returns (state, sr, row,
    out), ``row`` in ``pack``'s layout, ``out`` the step's
    ``TrackOutput``."""
    with noting() as noted:
        st, out = tracker.track_step(st, x, cfg, mesh=mesh,
                                     map_axis=map_axis)
    no = torch.zeros_like(out.success)
    return st, sr, pack(out, no, no, noted), out


class ChunkGraph:
    """``body`` captured once as a CUDA graph, replayed per frame.

    ``capture``, or else the first ``run``, warms the body up eagerly
    (constant uploads, the kernels' build and K2's grid query, library
    handles: host work that is illegal inside a capture) with a throwaway
    copy of the RANSAC generator, then captures it on static buffers.
    Inside the capture the new state is written back into the static
    buffers by ``_copy_into``, and the RANSAC generator is registered with
    the graph, so each replay draws what the eager step would draw next.
    Warm-up and capture run under ``utils.jit.disable_jit``: the
    ``tracker.track_step`` a body calls runs its eager body there, which
    the graph records (a direct ``track_step`` on a card replays such a
    graph, ``step_graph``, from ``utils.jit``'s cache).

    ``body(state, store, x) -> (state, store, row, out)`` is ``frame_body``
    or ``step_body`` with its settings bound (``frame_graph``,
    ``step_graph``); one that carries no keyframe store is run with
    ``store=None``. ``state`` may also be a list of tracker states, each
    with a generator of its own (``multi_sequence``'s batched step, which
    returns no row: ``row`` None).

    ``capture`` and ``run`` make the card's
    ``utils.profiling.graph_stream`` the calling thread's current stream
    (``use_graph_stream``: ordered after the work queued on the stream it
    replaces) and leave it current, so the warm-up, the capture, the
    replays and the caller's own work before and after them share one
    stream, whatever stream the caller started on: on the H100 a graph
    whose work changed streams ran ~23% slower (PERF.md §6). The switch
    itself, right before the first replays, could start that mode, so a
    program that drives this module directly calls ``use_graph_stream``
    before its first work on the card, as ``SLAMSystem`` does.

    ``nodes`` holds the graph's nodes by type (``utils.profiling.
    graph_nodes``; the graph keeps its ``cudaGraph_t`` for that): how
    long a replay takes moves with their number (PERF.md §6).

    With ``mesh`` the body's collectives are captured with it (NCCL: the
    graph forks onto NCCL's stream and joins back); the eager warm-up runs
    each of them once first, and so creates the NCCL communicator, which
    PyTorch makes at a group's first collective and a capture cannot.
    Every rank captures the same body and replays it in the same order.
    The graph is noted with ``parallel.mesh.keep_captured``, so that
    ``parallel.multihost.shutdown`` frees it before NCCL's teardown,
    which waits for it.

    Python launch counters count the capture, not the replays:
    ``captured_launches`` holds each kernel's launches in one frame body
    and ``replays`` the frames run, so a run launched each kernel
    ``captured_launches[k] * replays`` times. ``capture_s`` (warm-up and
    capture, host clock) and ``pool_peak_bytes`` (the graph pool's peak
    allocation during capture) are kept for the record.

    With ``span=True`` the graph records a CUDA event (``external``) first
    and last, so ``span_ms`` reads the device time of the latest replay,
    from its first node to its last, without the host's time between
    replays (which a profiler's per-node work inflates); and one at each
    ``utils.profiling.mark`` the body passes (the step's stages), which
    ``stage_ms`` reads. Without ``span`` the graph holds no event node.
    """

    def __init__(self, body, span: bool = False, mesh=None):
        self.body = body
        self.span = span
        self.mesh = mesh
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.captured_launches: dict = {}
        self.nodes: dict = {}
        self.replays = 0
        self.capture_s: Optional[float] = None
        self.pool_peak_bytes: Optional[int] = None
        self.marks: list = []

    def _capture(self, state, store, x):
        # the body's own entry points run eagerly, in the warm-up too
        with jit.disable_jit():
            self._capture_body(state, store, x)

    def _capture_body(self, state, store, x):
        dev = x.device
        t0 = time.perf_counter()
        # a generator advances in place, so the warm-up draws from copies
        # and the graph from generators of its own, registered with it; a
        # Threefry key is a fixed tensor of the state
        self.gens = [torch.Generator(device=dev)
                     if isinstance(st.key, torch.Generator) else None
                     for st in _each(state)]
        scratch = [None if g is None else torch.Generator(device=dev)
                   for g in self.gens]
        for sc, st in zip(scratch, _each(state)):
            if sc is not None:
                sc.set_state(st.key.get_state())
        # also every collective's first run (the NCCL communicator)
        self.body(_with_keys(state, scratch), store, x)
        torch.cuda.synchronize(dev)

        self.state = _with_keys(_map(torch.clone, state), self.gens)
        self.store = _map(torch.clone, store)
        self.slot = torch.empty_like(x)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        if self.mesh is not None:
            keep_captured(graph)
        for g in self.gens:
            if g is not None:
                graph.register_generator_state(g)
        before = ops.launch_counts()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        if self.span:
            self.events = [torch.cuda.Event(enable_timing=True,
                                            external=True) for _ in range(2)]
        with torch.cuda.graph(graph, stream=torch.cuda.current_stream(dev)):
            if self.span:
                self.events[0].record()
            with recording_marks(self.span) as self.marks:
                st, sr, row, out = self.body(self.state, self.store,
                                             self.slot)
            # an output that is an input buffer (the step's uv1 is the
            # state's prev.uv) is copied before the write-back overwrites it
            ins = {t.untyped_storage().data_ptr() for t in (
                *_tensors(self.state), *_tensors(self.store), self.slot)}
            out = tracker.TrackOutput(*(
                t.clone() if t.untyped_storage().data_ptr() in ins else t
                for t in out))
            _copy_into(self.state, st)
            _copy_into(self.store, sr)
            if self.span:
                self.events[1].record()
        torch.cuda.synchronize(dev)
        self.nodes = graph_nodes(graph)
        graph.instantiate()
        self.row, self.out = row, out
        self.pool_peak_bytes = torch.cuda.max_memory_allocated(dev) - base
        self.captured_launches = ops.launches_since(before)
        self.graph = graph
        self.capture_s = time.perf_counter() - t0

    def capture(self, state, store, x):
        """Warm up and capture the body on ``state``, ``store`` and one
        input ``x`` without replaying it (``run``'s first call does this
        when nothing called it before)."""
        with torch.cuda.device(x.device):
            use_graph_stream(x.device)
            self._capture(state, store, x)

    def span_ms(self) -> float:
        """Device ms of the latest replay (``span=True``; waits for it)."""
        self.events[1].synchronize()
        return self.events[0].elapsed_time(self.events[1])

    def stage_ms(self) -> dict:
        """{stage: device ms} of the latest replay (``span=True``; waits
        for it), from the body's ``utils.profiling.mark`` events: a stage
        runs from its mark to the next one, the first from the graph's
        first event, the last to its last event, so the undotted stages
        sum to ``span_ms``. A dotted stage's prefix (``ransac`` of
        ``ransac.fit``) also counts it, so it holds its whole stage."""
        self.events[1].synchronize()
        bounds = ([self.events[0]] + [ev for _, ev in self.marks[1:]]
                  + [self.events[1]])
        out: dict = {}
        for (name, _), a, b in zip(self.marks, bounds, bounds[1:]):
            ms = a.elapsed_time(b)
            parts = name.split(".")
            for i in range(1, len(parts) + 1):
                k = ".".join(parts[:i])
                out[k] = out.get(k, 0.0) + ms
        return out

    def run(self, state, store, frames):
        """Track ``frames`` (T, ...) on the card. Returns (state, store,
        rows, out): new state and store and the last frame's
        ``TrackOutput`` (copies, not the static buffers, so no later replay
        overwrites them) and the (T, ROW) float64 rows, still on the
        device (None for a body that returns no row). The replay loop runs
        with ``set_sync_debug_mode("error")``: a host sync inside it
        raises."""
        dev = frames.device
        with torch.cuda.device(dev):
            use_graph_stream(dev)
            if self.graph is None:
                self._capture(state, store, frames[0])
            elif frames.shape[1:] != self.slot.shape:
                raise ValueError(f"frames {tuple(frames.shape[1:])} do not "
                                 f"fit the captured slot "
                                 f"{tuple(self.slot.shape)}")
            _copy_into(self.state, state)
            _copy_into(self.store, store)
            keys = [st.key for st in _each(state)]
            for g, key in zip(self.gens, keys):
                if g is not None:
                    g.set_state(key.get_state())
            rows = None if self.row is None else torch.empty(
                (frames.shape[0], ROW), dtype=torch.float64, device=dev)
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                for t in range(frames.shape[0]):
                    self.slot.copy_(frames[t])
                    self.graph.replay()
                    if rows is not None:
                        rows[t].copy_(self.row)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
            self.replays += frames.shape[0]
            # each caller's generator advances, as in the eager step
            for g, key in zip(self.gens, keys):
                if g is not None:
                    key.set_state(g.get_state())
            return (_with_keys(_map(torch.clone, self.state), keys),
                    _map(torch.clone, self.store), rows,
                    tracker.TrackOutput(*map(torch.clone, self.out)))


def run_chunk(state: tracker.TrackerState, store: kf_mod.KeyframeStore,
              frames, cfg: VSLAMConfig, high_water: int, min_free: int,
              render_fn=None, graph: Optional[ChunkGraph] = None):
    """Track a chunk of frames.

    Args:
      state / store: tracker state and keyframe ring, on one device.
      frames: (T, H, W) stacked images on that device, or with
        ``render_fn`` the (T, ...) per-frame renderer inputs (e.g. (T, 4, 4)
        poses for ``datasets.synthetic_device.render_frame_device``).
      render_fn: optional callable mapping one row of ``frames`` to an
        (H, W) image on the device.
      high_water / min_free: maintenance trigger and target, as in
        ``SLAMSystem``.
      graph: on CUDA, the ``frame_graph`` to replay (captured on its
        first run); a new one when None. Ignored on the CPU.
    Returns (state, store, rows), ``rows`` (T, ROW) float64 on the device
    (``ChunkScalars.unpack`` of its host copy gives the named fields).
    """
    return _run(_frame_fn(cfg, high_water, min_free, render_fn), state,
                store, frames, graph)[:3]


def carried(state: tracker.TrackerState, frames, cfg: VSLAMConfig,
            graph: Optional[ChunkGraph] = None, mesh=None,
            map_axis: str = "map"):
    """Track ``frames`` (T, H, W) with ``step_body``, bench.py's carried
    loop: ``graph`` (``step_graph``; a new one when None) replayed on
    CUDA, a Python loop on the CPU or with a mesh that cannot be captured.
    Returns (state, rows), ``rows`` (T, ROW) float64 on the device."""
    state, _, rows, _ = _run(_step_fn(cfg, mesh, map_axis), state, None,
                             frames, graph, eager=not _capturable(mesh))
    return state, rows


def track_frame(state: tracker.TrackerState, x, cfg: VSLAMConfig,
                graph: Optional[ChunkGraph] = None, mesh=None,
                map_axis: str = "map"):
    """``step_body`` on one (H, W) image ``x``: ``graph`` (a ``step_graph``
    of the same settings) replayed on CUDA; eager without one (the CPU,
    or a mesh whose collectives cannot be captured). Returns (state, out,
    row): the step's ``TrackOutput`` (after a replay a copy of the graph's
    outputs) and its (ROW,) float64 row on the device."""
    state, _, rows, out = _run(_step_fn(cfg, mesh, map_axis), state, None,
                               x[None], graph, eager=graph is None)
    return state, out, rows[0]


def frame_graph(cfg: VSLAMConfig, high_water: int, min_free: int,
                render_fn=None) -> ChunkGraph:
    """A ``ChunkGraph`` of ``frame_body`` with these settings."""
    return ChunkGraph(_frame_fn(cfg, high_water, min_free, render_fn))


def step_graph(cfg: VSLAMConfig, span: bool = False, mesh=None,
               map_axis: str = "map") -> ChunkGraph:
    """A ``ChunkGraph`` of ``step_body`` (with ``mesh``: the sharded step
    and its collectives, which must be capturable)."""
    if not _capturable(mesh):
        raise ValueError("step_graph: the mesh's collectives cannot be "
                         "captured (parallel.mesh.capturable)")
    return ChunkGraph(_step_fn(cfg, mesh, map_axis), span, mesh)


def _capturable(mesh) -> bool:
    return mesh is None or capturable(mesh)


def _step_fn(cfg, mesh, map_axis):
    return functools.partial(step_body, cfg=cfg, mesh=mesh,
                             map_axis=map_axis)


def _frame_fn(cfg, high_water, min_free, render_fn):
    return functools.partial(frame_body, cfg=cfg, high_water=high_water,
                             min_free=min_free, render_fn=render_fn)


def _run(body, state, store, frames, graph, eager: bool = False):
    """``body`` over ``frames``: ``graph`` (``ChunkGraph(body)`` when None)
    on CUDA, a Python loop on the CPU or with ``eager`` (under
    ``jit.disable_jit``: the step replays no cached graph there either).
    Returns (state, store, rows, the last frame's out)."""
    dev = state.pose.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and not eager:
        return (graph or ChunkGraph(body)).run(state, store, frames)
    rows = []
    with jit.disable_jit():
        for t in range(frames.shape[0]):
            state, store, row, out = body(state, store, frames[t])
            rows.append(row)
    return state, store, torch.stack(rows), out
