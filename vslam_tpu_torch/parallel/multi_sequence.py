"""Data-parallel multi-sequence tracking: the sequences split over the mesh.

Port of ``vslam_tpu/parallel/multi_sequence.py`` (BASELINE config 5,
concurrent sequences). The reference ``vmap``s the tracker over a leading
sequence axis sharded across the mesh and compiles the batched step as one
program; the hand kernels have no batching rule, so here each rank steps
its own block of the S sequences in a loop, each sequence with its own
generator seeded from ``seeds``. Sequences do not talk to each other: the
only collective gathers the per-frame outputs, so every rank returns
(S, ...) outputs. Cross-sequence global BA runs separately
(``parallel.sharded_ba``).

On a card with a mesh whose collectives can be captured (NCCL,
``mesh.capturable``) the rank's batched step, its sequences' steps and the
gather, is one CUDA graph (a ``scan_driver.ChunkGraph`` over the list of
the rank's states, a generator each), captured at the first step and
replayed at each; on the CPU and on a gloo mesh it runs eagerly, the same
function, whose sequences' ``track_step``s on a card each replay the
process's cached step graph (``utils.jit``; the batched graph's capture
runs them eagerly, as a jitted function inside another is inlined).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional

import torch

from ..config import VSLAMConfig
from ..pipeline import scan_driver, tracker
from .mesh import all_gather, axis_index, axis_size, capturable


def _batched_step(states, store, imgs, cfg: VSLAMConfig, mesh,
                  axis_name: str, num_sequences: int):
    """This rank's sequences' ``track_step``s on their images ``imgs``
    (n, H, W), then the gather; a ``scan_driver.ChunkGraph`` body
    (``store`` passes through, None). Returns (new states, store, None:
    no row, TrackOutput with (S, ...) leaves)."""
    steps = [tracker.track_step(st, imgs[j], cfg)
             for j, st in enumerate(states)]
    out = tracker.TrackOutput(*(
        all_gather(mesh, axis_name, torch.stack(f)).reshape(
            (num_sequences,) + tuple(f[0].shape))
        for f in zip(*(o for _, o in steps))))
    return [s for s, _ in steps], store, None, out


@dataclasses.dataclass
class BatchedState:
    """This rank's tracker states: sequences ``first`` to
    ``first + len(states) - 1`` of ``num_sequences``. ``graph``: the
    batched step's ``scan_driver.ChunkGraph`` on a card with a capturable
    mesh (captured at the first step), else None (eager)."""
    states: List[tracker.TrackerState]
    first: int
    num_sequences: int
    graph: Optional[scan_driver.ChunkGraph] = None


def batched_bootstrap(imgs, cfg: VSLAMConfig, mesh, axis_name: str,
                      seeds=None, device="cuda") -> BatchedState:
    """imgs: (S, H, W), one first frame per sequence (every rank passes all
    S). Bootstraps this rank's S / D sequences; sequence s draws its RANSAC
    samples from a generator seeded with ``seeds[s]`` (default s)."""
    S, D = len(imgs), axis_size(mesh, axis_name)
    if S % D:
        raise ValueError(f"{S} sequences do not split over {D} ranks")
    n = S // D
    first = axis_index(mesh, axis_name) * n
    seeds = list(range(S)) if seeds is None else [int(s) for s in seeds]
    graph = (scan_driver.ChunkGraph(_step_fn(cfg, mesh, axis_name, S),
                                    mesh=mesh)
             if torch.device(device).type == "cuda" and capturable(mesh)
             else None)
    return BatchedState(
        states=[tracker.bootstrap(imgs[s], cfg, device, seed=seeds[s])
                for s in range(first, first + n)],
        first=first, num_sequences=S, graph=graph)


def batched_track_step(state: BatchedState, imgs, cfg: VSLAMConfig, mesh,
                       axis_name: str):
    """One tracking step for S sequences at once. imgs: (S, H, W). Returns
    (new BatchedState, TrackOutput with (S, ...) leaves, gathered): a
    replay of ``state.graph`` where there is one, else eager."""
    S, n = state.num_sequences, len(state.states)
    mine = torch.as_tensor(imgs[state.first:state.first + n],
                           dtype=torch.float32,
                           device=state.states[0].pose.device)
    body = _step_fn(cfg, mesh, axis_name, S)
    g = state.graph
    if g is None:
        new, _, _, out = body(state.states, None, mine)
    else:
        if g.body.keywords != body.keywords:
            raise ValueError("batched_track_step: the state's graph was "
                             "built for another config or mesh")
        new, _, _, out = g.run(state.states, None, mine[None])
    return dataclasses.replace(state, states=new), out


def _step_fn(cfg, mesh, axis_name, num_sequences):
    return functools.partial(_batched_step, cfg=cfg, mesh=mesh,
                             axis_name=axis_name,
                             num_sequences=num_sequences)
