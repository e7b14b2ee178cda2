"""Data-parallel multi-sequence tracking: the sequences split over the mesh.

Port of ``vslam_tpu/parallel/multi_sequence.py`` (BASELINE config 5,
concurrent sequences). The reference ``vmap``s the tracker over a leading
sequence axis sharded across the mesh; the hand kernels have no batching
rule, so here each rank steps its own block of the S sequences in a loop,
each sequence with its own generator seeded from ``seeds``. Sequences do
not talk to each other: the only collective gathers the per-frame outputs,
so every rank returns (S, ...) outputs. Cross-sequence global BA runs
separately (``parallel.sharded_ba``).
"""
from __future__ import annotations

import dataclasses
from typing import List

import torch

from ..config import VSLAMConfig
from ..pipeline import tracker
from .mesh import all_gather, axis_index, axis_size


@dataclasses.dataclass
class BatchedState:
    """This rank's tracker states: sequences ``first`` to
    ``first + len(states) - 1`` of ``num_sequences``."""
    states: List[tracker.TrackerState]
    first: int
    num_sequences: int


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
    return BatchedState(
        states=[tracker.bootstrap(imgs[s], cfg, device, seed=seeds[s])
                for s in range(first, first + n)],
        first=first, num_sequences=S)


def batched_track_step(state: BatchedState, imgs, cfg: VSLAMConfig, mesh,
                       axis_name: str):
    """One tracking step for S sequences at once. imgs: (S, H, W). Returns
    (new BatchedState, TrackOutput with (S, ...) leaves, gathered)."""
    steps = [tracker.track_step(st, imgs[state.first + j], cfg)
             for j, st in enumerate(state.states)]
    S = state.num_sequences
    out = tracker.TrackOutput(*(
        all_gather(mesh, axis_name, torch.stack(f)).reshape(
            (S,) + tuple(f[0].shape))
        for f in zip(*(o for _, o in steps))))
    return dataclasses.replace(state, states=[s for s, _ in steps]), out
