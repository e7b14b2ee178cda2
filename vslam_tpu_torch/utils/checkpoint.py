"""Checkpoint / resume for the SLAM state.

Port of ``vslam_tpu/utils/checkpoint.py``, in the reference's format: one
``<path>.npz`` holding every array of the tracker state under ``state/...``
and of the keyframe store under ``kf/...`` (the key names the reference's
``_flatten_with_paths`` builds: field names joined by ``/``), plus the
trajectory, and ``<path>.json`` with ``frame_idx``, ``kf_count`` and the
config. Descriptors are stored as uint32, the reference's type, through the
int32 bit-views of ``interop``, so they are bit-identical either way.

Either package loads the other's checkpoints. ``state/key`` holds two
uint32 words: the reference's PRNG key, or the port generator's initial
seed laid out as ``jax.random.PRNGKey(seed)`` (high word first), which
``interop.from_jax`` reads back, so a seed carries across both ways. A
port checkpoint also
stores the generator's exact state under ``state/key_torch``, which the
reference's ``load_state`` never reads; a reference checkpoint seeds the
port's generator from ``state/key`` (only determinism carries across: the
two frameworks' random streams differ).
"""
from __future__ import annotations

import json

import numpy as np
import torch

from .. import interop
from ..parallel.mesh import psum

_KEY_TORCH = "state/key_torch"


def _paths(path: str):
    stem = path[:-4] if path.endswith(".npz") else path
    return stem + ".npz", stem + ".json"


def _flatten(tree: dict, prefix: str, out: dict) -> dict:
    for k, v in tree.items():
        if isinstance(v, dict):
            _flatten(v, f"{prefix}/{k}", out)
        else:
            out[f"{prefix}/{k}"] = v
    return out


def _nest(npz, prefix: str) -> dict:
    tree: dict = {}
    for name in npz.files:
        if not name.startswith(prefix + "/") or name == _KEY_TORCH:
            continue
        *parents, leaf = name[len(prefix) + 1:].split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = npz[name]
    return tree


def _check_shapes(got, want, path):
    for k, v in want.items():
        if isinstance(v, dict):
            _check_shapes(got[k], v, f"{path}/{k}")
        elif got[k].shape != v.shape:
            raise ValueError(f"checkpoint {path}/{k} has shape "
                             f"{got[k].shape}, the system {v.shape}: build "
                             "the system with the checkpoint's config")


def save_state(path: str, system) -> str:
    """Serialize a ``pipeline.slam.SLAMSystem`` to <path>.npz (+ .json).
    A sharded map is gathered whole, so every rank calls this; rank 0
    writes, and no rank returns before the files are complete (a
    ``load_state`` right after finds them)."""
    whole = system.state.replace(map=system.whole_map())
    if system.mesh is None or system.mesh.get_rank() == 0:
        _write(path, system, whole)
    if system.mesh is not None:
        # rank 0 joins after writing; reading the sum waits for it
        int(psum(system.mesh, system.cfg.mesh.axis_map,
                 torch.zeros((), device=system.device)))
    return path


def _write(path: str, system, whole) -> None:
    npz_path, meta_path = _paths(path)
    payload = _flatten(interop.to_numpy(whole), "state", {})
    payload.update(_flatten(interop.to_numpy(system.kf_store), "kf", {}))
    key = system.state.key
    if isinstance(key, torch.Tensor):       # a Threefry key: its words
        payload["state/key"] = key.cpu().numpy().astype(np.uint32)
    else:
        seed = key.initial_seed()
        payload["state/key"] = np.array([seed >> 32, seed & 0xFFFFFFFF],
                                        np.uint32)
        payload[_KEY_TORCH] = key.get_state().numpy()
    payload["trajectory"] = np.stack(system.trajectory)
    np.savez_compressed(npz_path, **payload)
    meta = {"frame_idx": system.frame_idx, "kf_count": system._kf_count,
            "config": json.loads(system.cfg.to_json())}
    with open(meta_path, "w") as f:
        json.dump(meta, f)


def load_state(path: str, system) -> None:
    """Restore a SLAMSystem saved by either package's ``save_state``. The
    system must be built with the same config (shapes must match)."""
    from ..pipeline import keyframes, tracker

    npz_path, meta_path = _paths(path)
    with open(meta_path) as f:
        meta = json.load(f)
    with np.load(npz_path) as npz:
        state = _nest(npz, "state")
        store = _nest(npz, "kf")
        key_torch = npz[_KEY_TORCH] if _KEY_TORCH in npz.files else None
        trajectory = list(npz["trajectory"])
    skeleton = tracker.init_state(system.cfg, "cpu")
    _check_shapes(state, interop.to_numpy(skeleton), "state")
    _check_shapes(store, interop.to_numpy(system.kf_store), "kf")
    system.state = interop.from_jax(state, tracker.TrackerState,
                                    system.device)
    system.state = system.state.replace(map=system._local(system.state.map))
    if system._rng == "threefry":
        # the saved words are the key (the reference saves the same words)
        system.state = system.state.replace(
            key=torch.from_numpy(state["key"].astype(np.int64))
            .to(system.device))
    elif (key_torch is not None
            and key_torch.size == system.state.key.get_state().numel()):
        # the generator's exact state, where it was saved from a generator
        # of the same kind (a CUDA generator's state is its seed and
        # offset, a CPU generator's its Mersenne Twister; across kinds the
        # seed carries)
        system.state.key.set_state(torch.from_numpy(key_torch))
    system.kf_store = interop.from_jax(store, keyframes.KeyframeStore,
                                       system.device)
    system.trajectory = trajectory
    system.frame_idx = int(meta["frame_idx"])
    system._kf_count = int(meta["kf_count"])
