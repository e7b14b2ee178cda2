"""State carried across frameworks: reference (numpy) trees <-> port state.

The system has no learned weights; what carries across is state — the map
and the tracker's carried tracks. ``from_jax`` takes a reference state whose
leaves are numpy arrays (``jax.tree_util.tree_map(np.asarray, state)``, or
nested dicts of the same field names) and builds the port's dataclass;
``to_numpy`` goes back to nested dicts of numpy arrays. uint32 descriptor
words cross as int32 bit-views (``ndarray.view``) both ways, so values are
bit-identical; the packed ``(C, 24)`` payload and the flat ``(C*K, 8)``
archive keep the reference layout.
"""
from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

_U32_FIELDS = ("desc", "pend_desc")


def _leaf_to_torch(a, device):
    a = np.array(a)                      # a writable copy; keeps 0-d shape
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(device)


def from_jax(tree, cls, device="cpu"):
    """Build port dataclass ``cls`` from a reference state with numpy leaves.

    ``tree`` is the reference dataclass (numpy leaves) or a dict with the
    same field names. A ``key`` field (the reference's PRNG key) becomes a
    ``torch.Generator`` seeded from the key's words, high word first as
    ``jax.random.PRNGKey(seed)`` lays them out (seed 0 when absent, as in
    ``to_numpy``'s output): the two frameworks' random streams differ by
    construction, so only determinism carries.
    """
    get = tree.get if isinstance(tree, dict) else \
        (lambda k: getattr(tree, k))
    hints = typing.get_type_hints(cls)
    kw = {}
    for f in dataclasses.fields(cls):
        v = get(f.name)
        sub = hints.get(f.name)
        if dataclasses.is_dataclass(sub):
            kw[f.name] = from_jax(v, sub, device)
        elif f.name == "key":
            words = [] if v is None else np.asarray(v).reshape(-1).tolist()
            seed = 0
            for w in words:
                seed = (seed << 32) | int(w)
            kw[f.name] = torch.Generator(device=device).manual_seed(seed)
        else:
            kw[f.name] = _leaf_to_torch(v, device)
    return cls(**kw)


def map_shard(tree, rank: int, num_shards: int, device="cpu"):
    """Block ``rank`` of ``num_shards`` of a reference ``MapState`` (numpy
    leaves or a dict of them): the port's ``MapState`` a rank of a sharded
    map holds (``parallel.sharded_map`` layout)."""
    from .core.types import MapState
    from .parallel.sharded_map import local_block
    return local_block(from_jax(tree, MapState, device), rank, num_shards)


def to_numpy(state):
    """Port dataclass -> nested dict of numpy arrays (descriptors as
    uint32, the reference dtype). Generators are left out."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = to_numpy(v)
        elif isinstance(v, torch.Tensor):
            a = v.detach().cpu().numpy()
            out[f.name] = a.view(np.uint32) if f.name in _U32_FIELDS else a
    return out
