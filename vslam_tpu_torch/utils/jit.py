"""The port's counterpart of ``jax.jit`` for entry points called repeatedly.

The reference compiles ``tracker.track_step``, ``ba.solve`` and
``ba.solve_robust`` with ``jax.jit``: a direct call runs one compiled
program, cached by its static arguments and its inputs' shapes and
dtypes. Here such a call, on a card, replays a CUDA graph from one cache
per process, keyed the same way (``key``): the static arguments (frozen
configs, ``reject_px``, ``rounds``, a mesh by identity, ``map_axis``) and
each input's shape, dtype and device, and of a ``torch.Generator`` its
device (a Threefry key is a tensor, so a state's RANSAC stream is in the
key by kind). A call copies its inputs into the graph's static buffers,
replays, and returns copies of the outputs, so a result of call k is
unchanged by call k + 1, as a jax array is immutable.

``Graph`` is that replay for a function that draws from no generator
(the BA solves); the step replays a ``pipeline.scan_driver.ChunkGraph``,
which also hands the caller's generator to the graph and back. Both
capture the eager body: a call inside a capture, or inside the eager
warm-up before one, runs eagerly (``disable_jit``), as a jitted function
called inside another is inlined. A capture or replay that fails
raises; nothing falls back to the eager call on a card.

On the CPU, under ``disable_jit`` and inside a capture (``active``) the
entry points run eagerly. ``clear_cache`` drops the cached graphs, as
``jax.clear_caches`` does, and so frees their memory pools (each step
graph's pool peaks at ~432 MiB at full width, PERF.md §5).

The tree helpers (``tensors``, ``tree_map``, ``copy_into``) walk
dataclasses of tensors, lists and tuples of them, as the graphs' inputs
and outputs are.
"""
from __future__ import annotations

import dataclasses
import functools
import time

import torch

from . import profiling
from .profiling import disable_jit  # noqa: F401  (public here)

_CACHE: dict = {}


def active(device) -> bool:
    """Whether an entry point called on ``device`` replays a cached graph:
    on a card, outside ``disable_jit`` and outside a CUDA-graph capture."""
    return (torch.device(device).type == "cuda"
            and not profiling.jit_disabled()
            and not torch.cuda.is_current_stream_capturing())


def clear_cache(where=None) -> None:
    """Drop the cached graphs, or only those whose key ``where(key)`` is
    true of; a later call captures anew."""
    for k in [k for k in _CACHE if where is None or where(k)]:
        del _CACHE[k]


def holds_mesh(k) -> bool:
    """Whether the graph cached at key ``k`` captured a mesh's
    collectives (``track_step(mesh=)``'s: its static ``mesh`` is set).
    ``parallel.multihost.shutdown`` drops these before NCCL's teardown,
    which resets their graphs."""
    return dict(k[1]).get("mesh") is not None


def cache() -> dict:
    """The process's cache, key -> graph (``Graph`` or ``ChunkGraph``;
    each holds ``capture_s`` and ``replays``)."""
    return _CACHE


def fields(obj):
    return [(f.name, getattr(obj, f.name)) for f in dataclasses.fields(obj)]


def _leaves(obj):
    """Every leaf of a dataclass / list / tuple tree, in order."""
    if dataclasses.is_dataclass(obj):
        for _, v in fields(obj):
            yield from _leaves(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _leaves(v)
    else:
        yield obj


def tensors(obj):
    """Every tensor of a tree (none for None)."""
    return (x for x in _leaves(obj) if isinstance(x, torch.Tensor))


def tree_map(fn, obj):
    """``fn`` on every tensor of a tree; anything else, such as a
    generator, kept (None stays None)."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if dataclasses.is_dataclass(obj):
        return type(obj)(**{k: tree_map(fn, v) for k, v in fields(obj)})
    if isinstance(obj, list):
        return [tree_map(fn, v) for v in obj]
    if isinstance(obj, tuple):
        items = [tree_map(fn, v) for v in obj]
        return type(obj)(*items) if hasattr(obj, "_fields") \
            else tuple(items)
    return obj


def copy_into(dst, src):
    """Copy every tensor of ``src`` into the same place of ``dst`` (two
    trees of one structure), one ``torch._foreach_copy_`` a dtype (nothing
    when ``dst`` is None). A same-dtype ``copy_`` on a card is one
    ``cudaMemcpyAsync`` a tensor, which a capture records as one memcpy
    node a tensor; the foreach copy is one kernel a dtype, so a graph's
    write-back of a state takes one node a dtype. Bit for bit the same
    copy."""
    if dst is None:
        return
    groups = {}
    for d, s in zip(tensors(dst), tensors(src), strict=True):
        ds, ss = groups.setdefault(d.dtype, ([], []))
        ds.append(d)
        ss.append(s)
    for ds, ss in groups.values():
        torch._foreach_copy_(ds, ss)


def signature(obj) -> tuple:
    """What a graph of a call depends on in its arguments: each tensor's
    shape, dtype and device, each generator's device, any other leaf
    itself."""
    return tuple(
        (tuple(x.shape), x.dtype, x.device) if isinstance(x, torch.Tensor)
        else ("generator", x.device) if isinstance(x, torch.Generator)
        else x for x in _leaves(obj))


def key(fn, statics: dict, args) -> tuple:
    """The cache key of ``fn(*args, **statics)``: the function, its static
    arguments (hashable: the frozen configs, floats, ints, strings) and
    the signature of its tensor arguments."""
    return (fn, tuple(statics.items()), signature(args))


def lookup(k, build, graphs=None):
    """The graph cached at ``k`` in ``graphs`` (the process's cache when
    None), made by ``build()`` at the first call."""
    graphs = _CACHE if graphs is None else graphs
    g = graphs.get(k)
    if g is None:
        g = graphs[k] = build()
    return g


def call(fn, args: tuple, statics: dict, graphs=None):
    """``fn(*args, **statics)`` as the replay of the ``Graph`` cached at
    its ``key`` (captured at the first call)."""
    g = lookup(key(fn, statics, args),
               lambda: Graph(functools.partial(fn, **statics), args), graphs)
    return g(*args)


class Graph:
    """``fn(*args)`` captured once as a CUDA graph on static copies of
    ``args`` (``utils.profiling.capture``: an eager warm-up, then the
    capture, on the card's graph stream, both under ``disable_jit``). A
    call copies its arguments in, replays, and returns copies of the
    outputs, which the next replay does not overwrite. ``fn`` must read
    nothing back to the host and draw from no generator (the BA solves:
    ``optimizer/ba.py``), so the graph is the whole call. The graph never
    writes its inputs, so an output that is an input buffer holds this
    call's input when it is copied out. ``capture_s``: warm-up and
    capture, host clock."""

    def __init__(self, fn, args: tuple):
        t0 = time.perf_counter()
        self.args = tree_map(torch.clone, args)

        def run():
            self.out = fn(*self.args)
        with torch.cuda.device(next(tensors(args)).device):
            self.graph = profiling.capture(run)
        self.capture_s = time.perf_counter() - t0
        self.replays = 0

    def __call__(self, *args):
        copy_into(self.args, args)
        self.graph.replay()
        self.replays += 1
        return tree_map(torch.clone, self.out)
