"""Device mesh construction and the collectives the sharded modules use.

Port of ``vslam_tpu/parallel/mesh.py``. JAX runs one controller over a
``Mesh`` and ``shard_map`` bodies issue ``pmin`` / ``psum`` /
``all_gather``; here every rank is a process running the same program under
``torch.distributed`` (SPMD), and the collectives are explicit calls on the
mesh's process group, made where the reference makes them. The mesh is a
1-D ``torch.distributed.device_mesh.DeviceMesh`` with one named axis, the
counterpart of a named 1-D ``jax.sharding.Mesh``.

Layout of a sharded axis: contiguous blocks, rank ``i`` owns rows
``[i * n / D, (i + 1) * n / D)``.

Backends: NCCL for ``cuda`` (one GPU per rank; every collective runs on the
device, enqueued on the stream without a host sync), gloo for ``cpu``.
gloo on CUDA tensors is used only where the caller names it: it supports
``all_reduce`` and ``broadcast`` for them and stages the payload through
the host (a host sync per call). So every collective here is an
``all_reduce``; ``all_gather`` is one over a zero-filled ``(D, ...)``
buffer in which each rank writes its own row, which is exact (x + 0 = x;
only a ``-0.0`` comes back as ``+0.0``).

CUDA graphs: an NCCL collective can be captured in a CUDA graph and
replayed (``capturable``), so a step that runs them is one replay a frame
(``scan_driver.step_graph(mesh=)``, ``multi_sequence``). A gloo collective
cannot: its host staging is a sync, which a capture forbids. NCCL's
teardown waits for every graph that captured its collectives, so such a
graph is noted (``keep_captured``) and ``multihost.shutdown`` frees it
(``free_captured``) before it leaves the group.
"""
from __future__ import annotations

import datetime
import os
import tempfile
import weakref
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


# join and collective timeout of every group this package creates: a rank
# whose control flow diverged fails instead of hanging
TIMEOUT = datetime.timedelta(seconds=300)

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def make_mesh(axis_name: str, num_devices: Optional[int] = None,
              device_type: Optional[str] = None,
              backend: Optional[str] = None) -> DeviceMesh:
    """1-D mesh named ``axis_name`` over the ranks of the default process
    group, whose world size must equal ``num_devices`` (default: all ranks).

    ``device_type`` (default ``cuda``) picks the backend: NCCL for ``cuda``,
    gloo for ``cpu``; ``backend="gloo"`` with ``cuda`` puts CUDA tensors on
    gloo (for checks on one card: NCCL refuses two ranks on one GPU). An
    existing group must have that backend. With no group and
    ``num_devices == 1`` a one-rank group is created here (a FileStore in
    a temporary directory); a larger mesh needs the ranks' group first
    (``multihost.initialize``).
    """
    device_type = device_type or "cuda"
    backend = backend or _BACKENDS[device_type]
    if device_type == "cuda" and backend == "nccl" \
            and not dist.is_nccl_available():
        raise RuntimeError("make_mesh: device_type cuda needs NCCL, which "
                           "this torch build lacks")
    if not dist.is_initialized():
        if num_devices != 1:
            raise RuntimeError(
                f"make_mesh({axis_name!r}, {num_devices}): no process group; "
                "start the ranks under torchrun or multihost.initialize")
        store = dist.FileStore(os.path.join(tempfile.mkdtemp(), "store"), 1)
        dist.init_process_group(backend, store=store, world_size=1, rank=0,
                                timeout=TIMEOUT)
    world = dist.get_world_size()
    if num_devices is not None and num_devices != world:
        raise ValueError(f"make_mesh: {num_devices} devices asked, the "
                         f"process group has {world} ranks")
    if dist.get_backend() != backend:
        raise RuntimeError(f"make_mesh: the process group runs "
                           f"{dist.get_backend()}, {device_type} wants "
                           f"{backend}")
    return init_device_mesh(device_type, (world,),
                            mesh_dim_names=(axis_name,))


def capturable(mesh: DeviceMesh) -> bool:
    """Whether the mesh's collectives can be captured in a CUDA graph:
    those of NCCL can (it enqueues them on the device, no host sync), those
    of gloo cannot. Follows the backend alone."""
    return dist.get_backend(mesh.get_group()) == "nccl"


# every live CUDA graph that captured collectives (``keep_captured``)
_CAPTURED = weakref.WeakSet()


def keep_captured(graph) -> None:
    """Note a CUDA graph that captured a mesh's collectives, for
    ``free_captured``."""
    _CAPTURED.add(graph)


def free_captured() -> int:
    """Free every live graph noted by ``keep_captured``
    (``CUDAGraph.reset``), whoever still holds it: a system, or an
    exception's traceback through a frame that held one. NCCL's
    ``destroy_process_group`` waits until no graph that captured its
    collectives is left (it hung on four H100s), so
    ``multihost.shutdown`` calls this first. Returns how many were
    freed."""
    graphs = list(_CAPTURED)
    for g in graphs:
        g.reset()
    _CAPTURED.clear()
    return len(graphs)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's index along ``axis`` (a host int: no device read)."""
    return mesh.get_local_rank(axis)


def shard_leading(mesh: DeviceMesh, axis: str, x: torch.Tensor):
    """This rank's contiguous block of ``x``'s leading axis (a view), which
    must divide evenly."""
    D = axis_size(mesh, axis)
    n = x.shape[0]
    if n % D:
        raise ValueError(f"leading axis {n} does not split over {D} ranks")
    i = axis_index(mesh, axis)
    return x[i * (n // D):(i + 1) * (n // D)]


def replicated(mesh: DeviceMesh, x):
    """A replicated value is the same tensor on every rank: the identity
    (every rank computes it, as every JAX device holds a P() array). Kept
    for name parity with the reference's ``mesh`` module; nothing here
    needs it."""
    del mesh
    return x


def pad_to_multiple(n: int, m: int) -> int:
    """``n`` rounded up to a multiple of ``m``. Kept for name parity with
    the reference's ``mesh`` module; nothing here needs it."""
    return ((n + m - 1) // m) * m


def _reduce(mesh: DeviceMesh, axis: str, x: torch.Tensor, op):
    """``op`` over the axis into a new tensor. The reduction is in place,
    so it runs on a copy of ``x``: the int32 cast of a bool, else a
    clone (in a CUDA graph one memcpy node a call)."""
    out = x.to(torch.int32) if x.dtype == torch.bool else x.clone()
    dist.all_reduce(out, op=op, group=mesh.get_group(axis))
    return out


def psum(mesh: DeviceMesh, axis: str, x: torch.Tensor) -> torch.Tensor:
    """Sum over the axis (bools are summed as int32)."""
    return _reduce(mesh, axis, x, dist.ReduceOp.SUM)


def pmin(mesh: DeviceMesh, axis: str, x: torch.Tensor) -> torch.Tensor:
    return _reduce(mesh, axis, x, dist.ReduceOp.MIN)


def pmax(mesh: DeviceMesh, axis: str, x: torch.Tensor) -> torch.Tensor:
    return _reduce(mesh, axis, x, dist.ReduceOp.MAX)


def all_gather(mesh: DeviceMesh, axis: str, x: torch.Tensor) -> torch.Tensor:
    """(D, *x.shape): every rank's ``x`` stacked in rank order, as one
    ``all_reduce`` of a zero-filled buffer holding this rank's row (bools
    come back as bools)."""
    D = axis_size(mesh, axis)
    dt = torch.int32 if x.dtype == torch.bool else x.dtype
    buf = torch.zeros((D,) + tuple(x.shape), dtype=dt, device=x.device)
    buf[axis_index(mesh, axis)] = x
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.get_group(axis))
    return buf.to(torch.bool) if x.dtype == torch.bool else buf
