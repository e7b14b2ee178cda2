"""Multi-process group set-up.

Port of ``vslam_tpu/parallel/multihost.py``. Each rank runs this same
program; ``initialize`` joins the process group from torchrun's standard
environment (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``), or from explicit arguments, after which ``global_mesh``
spans every rank of every host:

    torchrun --nproc-per-node N -m vslam_tpu_torch.cli run --mesh N ...

A single process (``WORLD_SIZE`` unset or 1) joins nothing. ``spawn``
starts the ranks of one host without torchrun. ``shutdown`` leaves the
group, the CUDA graphs that captured its collectives freed first.
"""
from __future__ import annotations

import datetime
import os
import tempfile
import time
from typing import List, Optional

import torch
import torch.distributed as dist

from ..utils import jit
from . import mesh as mesh_mod


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               local_rank: Optional[int] = None,
               device_type: Optional[str] = None,
               backend: Optional[str] = None,
               timeout: datetime.timedelta = mesh_mod.TIMEOUT) -> bool:
    """Join the process group if one is configured; returns True if
    distributed mode is active.

    Arguments left out come from the environment (``init_method``
    ``env://`` reads ``MASTER_ADDR`` / ``MASTER_PORT``). On ``cuda`` (the
    default device type) the rank's device is ``LOCAL_RANK`` and the
    backend NCCL; on ``cpu`` gloo.
    """
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if world_size <= 1:
        return False
    if rank is None:
        rank = int(os.environ["RANK"])
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
    device_type = device_type or "cuda"
    if device_type == "cuda":
        torch.cuda.set_device(local_rank)
    dist.init_process_group(backend or mesh_mod._BACKENDS[device_type],
                            init_method=init_method or "env://",
                            world_size=world_size, rank=rank,
                            timeout=timeout)
    return True


def global_mesh(axis_name: str, device_type: Optional[str] = None,
                backend: Optional[str] = None):
    """1-D mesh over every rank of the process group; a single process
    (no group joined) gets a one-rank mesh of its own."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    return mesh_mod.make_mesh(axis_name, n, device_type=device_type,
                              backend=backend)


def shutdown() -> None:
    """Leave the process group, if one is joined. Every live CUDA graph
    that captured a mesh's collectives is freed first
    (``mesh.free_captured``), whoever still holds it, because NCCL's
    ``destroy_process_group`` waits for them: a rank whose program raised
    with a captured system in its traceback would hang here instead of
    exiting with its error. ``utils.jit``'s cached graphs that hold a
    mesh go first (``jit.holds_mesh``), so a later direct call captures
    anew instead of replaying a freed graph. Call it in a ``finally``."""
    jit.clear_cache(jit.holds_mesh)
    mesh_mod.free_captured()
    if dist.is_initialized():
        dist.destroy_process_group()


def spawn(fn, nprocs: int, args=(), timeout: Optional[float] = None
          ) -> List[int]:
    """Run ``fn(rank, init_method, *args)`` in ``nprocs`` spawned processes;
    ``init_method`` names a FileStore in a temporary directory, for
    ``initialize``. A rank that fails, or ``timeout`` seconds running out,
    stops every rank (the others would wait in a collective). Returns the
    exit codes."""
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as d:
        init = f"file://{os.path.join(d, 'store')}"
        procs = [ctx.Process(target=fn, args=(r, init, *args))
                 for r in range(nprocs)]
        for p in procs:
            p.start()
        deadline = None if timeout is None else time.monotonic() + timeout
        while (any(p.is_alive() for p in procs)
               and all(p.exitcode in (None, 0) for p in procs)
               and (deadline is None or time.monotonic() < deadline)):
            for p in procs:
                p.join(timeout=1.0)
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    return [p.exitcode for p in procs]
