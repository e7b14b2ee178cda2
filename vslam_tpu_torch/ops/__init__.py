"""The hand-written CUDA kernels (``csrc/``) behind their torch wrappers,
and the races and profiles that time them.

Each wrapper module counts its kernel's launches in ``launches``;
``launch_counts`` reads them all by kernel name (the wrapper's module
name), which is what ``ChunkGraph.captured_launches`` and chip_smoke.py's
launch reports hold.
"""
from __future__ import annotations

import importlib

KERNELS = ("hamming", "associate", "jacobi", "sampson_gn")


def _module(name):
    return importlib.import_module(f"{__name__}.{name}")


def launch_counts() -> dict:
    """{kernel: its launches so far in this process}, every hand kernel."""
    return {k: _module(k).launches for k in KERNELS}


def launches_since(before: dict) -> dict:
    """{kernel: its launches since ``before``, a ``launch_counts()``}."""
    return {k: n - before[k] for k, n in launch_counts().items()}


def reset_launches() -> None:
    """Set every hand kernel's launch counter to 0."""
    for k in KERNELS:
        _module(k).launches = 0
