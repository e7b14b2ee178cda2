"""Benchmark, long-run and BA tools of the port: ``bench``, ``bench_ba``,
``endurance_device`` and ``endurance`` (counterparts of the repository's
``bench.py``, ``bench_ba.py`` and ``scripts/endurance*.py``). Each runs
as ``python -m vslam_tpu_torch.tools.<name>`` on ``--device cuda`` by
default and exits 2 when that device is not available; ``--device cpu``
runs it on the CPU.
"""
from __future__ import annotations

import sys
from typing import Optional

import torch


def device_arg(tool: str, name: str) -> Optional[torch.device]:
    """The device ``--device`` names; None, after a message on stderr, when
    it names a CUDA device that is not available (the tool then exits 2:
    it never carries on on the CPU)."""
    dev = torch.device(name)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda" or not torch.cuda.is_available():
        print(f"{tool}: {name} is not an available CUDA device",
              file=sys.stderr)
        return None
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    torch.cuda.set_device(dev)
    return dev
