"""The corridor drive with the map held near capacity.

``make`` is the corridor's (``corridor.make``). ``prepare`` fills the
system's map, once, before its second tracked frame, with distractor
landmarks: the pattern of the program's ``tools/bench.py`` (``distractors``,
``prepopulate``), copied here. They lie in a box |x| < ``extent_m[0]``,
|y| < ``extent_m[1]``, z in ``z_m``, carry random 256-bit descriptors
(which no keypoint's passes the Hamming gate against, so tracking is
unaffected), and are inserted with ``last_seen`` far in the future, so
``cull_stale`` never retires them and LRU eviction takes them last. The
drive's own points then share what is left below the map's high-water
mark, and every frame searches the near-full map.

Parameters (the traffic file): the corridor's, and ``distractors`` (how
many), ``distractor_extent_m`` [x, y], ``distractor_z_m`` [near, far],
``distractor_last_seen`` (the frame index they are inserted with).
"""
from __future__ import annotations

import torch

from .corridor import make  # noqa: F401  (the generator's frames)


def distractors(n: int, extent, z_range, generator, device):
    """``n`` landmarks (n, 3) float32 in the box and their descriptors, the
    uint32 words viewed as int32 (n, 8), drawn from ``generator``."""
    u = torch.rand((n, 3), generator=generator, device=device)
    desc = torch.randint(-2 ** 31, 2 ** 31, (n, 8), generator=generator,
                         device=device, dtype=torch.int32)
    xyz = torch.stack([
        (u[:, 0] * 2 - 1) * extent[0],
        (u[:, 1] * 2 - 1) * extent[1],
        z_range[0] + u[:, 2] * (z_range[1] - z_range[0]),
    ], dim=1)
    return xyz, desc


def prepare(system, p: dict, seed: int, device):
    """Insert ``p["distractors"]`` distractors, drawn from seed ``seed + n``,
    into ``system``'s map through the program's ``insert_points``, with
    ``frame_idx = p["distractor_last_seen"]``."""
    from vslam_tpu_torch.mapping import point_map

    n = p["distractors"]
    gen = torch.Generator(device=device).manual_seed(seed + n)
    xyz, desc = distractors(n, p["distractor_extent_m"], p["distractor_z_m"],
                            gen, device)
    m = point_map.insert_points(
        system.state.map, xyz, torch.zeros_like(xyz), desc,
        torch.ones((n,), dtype=torch.bool, device=device),
        frame_idx=p["distractor_last_seen"])
    system.state = system.state.replace(map=m)
