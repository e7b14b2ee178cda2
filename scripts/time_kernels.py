#!/usr/bin/env python3
"""Time the two CUDA kernels of a checkout with chip_smoke.py's timers.

    python3 scripts/time_kernels.py [--root DIR]

DIR is a checkout of this repository (default: the one holding this
script). Its ``vslam_tpu_torch`` is built and timed, so one command can time
two commits on the same card, in turn. The inputs are chip_smoke.py phase
3-4's: K1 (Hamming matrix) on 3072 x 3072 random descriptors, K2
(search-by-projection) at capacity 131072 holding 51200 and then 120000
points, 3072 keypoints. Each kernel is checked equal to its plain version
and timed two ways, after half a second of launches that brings the card to
its load clocks: single calls between CUDA events, after a spin that hides
the host's enqueue (``ms``), and the mean of back-to-back calls
(``ms_back_to_back``), each over ``REPS`` calls. Prints one JSON line,
with nvidia-smi's name and power limit; exits 1 if a kernel disagrees, 2
without a GPU.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[1]
REPS = 100


def _times(torch, smoke, fn, seconds=0.5):
    """(single-call ms, back-to-back ms) of fn after ``seconds`` of it."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        fn()
        torch.cuda.synchronize()
    return (smoke._time_each_ms(torch, fn, reps=REPS),
            smoke._time_ms(torch, fn, reps=REPS))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE),
                    help="checkout whose kernels are timed")
    root = Path(ap.parse_args().root).resolve()
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import torch
    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device", file=sys.stderr)
        return 2
    from vslam_tpu_torch.config import VSLAMConfig
    from vslam_tpu_torch.mapping import point_map
    from vslam_tpu_torch.ops import associate as k2
    from vslam_tpu_torch.ops import hamming as k1

    if not Path(k1.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {k1.__file__}, not from {root}")
    dev = torch.device("cuda", 0)
    cfg = VSLAMConfig()
    res = {"root": str(root), "smi": smoke._smi()}

    rng = np.random.RandomState(0)
    d1, d2 = (torch.from_numpy(rng.randint(-2**31, 2**31, (3072, 8),
                                           dtype=np.int64)
                               .astype(np.int32)).to(dev) for _ in range(2))
    fn = lambda: k1.hamming_cuda(d1, d2)
    ms = _times(torch, smoke, fn)
    res["hamming_3072x3072"] = dict(
        equal=bool(torch.equal(fn(), k1.hamming_plain(d1, d2))),
        ms=ms[0], ms_back_to_back=ms[1])

    kw = dict(point_map.gates(cfg.matching), block=cfg.map.block_size)
    for seed, n_map in enumerate(smoke.K2_SIZES, start=1):
        args, _ = smoke.k2_inputs(torch, dev, cfg, n_map, seed)
        fn = lambda: k2.associate_cuda(**args, **kw)
        ms = _times(torch, smoke, fn)
        res[f"associate_{n_map}"] = dict(
            equal=bool(torch.equal(fn(), k2.associate_plain(**args, **kw))),
            ms=ms[0], ms_back_to_back=ms[1])
        del args
    print(json.dumps(res))
    return 0 if all(v["equal"] for v in res.values()
                    if isinstance(v, dict)) else 1


if __name__ == "__main__":
    sys.exit(main())
