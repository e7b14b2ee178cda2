"""Kernel races on one GPU: each hand kernel against its alternatives.

    python -m vslam_tpu_torch.ops.bench_kernels [--device cuda:0] [--reps N]

Port of ``vslam_tpu/ops/bench_kernels.py``. Races, at the main path's
shapes (the default config):

  * Hamming matrices, 3072 x 3072 random 256-bit descriptors: kernel K1
    (``ops.hamming.hamming_cuda``), the bit-plane GEMM
    ``matching.hamming.hamming_matmul``, the SWAR popcount
    ``hamming_popcount`` and ``torch.cdist(p=0)`` on the {0,1} bit planes
    (unpacked outside the timed window); all must equal K1;
  * search-by-projection at live map sizes 4096 / 51200 / 131072
    (capacity 131072, 3072 keypoints, a quarter of them planted on visible
    points so both tiers find hits): kernel K2 against ``associate_plain``,
    which must agree;
  * 2048 batched 9x9 symmetric eigendecompositions: ``ops.jacobi``'s
    8-sweep Jacobi against ``torch.linalg.eigh`` (eigenvalues compared).

Every time is a CUDA-event time of single calls (``utils.profiling
.event_ms``); Jacobi's also of one replay of it captured as a CUDA graph
(``utils.profiling.graph_ms``). Prints one JSON line with nvidia-smi's name and power limit;
exits 1 if any formulation disagrees, 2 without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..config import VSLAMConfig
from ..core import camera as cam
from ..core.types import empty_map
from ..frontend.descriptors import unpack_bits
from ..mapping import point_map
from ..matching import hamming
from ..utils.profiling import event_ms, graph_ms, nvidia_smi
from . import associate as k2
from . import hamming as k1
from . import jacobi


def random_descriptors(rng, n, device):
    """(n, 8) int32 bit-views of uniformly random 256-bit descriptors."""
    return torch.from_numpy(rng.randint(-2 ** 31, 2 ** 31, (n, 8),
                                        dtype=np.int64).astype(np.int32)
                            ).to(device)


def _cdist_hamming(a, b):
    return torch.cdist(a, b, p=0).to(torch.int32)


def hamming_agreement(d1, d2) -> dict:
    """Whether each alternative formulation equals K1 (on CPU tensors, K1's
    plain version) on these descriptors."""
    want = k1.hamming_cuda(d1, d2)
    planes = [unpack_bits(d).to(torch.float32) for d in (d1, d2)]
    return {
        "hamming_matmul": bool(torch.equal(hamming.hamming_matmul(d1, d2),
                                           want)),
        "hamming_popcount": bool(torch.equal(
            hamming.hamming_popcount(d1, d2), want)),
        "cdist_p0": bool(torch.equal(_cdist_hamming(*planes), want)),
    }


def bench_hamming(device, n1=3072, n2=3072, reps=20) -> dict:
    rng = np.random.RandomState(0)
    d1, d2 = random_descriptors(rng, n1, device), \
        random_descriptors(rng, n2, device)
    equal = hamming_agreement(d1, d2)
    planes = [unpack_bits(d).to(torch.float32) for d in (d1, d2)]
    ms = {
        "k1": event_ms(lambda: k1.hamming_cuda(d1, d2), reps),
        "hamming_matmul": event_ms(lambda: hamming.hamming_matmul(d1, d2),
                                   reps),
        "hamming_popcount": event_ms(
            lambda: hamming.hamming_popcount(d1, d2), max(reps // 4, 1)),
        "cdist_p0": event_ms(lambda: _cdist_hamming(*planes), 3),
    }
    return dict(shape=[n1, n2], ms=ms, equal_to_k1=equal)


def associate_inputs(cfg: VSLAMConfig, size: int, n_kp: int, device,
                     seed: int = 0) -> dict:
    """K2's arguments: a map of ``size`` random points in front of the
    camera (the reference bench's distribution) at the config's capacity,
    and ``n_kp`` keypoints, the first quarter planted within 2 px of
    visible points with those points' descriptors (strict-tier hits) or
    with 72 bits flipped (reacquisition-band hits; points last seen 2
    frames ago)."""
    rng = np.random.RandomState(seed)
    W, H = cfg.camera.width, cfg.camera.height
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    xyz = (rng.randn(size, 3) * [20.0, 8.0, 30.0] + [0.0, 0.0, 40.0])
    desc = rng.randint(-2 ** 31, 2 ** 31, (size, 8),
                       dtype=np.int64).astype(np.int32)
    m = point_map.insert_points(
        empty_map(cfg.map.capacity, cfg.map.obs_per_point, device),
        t(xyz.astype(np.float32)), torch.zeros((size, 3), device=device),
        t(desc), torch.ones(size, dtype=torch.bool, device=device),
        frame_idx=torch.zeros((), dtype=torch.int32, device=device))
    P = cam.projection_matrix(t(cfg.camera.K()),
                              torch.eye(4, device=device))
    muv, vis = point_map.project_map(m, P, W, H)
    kp_uv = np.stack([rng.uniform(0, W, n_kp), rng.uniform(0, H, n_kp)],
                     1).astype(np.float32)
    kp_desc = rng.randint(-2 ** 31, 2 ** 31, (n_kp, 8),
                          dtype=np.int64).astype(np.int32)
    visible = np.flatnonzero(vis.cpu().numpy())
    plant = rng.choice(visible, min(n_kp // 4, visible.size), replace=False)
    uv_map = muv.cpu().numpy()
    for j, p in enumerate(plant):
        kp_uv[j] = uv_map[p] + rng.uniform(-2, 2, 2)
        bits = np.unpackbits(desc[p].view(np.uint8), bitorder="little")
        if j % 2:
            bits[rng.choice(256, 72, replace=False)] ^= 1
        kp_desc[j] = np.packbits(bits, bitorder="little").view(np.int32)
    return dict(muv=muv, vis=vis, last_seen=m.last_seen,
                dcount=m.desc_count, desc=m.desc, size=m.size,
                frame_idx=torch.tensor(2, dtype=torch.int32, device=device),
                kp_uv=t(kp_uv), kp_free=torch.ones(n_kp, dtype=torch.bool,
                                                   device=device),
                kp_desc=t(kp_desc))


def associate_agreement(args: dict, cfg: VSLAMConfig) -> dict:
    """K2 (its plain version on CPU tensors) against ``associate_plain``:
    equal packed keys, and the hits of each tier."""
    kw = dict(point_map.gates(cfg.matching), block=cfg.map.block_size)
    got = k2.associate_cuda(**args, **kw)
    want = k2.associate_plain(**args, **kw)
    pid, d = k2.decode(want)
    hit = pid >= 0
    return dict(equal=bool(torch.equal(got, want)),
                hits_strict=int((hit & (d < cfg.matching.hamming_max)).sum()),
                hits_reacq=int((hit & (d >= cfg.matching.hamming_max)).sum()))


def bench_associate(device, map_sizes=(4096, 51200, 131072), n_kp=3072,
                    reps=20) -> list:
    cfg = VSLAMConfig()
    kw = dict(point_map.gates(cfg.matching), block=cfg.map.block_size)
    rows = []
    for size in map_sizes:
        args = associate_inputs(cfg, size, n_kp, device, seed=size)
        row = dict(map_size=size, **associate_agreement(args, cfg))
        row["ms"] = {
            "k2": event_ms(lambda: k2.associate_cuda(**args, **kw), reps),
            "associate_plain": event_ms(
                lambda: k2.associate_plain(**args, **kw), 3),
        }
        rows.append(row)
        del args
    return rows


def bench_eigh(device, batch=2048, reps=20) -> dict:
    g = torch.Generator(device="cpu").manual_seed(3)
    A8 = torch.randn((batch, 8, 9), generator=g).to(device)
    AtA = torch.einsum("bij,bik->bjk", A8, A8)
    w_jac = jacobi.jacobi_eigh(AtA, sweeps=8)[0]
    w_lib = torch.linalg.eigh(AtA)[0]
    scale = torch.clamp(w_lib.abs().amax(dim=-1, keepdim=True), min=1e-30)
    rel = float(((w_jac - w_lib).abs() / scale).max())
    jac = lambda: jacobi.jacobi_eigh(AtA, sweeps=8)
    return dict(batch=batch, max_rel_eigval_diff=rel, ms={
        "jacobi_8_sweeps": event_ms(jac, reps),
        # its many small kernels without the host's enqueue, as the
        # chunked driver runs them
        "jacobi_8_sweeps_graph": graph_ms(jac),
        "torch_linalg_eigh": event_ms(lambda: torch.linalg.eigh(AtA), reps),
    })


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="a CUDA device")
    ap.add_argument("--reps", type=int, default=20,
                    help="timed calls per kernel")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        print(f"bench_kernels: {args.device} is not an available CUDA "
              "device", file=sys.stderr)
        return 2
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    torch.cuda.set_device(dev)
    res = dict(device=torch.cuda.get_device_name(dev), smi=nvidia_smi(),
               hamming=bench_hamming(dev, reps=args.reps),
               associate=bench_associate(dev, reps=args.reps),
               eigh=bench_eigh(dev, reps=args.reps))
    print(json.dumps(res))
    bad = [k for k, v in res["hamming"]["equal_to_k1"].items() if not v]
    bad += [f"associate {r['map_size']}" for r in res["associate"]
            if not r["equal"]]
    if res["eigh"]["max_rel_eigval_diff"] > 1e-4:
        bad.append("eigh")
    for b in bad:
        print(f"bench_kernels: {b} disagrees", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
