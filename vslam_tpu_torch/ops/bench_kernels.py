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
    8-sweep Jacobi as the torch loop (``jacobi_eigh_plain``) and as its
    kernel (``csrc/jacobi.cu``, which must equal the loop bit for bit)
    against ``torch.linalg.eigh`` (eigenvalues compared); and the kernel,
    equal to the loop, at each call of the tracking step, on the inputs the
    step builds (``step_eigh_inputs``);
  * RANSAC's polish: the ``sampson_gn`` kernel's linearisation and trial
    cost against their plain versions at each call of a default-config
    step, within ``polish_gap``'s tolerance (``bench_polish``).

Every time is a CUDA-event time of single calls (``utils.profiling
.event_ms``); the loop's also of one replay of it captured as a CUDA graph
(``utils.profiling.graph_ms``). Prints one JSON line with nvidia-smi's name and power limit;
exits 1 if any formulation disagrees, 2 without a CUDA device.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys

import numpy as np
import torch

from ..config import VSLAMConfig
from ..core import camera as cam
from ..core import lie
from ..core.types import empty_map
from ..datasets import synthetic
from ..frontend.descriptors import unpack_bits
from ..geometry import ransac, triangulation
from ..mapping import point_map
from ..matching import hamming
from ..pipeline import tracker
from ..utils import jit
from ..utils.profiling import event_ms, graph_ms, nvidia_smi
from . import associate as k2
from . import hamming as k1
from . import jacobi, sampson_gn


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


def _two_view(cfg: VSLAMConfig, device, n: int, seed: int):
    """n correspondences of a synthetic two-view at the config's camera,
    20% of them outliers and the rest of the rows invalid padding, as the
    step's matcher hands them to RANSAC: (uv1, uv2, valid, K)."""
    cam_ = cfg.camera
    K = cam_.K()
    scene = synthetic.make_scene(num_points=4 * n, seed=seed)
    poses = synthetic.make_trajectory(2, step=0.8, seed=seed)
    uv1, uv2, vis, _ = synthetic.correspondences(
        K, poses[0], poses[1], scene.xyz, cam_.width, cam_.height,
        noise_px=0.5, seed=seed)
    keep = np.flatnonzero(vis)[:n]
    rng = np.random.RandomState(seed)
    pad = lambda a: np.concatenate([a[keep], rng.uniform(
        0, cam_.height, (n - len(keep), 2)).astype(np.float32)])
    uv1, uv2 = pad(uv1), pad(uv2)
    bad = rng.rand(n) < 0.2
    uv2[bad] = rng.uniform(0, cam_.height, (bad.sum(), 2))
    valid = np.arange(n) < len(keep)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return t(uv1), t(uv2), t(valid), t(K.astype(np.float32))


def step_eigh_inputs(device, seed: int = 5) -> list:
    """[(A, sweeps)] of every ``jacobi_eigh`` call the default-config
    tracking step makes, in the order of ``jacobi.STEP_CALLS``, built by
    the step's own code: ``ransac_pose_from_samples`` on 3072
    correspondences of a synthetic two-view and 1024 hypotheses, then
    ``triangulate_dlt`` with one camera pair for all rows and with one a
    row (the delayed track's form). The calls are recorded while the torch
    loop runs them; raises if RANSAC finds no pose."""
    cfg = VSLAMConfig()
    device = torch.device(device)
    uv1, uv2, valid, K = _two_view(cfg, device, 3072, seed)
    calls = []

    def record(A, sweeps=8):
        calls.append((A.clone(), sweeps))
        return jacobi.jacobi_eigh_plain(A, sweeps)

    g = torch.Generator(device=device).manual_seed(3)
    idx = ransac.sample_minimal_sets(g, valid.float(),
                                     cfg.ransac.num_hypotheses, 8)
    run = jacobi.jacobi_eigh
    jacobi.jacobi_eigh = record
    try:
        res = ransac.ransac_pose_from_samples(
            idx, uv1, uv2, valid, K,
            inlier_threshold=cfg.ransac.inlier_threshold,
            min_inliers=cfg.ransac.min_inliers)
        P1 = torch.cat([K, torch.zeros((3, 1), device=device)], dim=1)
        P2 = K @ torch.cat([res.R, res.t[:, None]], dim=1)
        triangulation.triangulate_dlt(P1, P2, uv1, uv2)
        n = uv1.shape[0]
        triangulation.triangulate_dlt(P1.expand(n, 3, 4).contiguous(),
                                      P2.expand(n, 3, 4).contiguous(),
                                      uv1, uv2)
    finally:
        jacobi.jacobi_eigh = run
    if not bool(res.success):
        raise RuntimeError("RANSAC found no pose on the two-view")
    return calls


def polish_inputs(device, n: int, seed: int = 3):
    """``refine_pose_gn``'s arguments on a synthetic two-view of n matches
    at the default config's camera (``_two_view``: 20% outliers, invalid
    padding rows): 13 starts, small rotations and random directions, the
    sixth with an inf in R so that its residuals are NaN. Returns
    (R (13, 3, 3), t (13, 3), K, uv1, uv2, w (n,) float)."""
    uv1, uv2, valid, K = _two_view(VSLAMConfig(), device, n, seed)
    rng = np.random.RandomState(seed)
    R = lie.so3_exp(torch.from_numpy(
        rng.randn(13, 3).astype(np.float32) * 0.05)).to(device)
    R[5, 0, 0] = torch.inf
    t = rng.randn(13, 3).astype(np.float32)
    t = torch.from_numpy(t / np.linalg.norm(t, axis=1, keepdims=True))
    return R, t.to(device), K, uv1, uv2, valid.to(torch.float32)


def polish_rays(device, n: int, seed: int = 3):
    """``sampson_gn``'s arguments from ``polish_inputs``' two-view (of at
    least 8 matches, the first n kept): (R, t, x1, x2 (n, 3) normalised
    rays, valid (n,), c), as ``refine_pose_gn`` builds them."""
    R, t, K, uv1, uv2, w = polish_inputs(device, max(n, 8), seed)
    K_inv = torch.linalg.inv_ex(K)[0]
    ones = torch.ones_like(uv1[..., :1])
    x1, x2 = (torch.einsum("ij,nj->ni", K_inv, torch.cat([uv, ones], -1))
              [:n].contiguous() for uv in (uv1, uv2))
    c = 1.0 / (0.5 * (K[0, 0] + K[1, 1]))
    return R, t, x1, x2, (w[:n] > 0).to(torch.float32), c


POLISH_ENTRIES = ("linearize", "trial_cost")


@contextlib.contextmanager
def recording_polish_calls():
    """Within the block, every ``sampson_gn.linearize`` and ``trial_cost``
    call is appended to the yielded list as (entry name, its arguments
    cloned), and runs as it would."""
    calls = []
    run = {name: getattr(sampson_gn, name) for name in POLISH_ENTRIES}

    def recorder(name):
        def call(*args):
            calls.append((name, [x.clone() for x in args]))
            return run[name](*args)
        return call

    for name in POLISH_ENTRIES:
        setattr(sampson_gn, name, recorder(name))
    try:
        yield calls
    finally:
        for name, fn in run.items():
            setattr(sampson_gn, name, fn)


def polish_shapes(calls) -> tuple:
    """The (starts, matches, iterations, polishes) rows of calls recorded
    by ``recording_polish_calls``, in ``sampson_gn.STEP_CALLS``'s form: a
    polish is its iterations' (linearize, trial_cost) pairs, then its final
    trial_cost; consecutive polishes of one shape make one row."""
    rows, iters, open_pair = [], 0, False
    for name, args in calls:
        if name == "linearize":
            iters, open_pair = iters + 1, True
        elif open_pair:
            open_pair = False
        else:
            row = (args[1].shape[0], args[3].shape[0], iters)
            if rows and rows[-1][:3] == row:
                rows[-1] = row + (rows[-1][3] + 1,)
            else:
                rows.append(row + (1,))
            iters = 0
    return tuple(rows)


def step_polish_calls(frames, cfg, device) -> list:
    """``recording_polish_calls``' record of eager tracking steps of
    ``cfg``: ``frames[0]`` bootstraps, each later frame is one
    ``track_step`` (under ``utils.jit.disable_jit``, so a card runs it
    eagerly too)."""
    st = tracker.bootstrap(frames[0], cfg, device, seed=0, rng="torch")
    with recording_polish_calls() as calls, jit.disable_jit():
        for f in frames[1:]:
            st, _ = tracker.track_step(st, f, cfg)
    return calls


def polish_gap(name, args):
    """The kernel's ``sampson_gn`` entry ``name`` (one launch) against its
    plain version on ``args``: (widest ratio of the kernel's error to its
    tolerance, kernel outputs). Errors are taken against the plain version
    evaluated in float64 on the same inputs, over the sum of each entry's
    terms' magnitudes M (sum_n |J_na rw_n| |J_nb| for H_ab,
    sum_n |J_na rw_n| |r_n| for g_a, the cost itself for a cost, whose
    terms are >= 0). The kernel sums the N matches in its own fixed order
    (a recursive f32 sum of N terms is within N 2^-24 of M in any order)
    and rounds each term's dual arithmetic in its own order, where the
    residual's and the Jacobian's dot products cancel as much as the plain
    version's do. So in each output the kernel's widest error may be twice
    the plain version's widest plus (N + 64) 2^-24. Raises unless the
    kernel is NaN where the plain version is, and launched once."""
    before = sampson_gn.launches
    got = getattr(sampson_gn, name)(*args)
    if sampson_gn.launches != before + 1:
        raise RuntimeError(f"{name}: {sampson_gn.launches - before} launches")
    plain = getattr(sampson_gn, f"{name}_plain")
    want = plain(*args)
    ref = plain(*(x.double() for x in args))
    if name == "linearize":
        R, t, x1, x2, valid, c = (x.double() for x in args)
        z = torch.zeros((R.shape[0], 5), dtype=R.dtype, device=R.device)
        r = sampson_gn.sampson_res(z, R, t, x1, x2)
        J = sampson_gn.sampson_jac(z, R, t, x1, x2)
        Jw = (J * (valid / (1.0 + (r / c) ** 2))[..., None]).abs()
        scale = (torch.einsum("sna,snb->sab", Jw, J.abs()),
                 torch.einsum("sna,sn->sa", Jw, r.abs()), ref[2].abs())
    else:
        got, want, ref, scale = (got,), (want,), (ref,), (ref.abs(),)
    tol = (args[-3].shape[0] + 64) * 2.0 ** -24
    worst = 0.0
    for x, y, y64, m in zip(got, want, ref, scale):
        if not torch.equal(torch.isnan(x), torch.isnan(y)):
            raise RuntimeError(f"{name}: NaN at other entries than plain")
        num = ~torch.isnan(y64)
        if num.any():
            err = lambda v: float(((v.double() - y64).abs()[num]
                                   / (m[num] + 1e-300)).max())
            worst = max(worst, err(x) / (2.0 * err(y) + tol))
    return worst, got


def polish_work(S: int, N: int, name: str):
    """(bytes, f32 operations) of one ``sampson_gn`` launch: the poses,
    rays, weights and step read once and the outputs written once; per
    (start, match) pair 47 operations for the residual and its cost term,
    and for ``linearize`` 51 for each of the 5 tangents (E's tangent times
    x1 and x2, num's, den's, the sqrt's and the division's), 9 for the
    Cauchy weight and the weighted row, and 40 for H's 15 and g's 5
    sums."""
    lin = name == "linearize"
    n_bytes = 4 * (12 * S + 7 * N + 1 + (0 if lin else 5 * S)
                   + (31 if lin else 1) * S)
    return n_bytes, S * N * (47 + (5 * 51 + 9 + 40 if lin else 0))


def bench_polish(device, reps=20) -> dict:
    """The polish kernel against its plain versions at each call of one
    default-config step (its map cut to 4096 slots, which the polish never
    reads), on the inputs the step builds: the widest gap to the tolerance
    (``polish_gap``), and each entry's kernel and plain times (single
    calls); a step's times are 10 linearisations and 11 trial costs."""
    cfg = VSLAMConfig()
    cfg = cfg.replace(map=dataclasses.replace(cfg.map, capacity=4096))
    cam_ = cfg.camera
    scene = synthetic.make_scene(num_points=700, seed=2,
                                 extent=(14, 6, 45), z_min=6.0)
    poses = synthetic.make_trajectory(2, step=0.6, yaw_rate=0.01, seed=2)
    frames = torch.from_numpy(np.stack(synthetic.render_sequence(
        cam_.K(), poses, scene, cam_.width, cam_.height))).to(device)
    calls = step_polish_calls(frames, cfg, device)
    worst = max(polish_gap(name, args)[0] for name, args in calls)
    out = dict(shapes=polish_shapes(calls), widest_gap=worst, ms={},
               plain_ms={}, work={})
    for name in POLISH_ENTRIES:
        args = next(a for n, a in calls if n == name)
        out["ms"][name] = event_ms(
            lambda: getattr(sampson_gn, name)(*args), reps)
        plain = getattr(sampson_gn, f"{name}_plain")
        out["plain_ms"][name] = event_ms(lambda: plain(*args), 3)
        R = args[0] if name == "linearize" else args[1]
        out["work"][name] = polish_work(R.shape[0], args[-3].shape[0], name)
    counts = {"linearize": sum(n == "linearize" for n, _ in calls),
              "trial_cost": sum(n == "trial_cost" for n, _ in calls)}
    out["step_ms"] = sum(out["ms"][k] * n for k, n in counts.items())
    out["step_plain_ms"] = sum(out["plain_ms"][k] * n
                               for k, n in counts.items())
    out["step_work"] = [sum(out["work"][k][i] * n for k, n in counts.items())
                        for i in range(2)]
    return out


def bits_equal(a, b) -> bool:
    """a has b's bits wherever b is a number (so -0 and +0 differ) and NaN
    wherever b is NaN."""
    nan = torch.isnan(b)
    return bool(a.shape == b.shape and torch.equal(torch.isnan(a), nan)
                and torch.equal(torch.where(nan, 0.0, a).view(torch.int32),
                                torch.where(nan, 0.0, b).view(torch.int32)))


def eigh_work(shape, sweeps: int):
    """(bytes, float operations) of ``jacobi_eigh`` on ``shape`` f32: A read
    once, eigenvalues and eigenvectors written once; per pair of a round,
    13 operations for (c, s) and 3 (two products and a sum) for each of the
    pair's 2 n entries in the row pass, the column pass and V's columns
    (the sort's n^2 comparisons left out)."""
    n = shape[-1]
    batch = int(np.prod(shape[:-2], dtype=np.int64))
    pairs = sum(len(r) for r in jacobi._round_robin_schedule(n))
    n_bytes = 4 * batch * (2 * n * n + n)
    return n_bytes, batch * sweeps * pairs * (13 + 3 * 3 * 2 * n)


def bench_eigh(device, batch=2048, reps=20) -> dict:
    g = torch.Generator(device="cpu").manual_seed(3)
    A8 = torch.randn((batch, 8, 9), generator=g).to(device)
    AtA = torch.einsum("bij,bik->bjk", A8, A8)
    w_jac, V_jac = jacobi.jacobi_eigh_plain(AtA, sweeps=8)
    w_ker, V_ker = jacobi.jacobi_eigh(AtA, sweeps=8)
    w_lib = torch.linalg.eigh(AtA)[0]
    scale = torch.clamp(w_lib.abs().amax(dim=-1, keepdim=True), min=1e-30)
    rel = float(((w_jac - w_lib).abs() / scale).max())
    jac = lambda: jacobi.jacobi_eigh_plain(AtA, sweeps=8)
    equal = bits_equal(w_ker, w_jac) and bits_equal(V_ker, V_jac)
    step = []
    for A, sweeps in step_eigh_inputs(device):
        w, V = jacobi.jacobi_eigh(A, sweeps)
        w_p, V_p = jacobi.jacobi_eigh_plain(A, sweeps)
        equal = equal and bits_equal(w, w_p) and bits_equal(V, V_p)
        step.append(dict(shape=list(A.shape), sweeps=sweeps, ms=event_ms(
            lambda: jacobi.jacobi_eigh(A, sweeps), reps)))
    ms = {
        "jacobi_8_sweeps": event_ms(jac, reps),
        # its many small kernels without the host's enqueue, as the
        # chunked driver runs them
        "jacobi_8_sweeps_graph": graph_ms(jac),
        "jacobi_kernel_8_sweeps": event_ms(
            lambda: jacobi.jacobi_eigh(AtA, sweeps=8), reps),
        "torch_linalg_eigh": event_ms(lambda: torch.linalg.eigh(AtA), reps),
    }
    return dict(batch=batch, max_rel_eigval_diff=rel,
                kernel_equal_to_loop=equal, ms=ms, kernel_at_step_calls=step)


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
               eigh=bench_eigh(dev, reps=args.reps),
               polish=bench_polish(dev, reps=args.reps))
    print(json.dumps(res))
    bad = [k for k, v in res["hamming"]["equal_to_k1"].items() if not v]
    bad += [f"associate {r['map_size']}" for r in res["associate"]
            if not r["equal"]]
    if res["eigh"]["max_rel_eigval_diff"] > 1e-4:
        bad.append("eigh")
    if not res["eigh"]["kernel_equal_to_loop"]:
        bad.append("the Jacobi kernel")
    if not res["polish"]["widest_gap"] <= 1.0:
        bad.append("the polish kernel")
    for b in bad:
        print(f"bench_kernels: {b} disagrees", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
