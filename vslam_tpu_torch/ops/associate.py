"""Kernel K2: search-by-projection association, both tiers in one pass.

Replaces the Pallas TPU kernel ``vslam_tpu/ops/pallas_associate.py``
``_kernel`` (launched by ``associate_pallas_call``, wrapped by
``associate_fused``). Per free keypoint: among visible map points that
project within ``r_sq`` of it with min-over-occupied-archive-slots Hamming
distance ``< hamming_max`` — or, for points last seen 1..``reacq_max_age``
frames ago, within ``reacq_r_sq`` at ``< reacq_hamming_max`` — the
lexicographic (distance, id) minimum. The semantics are those of
``vslam_tpu.mapping.point_map.associate``'s XLA path.

On Hopper (``csrc/associate.cu``) the TPU kernel's running best, carried in
VMEM across a sequential map-block grid axis, has no counterpart. Persistent
blocks split the (512-keypoint tile x map row) pairs up to the insert cursor,
read on the device (the host never syncs on it), into equal ranges. Map
chunks of 128 rows arrive in shared memory by ``cp.async`` while the
previous one is swept; each thread box-tests 4 keypoints against every
point of the chunk with predicated compares, and a warp queues the points
that fall in some keypoint's box. A warp drains its queue when it is full
and at the end of a tile: the exact pixel gates of both tiers (this
module's arithmetic, no FMA), then eight lanes per pair load its archive
row, the min over occupied slots of popc(a ^ b) passes both tiers' Hamming
gates or not, and a packed key ``d * 2^18 + id`` goes to the keypoint's best
by ``atomicMin`` (shared, then one global ``atomicMin`` per keypoint into the
(N,) output pre-filled with ``NO_KEY``): order-free, so deterministic. What
bounds it is the pixel-gate sweep (N x size pair tests of 5 f32 operations),
not the Hamming work.

``associate_cuda`` is the wrapper: CPU tensors run ``associate_plain``;
CUDA tensors launch the kernel or raise. ``launches`` counts launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..frontend.descriptors import unpack_bits
from . import _build

launches = 0

NO_KEY = 1 << 30      # larger than any packed key (256 * 2^18 + id < 2^27)
BIG = 1 << 14         # distance reported when nothing is found
ID_BITS = 18          # packed-key id field: capacity <= 2^18


def decode(key):
    """Packed keys (N,) -> (point_id (N,) i32, distance (N,) i32)."""
    found = key < NO_KEY
    pid = torch.where(found, key & ((1 << ID_BITS) - 1), -1)
    dist = torch.where(found, key >> ID_BITS, BIG)
    return pid.to(torch.int32), dist.to(torch.int32)


def associate_plain(muv, vis, last_seen, dcount, desc, size, frame_idx,
                    kp_uv, kp_free, kp_desc, *, r_sq, hamming_max,
                    reacq_r_sq, reacq_hamming_max, reacq_max_age,
                    block: int = 4096):
    """Plain torch over fixed shapes: map blocks of ``block`` rows, the
    Hamming min over slots as exact f32 bit-plane products, a masked
    packed-key min. Returns the packed keys (N,) i32.

    ``size`` is unused: rows past the cursor are never visible (``vis``
    includes ``alive``), and skipping them would need the host to read it.
    """
    del size
    C = muv.shape[0]
    K = desc.shape[0] // C
    N = kp_uv.shape[0]
    kbits = unpack_bits(kp_desc).to(torch.float32)         # (N, 256)
    kpop = kbits.sum(1)
    if reacq_max_age > 0:
        age = frame_idx - last_seen
        recent = vis & (age >= 1) & (age <= reacq_max_age)
    else:
        recent = torch.zeros_like(vis)
    best = torch.full((N,), NO_KEY, dtype=torch.int32, device=muv.device)
    for s in range(0, C, block):
        e = min(s + block, C)
        du = muv[s:e, 0:1] - kp_uv[None, :, 0]
        dv = muv[s:e, 1:2] - kp_uv[None, :, 1]
        d2 = du * du + dv * dv
        near = vis[s:e, None] & (d2 <= r_sq)
        near_rq = recent[s:e, None] & (d2 <= reacq_r_sq)
        slots = desc[s * K:e * K].reshape(e - s, K, 8)
        ham = torch.full((e - s, N), BIG, dtype=torch.int32,
                         device=muv.device)
        for k in range(K):
            bits = unpack_bits(slots[:, k].contiguous()).to(torch.float32)
            d_k = (bits.sum(1)[:, None] + kpop[None, :]
                   - 2.0 * (bits @ kbits.T)).to(torch.int32)
            ham = torch.where((dcount[s:e] > k)[:, None],
                              torch.minimum(ham, d_k), ham)
        ok = (near & (ham < hamming_max)) | (near_rq & (ham < reacq_hamming_max))
        ok = ok & kp_free[None, :]
        row = torch.arange(s, e, dtype=torch.int32, device=muv.device)
        key = torch.where(ok, ham * (1 << ID_BITS) + row[:, None], NO_KEY)
        best = torch.minimum(best, key.amin(dim=0))
    return best


@functools.lru_cache(maxsize=1)
def _entry():
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return _build.declare("vslam_associate",
                          [p, p, p, p, p, p, p, p, p, p, p,
                           i, i, i, f, i, f, i, i, p])


def geometry(device) -> dict:
    """The kernel's work split on a CUDA ``device``: persistent ``blocks``,
    keypoints per ``tile``, and per warp its queue of map points
    (``queue_points``), its list of candidate pairs (``queue_pairs``) and its
    keypoints (``warp_keypoints``). A block sweeps about size x tiles /
    blocks map rows, every one of which a warp may queue."""
    out = (ctypes.c_int * 5)()
    with torch.cuda.device(device):
        err = _build.declare("vslam_associate_geometry",
                             [ctypes.c_void_p])(ctypes.addressof(out))
    _build.check(err, "associate geometry")
    return dict(zip(("blocks", "tile", "queue_points", "queue_pairs",
                     "warp_keypoints"), out))


def _want(t, name, dtype, shape):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: want {tuple(shape)} {dtype}, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def associate_cuda(muv, vis, last_seen, dcount, desc, size, frame_idx,
                   kp_uv, kp_free, kp_desc, *, r_sq: float, hamming_max: int,
                   reacq_r_sq: float, reacq_hamming_max: int,
                   reacq_max_age: int, block: int = 4096):
    """Search-by-projection for N keypoints against a C-point map.

    Map side: ``muv`` (C, 2) f32 projected pixels, ``vis`` (C,) bool,
    ``last_seen``/``dcount`` (C,) i32, ``desc`` (C*K, 8) i32 archive,
    ``size`` () i32 insert cursor, ``frame_idx`` () i32 (read only when
    ``reacq_max_age > 0``). Keypoint side: ``kp_uv`` (N, 2) f32,
    ``kp_free`` (N,) bool, ``kp_desc`` (N, 8) i32.
    Returns the packed keys (N,) i32 (``decode`` splits them).
    """
    global launches
    C, N = muv.shape[0], kp_uv.shape[0]
    if C > (1 << ID_BITS):
        raise ValueError(f"capacity {C} exceeds the 2^{ID_BITS} packed-key "
                         "bound")
    if C == 0 or desc.shape[0] % C:
        raise ValueError(f"archive rows {desc.shape[0]} not a multiple of "
                         f"capacity {C}")
    K = desc.shape[0] // C
    for t, name, dt, shp in (
            (muv, "muv", torch.float32, (C, 2)),
            (vis, "vis", torch.bool, (C,)),
            (last_seen, "last_seen", torch.int32, (C,)),
            (dcount, "dcount", torch.int32, (C,)),
            (desc, "desc", torch.int32, (C * K, 8)),
            (size, "size", torch.int32, ()),
            (frame_idx, "frame_idx", torch.int32, ()),
            (kp_uv, "kp_uv", torch.float32, (N, 2)),
            (kp_free, "kp_free", torch.bool, (N,)),
            (kp_desc, "kp_desc", torch.int32, (N, 8))):
        _want(t, name, dt, shp)
        if t.device != muv.device:
            raise ValueError(f"{name} on {t.device}, muv on {muv.device}")
    gates = dict(r_sq=r_sq, hamming_max=hamming_max, reacq_r_sq=reacq_r_sq,
                 reacq_hamming_max=reacq_hamming_max,
                 reacq_max_age=reacq_max_age)
    if muv.device.type == "cpu":
        return associate_plain(muv, vis, last_seen, dcount, desc, size,
                               frame_idx, kp_uv, kp_free, kp_desc,
                               block=block, **gates)
    if muv.device.type != "cuda":
        raise ValueError(f"unsupported device {muv.device}")
    if any(t.data_ptr() % 16 for t in (muv, vis, last_seen, dcount, desc,
                                       kp_desc)) or kp_uv.data_ptr() % 8:
        raise ValueError("the kernel copies map rows and descriptors in "
                         "16-byte and reads keypoint pixels in 8-byte "
                         "pieces: misaligned input")
    out = torch.full((N,), NO_KEY, dtype=torch.int32, device=muv.device)
    stream = torch.cuda.current_stream(muv.device).cuda_stream
    with torch.cuda.device(muv.device):
        err = _entry()(
            muv.data_ptr(), vis.data_ptr(), last_seen.data_ptr(),
            dcount.data_ptr(), desc.data_ptr(), size.data_ptr(),
            frame_idx.data_ptr(), kp_uv.data_ptr(), kp_free.data_ptr(),
            kp_desc.data_ptr(), out.data_ptr(),
            C, N, K, float(r_sq), int(hamming_max), float(reacq_r_sq),
            int(reacq_hamming_max), int(reacq_max_age), stream)
    _build.check(err, "associate kernel")
    launches += 1
    return out
