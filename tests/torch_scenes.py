"""Adversarial inputs for the port's two kernels, as numpy arrays.

Shared by tests/test_torch_kernels.py (the plain versions against the JAX
reference, on the CPU) and tests/test_torch_gpu.py (the CUDA kernels against
the plain versions, on a card); numpy only, so the GPU host needs no jax.

K2 scenes place map points by their pixels: a point at (u, v, 1) seen
through P = [I | 0] projects to exactly (u, v), so points can sit exactly on
a gate's boundary in both frameworks.
"""
import numpy as np

K1_SCENES = ("zeros_ones", "one_hot")
K2_SCENES = ("cluster", "ties", "boundary", "flood")

W, H = 1248, 384            # KITTI-sized image for the K2 scenes
FRAME = 20                  # current frame of the K2 scenes


def k1_scene(name):
    """(d1, d2) int32 (N, 8) descriptors.

    ``zeros_ones``: all-zero and all-ones rows (distances 0 and 256).
    ``one_hot``: e_i against e_j for every bit (distance 0 or 2), which
    catches a k mapping of A that differs from B's.
    """
    if name == "zeros_ones":
        z = np.zeros((1, 8), np.int32)
        o = np.full((1, 8), -1, np.int32)
        return (np.concatenate([z, o, o, z, z, o, z]),
                np.concatenate([o, z, z, o, o, z, o, z, o]))
    if name == "one_hot":
        eye = np.packbits(np.eye(256, dtype=np.uint8), axis=1,
                          bitorder="little").view(np.int32)
        return eye, np.ascontiguousarray(eye[::-1])
    raise ValueError(name)


def _desc(rng, n):
    return rng.randint(-2 ** 31, 2 ** 31, (n, 8), dtype=np.int64) \
        .astype(np.int32)


def _at(rng, q, d):
    """A descriptor at Hamming distance exactly d from q (random bits)."""
    bits = np.unpackbits(q.view(np.uint8), bitorder="little")
    bits[rng.choice(256, d, replace=False)] ^= 1
    return np.packbits(bits, bitorder="little").view(np.int32)


def _base(rng, C, K, size, n_kp):
    """Distractors: alive rows below ``size`` at random pixels with random
    archives, seen this frame (age 0: never in the reacq tier)."""
    sc = dict(pix=np.zeros((C, 2), np.float32), alive=np.zeros(C, bool),
              last_seen=np.zeros(C, np.int32), dcount=np.zeros(C, np.int32),
              desc=_desc(rng, C * K), size=size, frame=FRAME,
              kp_uv=np.zeros((n_kp, 2), np.float32), kp_desc=_desc(rng, n_kp),
              kp_free=np.ones(n_kp, bool), expect=[])
    sc["pix"][:size] = np.stack([rng.uniform(0, W, size),
                                 rng.uniform(0, H, size)], 1)
    sc["alive"][:size] = True
    sc["last_seen"][:size] = FRAME
    sc["dcount"][:size] = rng.randint(1, K + 3, size)
    return sc


def _put(sc, K, row, uv, age, dcount, slots):
    """Place map row ``row`` at pixel ``uv`` with the given age, desc_count
    and archive slots {slot: descriptor}."""
    sc["pix"][row] = uv
    sc["last_seen"][row] = FRAME - age
    sc["dcount"][row] = dcount
    for s, d in slots.items():
        sc["desc"][row * K + s] = d


def k2_scene(name, K=4, C=4096, r=12.0, rq=6.0, hmax=64, rq_hmax=96,
             max_age=8):
    """Map rows (pixels ``pix``, ``alive``, ``last_seen``, ``dcount``, the
    (C*K, 8) archive ``desc``, cursor ``size``), keypoints (``kp_uv``,
    ``kp_desc``, ``kp_free``), ``frame``, and ``expect``: (keypoint, point
    id or -1, distance) that the association must give.

    ``cluster``: 1600 points inside a 4 px disk with 120 keypoints in it,
    every pair inside the 12 px gate (192,000 candidates), among distractors.
    ``flood``: ``k2_flood`` at this capacity (size C - 96, 300 keypoints);
    at capacity 131072 it overflows the kernel's queues in every block.
    ``ties``: per keypoint 2-5 points at one Hamming distance in varied
    archive slots, ids spread over the map; the smallest id must win; a
    closer descriptor outside the radius and one in an unoccupied slot are
    decoys.
    ``boundary``: points exactly on r^2 and on the reacq r^2 (and one ulp
    outside), Hamming distances at hmax - 1 / hmax and rq_hmax - 1 /
    rq_hmax, ages 0, 1, 8 and 9, a point in both tiers tied with a strict
    one, desc_count 0 and above K; size 1037 and 600 keypoints (multiples of
    neither the kernel's chunk nor its keypoint tile).
    """
    if name == "cluster":
        rng = np.random.RandomState(11)
        size, n_kp = 3000, 300
        sc = _base(rng, C, K, size, n_kp)
        centre = np.array([400.0, 200.0])

        def disk(n):
            a = rng.uniform(0, 2 * np.pi, n)
            rad = 4.0 * np.sqrt(rng.uniform(0, 1, n))
            return centre + np.stack([rad * np.cos(a), rad * np.sin(a)], 1)

        rows = rng.choice(size, 1600, replace=False)
        sc["pix"][rows] = disk(len(rows))
        sc["kp_uv"][:120] = disk(120)
        sc["kp_uv"][120:] = np.stack([rng.uniform(0, W, n_kp - 120),
                                      rng.uniform(0, H, n_kp - 120)], 1)
        sc["last_seen"][rows] = FRAME - rng.randint(0, 12, len(rows))
        for row in rows:
            src = sc["kp_desc"][rng.randint(120)]
            sc["desc"][row * K + rng.randint(K)] = _at(rng, src,
                                                       rng.randint(110))
        sc["alive"][rng.choice(size, 100, replace=False)] = False
        sc["kp_free"][rng.choice(n_kp, 15, replace=False)] = False
        return sc

    if name == "ties":
        rng = np.random.RandomState(12)
        size, n_kp = 2600, 64
        sc = _base(rng, C, K, size, n_kp)
        pool = iter(rng.permutation(size))
        for k in range(n_kp):
            p = np.array([40.0 + 60 * (k % 20), 40.0 + 60 * (k // 20)])
            sc["kp_uv"][k] = p
            q = sc["kp_desc"][k]
            d = int(rng.randint(2, 96))
            ids = []
            for _ in range(rng.randint(2, 6)):
                row = next(pool)
                a = rng.uniform(0, 2 * np.pi)
                rad = rng.uniform(0, 5.5)
                slot = rng.randint(K)
                _put(sc, K, row, p + rad * np.array([np.cos(a), np.sin(a)]),
                     int(rng.randint(1, max_age + 1)), slot + 1,
                     {slot: _at(rng, q, d)})
                ids.append(row)
            _put(sc, K, next(pool), p + [13.0, 0.0], 1, 1,
                 {0: _at(rng, q, max(d - 2, 0))})     # outside the radius
            row = next(pool)
            _put(sc, K, row, p + [2.0, 0.0], 1, 1,
                 {0: _desc(rng, 1)[0], 1: _at(rng, q, max(d - 2, 0))})
            sc["expect"].append((k, min(ids), d))
        return sc

    if name == "flood":
        return k2_flood(C, C - 96, 300, K)

    if name == "boundary":
        rng = np.random.RandomState(13)
        size, n_kp = 1037, 600
        sc = _base(rng, C, K, size, n_kp)
        pool = iter(rng.permutation(size))
        up = lambda x: np.nextafter(np.float32(x), np.float32(np.inf))
        rs, rqs = np.float32(r), np.float32(rq)
        for k in range(n_kp):
            x, y = 20.0 + 30 * (k % 40), 20.0 + 24 * (k // 40)
            sc["kp_uv"][k] = (x, y)
            q = sc["kp_desc"][k]
            case = k % 8

            def put(uv, age, d, dcount=1, slot=0):
                row = next(pool)
                _put(sc, K, row, uv, age, dcount, {slot: _at(rng, q, d)})
                return row

            if case == 0:                  # on r^2, at hmax - 1
                sc["expect"].append((k, put((x + rs, y), 0, hmax - 1),
                                     hmax - 1))
            elif case == 1:                # at hmax; one ulp outside r^2
                put((x - rs, y), 0, hmax)
                put((up(x + rs), y), 0, 5)
                sc["expect"].append((k, -1, None))
            elif case == 2:                # on the reacq r^2, rq_hmax - 1
                sc["expect"].append((k, put((x, y + rqs), 1, rq_hmax - 1),
                                     rq_hmax - 1))
            elif case == 3:                # reacq: one ulp out; too old
                put((x, up(y + rqs)), max_age, hmax + 6)
                put((x + rqs, y), max_age + 1, hmax + 6)
                sc["expect"].append((k, -1, None))
            elif case == 4:                # both tiers, tied with strict
                a = put((x + 3, y + 4), max_age, 40)
                b = put((x - 3, y - 4), 0, 40)
                sc["expect"].append((k, min(a, b), 40))
            elif case == 5:                # at rq_hmax; empty archive
                put((x, y - rqs), 1, rq_hmax)
                put((x + rs, y), 0, 1, dcount=0)
                sc["expect"].append((k, -1, None))
            elif case == 6:                # desc_count above K: slot K-1
                sc["expect"].append((k, put((x + 10, y), 0, 10,
                                            dcount=K + 3, slot=K - 1), 10))
            else:                          # slot 2 unoccupied (dcount 2)
                row = put((x - 10, y), 0, 50, dcount=2, slot=1)
                sc["desc"][row * K + 2] = _at(rng, q, 1)
                sc["expect"].append((k, row, 50))
        return sc
    raise ValueError(name)


def k2_flood(C, size, n_kp, K=4, seed=14):
    """A k2_scene in which every map point below ``size`` and every keypoint
    lie in one 4 px disk, so every pair is inside the 12 px gate: each warp
    of the kernel queues every visible point of its range, and each queued
    point brings a pair for every free keypoint of the warp. Built with
    vectorised numpy, so it scales to a full-capacity map.

    A point's occupied slot holds a keypoint's descriptor with a 2^-m share
    of its bits flipped, m = 1..4 per keypoint: keypoints at m = 1 (about
    128 bits) match at best in the reacq band, the others in the strict
    tier, often tied across ids."""
    rng = np.random.RandomState(seed)
    sc = _base(rng, C, K, size, n_kp)
    centre = np.array([600.0, 190.0])

    def disk(n):
        a = rng.uniform(0, 2 * np.pi, n)
        rad = 4.0 * np.sqrt(rng.uniform(0, 1, n))
        return centre + np.stack([rad * np.cos(a), rad * np.sin(a)], 1)

    sc["pix"][:size] = disk(size)
    sc["kp_uv"][:] = disk(n_kp)
    sc["last_seen"][:size] = FRAME - rng.randint(0, 12, size)
    src = rng.randint(n_kp, size=size)
    level = rng.randint(1, 5, n_kp)[src]
    flip = np.full((size, 8), -1, np.int32)
    for m in range(4):
        flip &= np.where((m < level)[:, None], _desc(rng, size), -1)
    slot = (rng.uniform(size=size) * np.minimum(sc["dcount"][:size], K)) \
        .astype(np.int64)
    sc["desc"][np.arange(size) * K + slot] = sc["kp_desc"][src] ^ flip
    sc["alive"][rng.choice(size, size // 50, replace=False)] = False
    sc["kp_free"][rng.choice(n_kp, n_kp // 10, replace=False)] = False
    return sc


def k2_pixels(sc):
    """(muv, vis) as ``project_map`` gives them for the scene's map."""
    u, v = sc["pix"][:, 0], sc["pix"][:, 1]
    vis = sc["alive"] & (u >= 0) & (u < W) & (v >= 0) & (v < H)
    return sc["pix"], vis


def check_expect(sc, pid, dist):
    """Assert the association (numpy point ids and distances) gives the
    scene's expected outcomes."""
    for k, want_id, want_d in sc["expect"]:
        assert pid[k] == want_id, (k, pid[k], want_id)
        if want_id >= 0:
            assert dist[k] == want_d, (k, dist[k], want_d)
