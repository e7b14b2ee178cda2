"""The port's CUDA kernels against their plain torch versions, on a card.

Every test here is marked ``gpu`` and skips without a CUDA device. The
module imports no jax (the GPU machine has none); run it there without the
repository's conftest, which imports jax:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

The plain versions are held to the JAX reference on the CPU by
tests/test_torch_kernels.py; here the kernels are held to the plain
versions, exactly, on the same device tensors. Map maintenance and the BA
solve, plain torch held to the reference by tests/test_torch_map_lifecycle.py
and tests/test_torch_ba.py, are held on the card to their CPU runs.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch_scenes as scenes

from vslam_tpu_torch.config import BAConfig, small_config
from vslam_tpu_torch.core import camera as cam
from vslam_tpu_torch.core.types import PT_COLS, MapState, empty_map
from vslam_tpu_torch.mapping import point_map
from vslam_tpu_torch.ops import associate as k2
from vslam_tpu_torch.ops import hamming as k1
from vslam_tpu_torch.optimizer import ba

pytestmark = pytest.mark.gpu

CFG = small_config()
W, H = CFG.camera.width, CFG.camera.height


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (hand kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _desc(rng, n):
    return torch.from_numpy(rng.randint(-2 ** 31, 2 ** 31, (n, 8),
                                        dtype=np.int64).astype(np.int32))


@pytest.mark.parametrize("n1,n2", [(3072, 3072), (100, 300), (1, 129),
                                   (257, 1), (17, 9), (3071, 3073),
                                   (16, 3072)])
def test_k1_kernel_matches_plain(cuda, n1, n2):
    rng = np.random.RandomState(n1 + n2)
    d1, d2 = _desc(rng, n1).to(cuda), _desc(rng, n2).to(cuda)
    before = k1.launches
    got = k1.hamming_cuda(d1, d2)
    assert k1.launches == before + 1
    assert torch.equal(got, k1.hamming_plain(d1, d2))


@pytest.mark.parametrize("name", scenes.K1_SCENES)
def test_k1_kernel_on_adversarial_descriptors(cuda, name):
    """All-zero against all-ones (d = 0 and 256); one-hot e_i against e_j
    (d = 0 or 2: A and B must map k the same way in the b1 fragments)."""
    d1, d2 = (torch.from_numpy(d).to(cuda) for d in scenes.k1_scene(name))
    before = k1.launches
    got = k1.hamming_cuda(d1, d2)
    assert k1.launches == before + 1
    assert torch.equal(got, k1.hamming_plain(d1, d2))


def _scene(dev, seed, capacity=4096, n_pts=2500, n_kp=256):
    """Map + planted near-duplicate keypoints, built with the port's own
    map functions: hits in the strict tier and the 64-96 reacq band."""
    rng = np.random.RandomState(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    xyz = np.stack([rng.uniform(-8, 8, n_pts), rng.uniform(-6, 6, n_pts),
                    rng.uniform(4, 30, n_pts)], 1).astype(np.float32)
    m = empty_map(capacity, CFG.map.obs_per_point, dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    m = point_map.insert_points(m, t(xyz), torch.zeros((n_pts, 3),
                                                       device=dev),
                                _desc(rng, n_pts).to(dev),
                                torch.ones(n_pts, dtype=torch.bool,
                                           device=dev), zero)
    ids = rng.choice(n_pts, n_pts // 3, replace=False).astype(np.int32)
    for _ in range(2):
        m = point_map.add_observations(
            m, t(ids), _desc(rng, len(ids)).to(dev),
            torch.ones(len(ids), dtype=torch.bool, device=dev), zero)
    last = np.zeros(capacity, np.int32)
    last[:n_pts] = 12 - rng.randint(0, 12, n_pts)
    m = m.replace(last_seen=t(last))
    K = torch.from_numpy(CFG.camera.K()).to(dev)
    P = cam.projection_matrix(K, torch.eye(4, device=dev))
    muv, vis = point_map.project_map(m, P, W, H)
    sel = rng.choice(np.flatnonzero(vis.cpu().numpy()), n_kp, replace=False)
    kp_uv = (muv.cpu().numpy()[sel]
             + rng.randn(n_kp, 2) * 3.0).astype(np.float32)
    arch = m.desc.cpu().numpy()
    kp_desc = arch[sel * CFG.map.obs_per_point].copy()
    for i in range(n_kp):
        bits = np.unpackbits(kp_desc[i].view(np.uint8), bitorder="little")
        bits[rng.choice(256, rng.randint(110), replace=False)] ^= 1
        kp_desc[i] = np.packbits(bits, bitorder="little").view(np.int32)
    return (muv, vis, m.last_seen, m.desc_count, m.desc, m.size,
            torch.tensor(12, dtype=torch.int32, device=dev), t(kp_uv),
            t(rng.rand(n_kp) < 0.9), t(kp_desc))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("reacq", [True, False])
def test_k2_kernel_matches_plain(cuda, seed, reacq):
    args = _scene(cuda, seed)
    kw = point_map.gates(CFG.matching, reacq)
    before = k2.launches
    got = k2.associate_cuda(*args, **kw)
    assert k2.launches == before + 1
    want = k2.associate_plain(*args, **kw)
    assert torch.equal(got, want)
    pid, d = k2.decode(want)
    hit = pid >= 0
    assert int((hit & (d < CFG.matching.hamming_max)).sum()) > 0
    assert bool(reacq) == bool((hit & (d >= CFG.matching.hamming_max))
                               .any())


def _scene_args(sc, dev):
    """K2's positional inputs for a torch_scenes scene, on ``dev``."""
    muv, vis = scenes.k2_pixels(sc)
    t = lambda a, dt=None: torch.as_tensor(np.array(a), dtype=dt).to(dev)
    return (t(muv), t(vis), t(sc["last_seen"]), t(sc["dcount"]),
            t(sc["desc"]), t(sc["size"], torch.int32),
            t(sc["frame"], torch.int32), t(sc["kp_uv"]), t(sc["kp_free"]),
            t(sc["kp_desc"]))


@pytest.mark.parametrize("name", scenes.K2_SCENES)
def test_k2_kernel_on_adversarial_scenes(cuda, name):
    """A dense cluster, ties across ids and archive slots (the smallest id
    wins), points on the r^2 and reacq r^2 boundaries with size and N
    multiples of neither the chunk nor the keypoint tile, and a small
    flood (every pair inside the gate)."""
    g = CFG.matching
    sc = scenes.k2_scene(name, K=CFG.map.obs_per_point, r=g.search_radius,
                         rq=g.reacq_radius, hmax=g.hamming_max,
                         rq_hmax=g.reacq_hamming_max,
                         max_age=g.reacq_max_age)
    args = _scene_args(sc, cuda)
    kw = point_map.gates(g)
    before = k2.launches
    got = k2.associate_cuda(*args, **kw)
    assert k2.launches == before + 1
    assert torch.equal(got, k2.associate_plain(*args, **kw))
    pid, dist = k2.decode(got)
    scenes.check_expect(sc, pid.cpu().numpy(), dist.cpu().numpy())


def test_k2_queues_overflow_in_every_block(cuda):
    """The full-capacity flood: every pair inside the gate, and every
    block's range (from the kernel's own grid) more than twice the map
    points a warp's queue holds, so each warp's queue fills and drains
    mid-sweep; a full queue brings more pairs than the warp's candidate
    list holds, so that list is scored mid-drain too. Bit-exact, with hits
    in both tiers."""
    geo = k2.geometry(cuda)
    C, size, n_kp = 131072, 120000, 1000
    tiles = -(-n_kp // geo["tile"])
    assert size * tiles // geo["blocks"] > 2 * geo["queue_points"], geo
    assert geo["queue_points"] * geo["warp_keypoints"] > geo["queue_pairs"]
    sc = scenes.k2_flood(C, size, n_kp, K=CFG.map.obs_per_point)
    args = _scene_args(sc, cuda)
    kw = point_map.gates(CFG.matching)
    before = k2.launches
    got = k2.associate_cuda(*args, **kw)
    assert k2.launches == before + 1
    assert torch.equal(got, k2.associate_plain(*args, **kw))
    pid, dist = k2.decode(got)
    hmax = CFG.matching.hamming_max
    assert int(((pid >= 0) & (dist < hmax)).sum()) > 0
    assert int(((pid >= 0) & (dist >= hmax)).sum()) > 0


def test_k2_skips_chunks_past_the_cursor(cuda):
    """Rows at or past the insert cursor are never read: with ``size``
    forced below points that are alive (a state the map functions never
    produce), those points are never associated."""
    args = list(_scene(cuda, 2, capacity=8192))
    args[5] = torch.tensor(2000, dtype=torch.int32, device=cuda)
    kw = point_map.gates(CFG.matching)
    pid, _ = k2.decode(k2.associate_cuda(*args, **kw))
    assert int(pid.max()) < 2000
    assert int((pid >= 0).sum()) > 0


def _to(state, dev):
    return type(state)(**{f.name: getattr(state, f.name).to(dev)
                          for f in dataclasses.fields(state)})


def _random_map(seed, capacity=4096, k=4, n=3000, n_ages=6):
    """A map filled to ``n`` with random payload and archive, ``last_seen``
    drawn from a few frames (heavy ties), a sixth retired, a quarter
    provisional."""
    rng = np.random.RandomState(seed)
    live = np.arange(capacity) < n
    pt = rng.randn(capacity, PT_COLS).astype(np.float32) * live[:, None]
    desc = rng.randint(-2 ** 31, 2 ** 31, (capacity * k, 8),
                       dtype=np.int64).astype(np.int32)
    desc *= np.repeat(live, k)[:, None]
    t = torch.from_numpy
    return MapState(
        pt=t(pt), desc=t(desc),
        desc_count=t((rng.randint(1, 2 * k, capacity) * live)
                     .astype(np.int32)),
        alive=t(live & (rng.rand(capacity) > 1 / 6)),
        last_seen=t((rng.randint(0, n_ages, capacity) * live)
                    .astype(np.int32)),
        prov=t(live & (rng.rand(capacity) < 0.25)),
        size=torch.tensor(n, dtype=torch.int32))


@pytest.mark.parametrize("min_free", [2048, 3072])
def test_evict_and_compact_on_cuda_match_cpu(cuda, min_free):
    """Map maintenance on the card against the CPU, exact: the stable sort
    breaks last_seen ties by slot index on both."""
    m = _random_map(min_free)
    outs = []
    for dev in ("cpu", cuda):
        ev = point_map.evict_lru(_to(m, dev), min_free)
        m2, remap = point_map.compact(ev)
        outs.append((ev.alive, m2, remap))
    (ev_c, m_c, r_c), (ev_g, m_g, r_g) = outs
    assert torch.equal(ev_g.cpu(), ev_c)
    assert int((m.alive & ~ev_c).sum()) > 0      # premise: evictions
    for f in dataclasses.fields(m_c):
        assert torch.equal(getattr(m_g, f.name).cpu(), getattr(m_c, f.name)), \
            f.name
    assert torch.equal(r_g.cpu(), r_c)
    assert int(m_c.size) == 4096 - min_free


def test_colliding_writes_on_cuda_match_cpu(cuda):
    """3072 keypoints observing 30 points, and as many position updates:
    the card keeps the last of the colliding writes, as the CPU and the
    reference do (``index_put_`` alone picks any one on CUDA, which made
    two runs of the same frames part ways)."""
    from vslam_tpu_torch.pipeline import tracker
    rng = np.random.RandomState(4)
    m = _random_map(4)
    n = 3072
    ids = torch.from_numpy(rng.randint(-1, 30, n).astype(np.int32))
    desc = torch.from_numpy(rng.randint(-2 ** 31, 2 ** 31, (n, 8),
                                        dtype=np.int64).astype(np.int32))
    valid = torch.from_numpy(rng.rand(n) < 0.9)
    xyz = torch.from_numpy(rng.randn(n, 3).astype(np.float32))
    conf = torch.from_numpy(rng.rand(n).astype(np.float32))
    update = tracker.default_map_ops(CFG, W, H).update_xyz
    outs = []
    for dev in ("cpu", cuda):
        m2 = point_map.add_observations(_to(m, dev), ids.to(dev),
                                        desc.to(dev), valid.to(dev), 7)
        outs.append(update(m2, ids.to(dev), xyz.to(dev), valid.to(dev),
                           valid.to(dev), conf.to(dev)))
    for f in dataclasses.fields(outs[0]):
        assert torch.equal(getattr(outs[1], f.name).cpu(),
                           getattr(outs[0], f.name)), f.name


def _rodrigues(w):
    th = np.linalg.norm(w)
    k = w / max(th, 1e-12)
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx


def _ba_problem(seed=0, n_cams=6, n_pts=300, k=6):
    """Cameras stepping along +z, landmarks ahead, every point seen by up to
    k cameras with 0.5 px noise; poses and points perturbed."""
    rng = np.random.RandomState(seed)
    Kc = CFG.camera.K().astype(np.float64)
    T = np.tile(np.eye(4), (n_cams, 1, 1))
    for c in range(n_cams):
        T[c, :3, :3] = _rodrigues(rng.randn(3) * 0.01)
        T[c, :3, 3] = -T[c, :3, :3] @ np.array([0.1 * c, 0.0, 0.6 * c])
    X = np.stack([rng.uniform(-6, 6, n_pts), rng.uniform(-3, 3, n_pts),
                  rng.uniform(8, 25, n_pts)], 1)
    obs_cam = np.zeros((n_pts, k), np.int32)
    obs_uv = np.zeros((n_pts, k, 2), np.float32)
    obs_mask = np.zeros((n_pts, k), bool)
    for p in range(n_pts):
        cams = np.sort(rng.choice(n_cams, rng.randint(2, k + 1),
                                  replace=False))
        for j, c in enumerate(cams):
            xc = T[c, :3, :3] @ X[p] + T[c, :3, 3]
            uv = (Kc @ (xc / xc[2]))[:2] + rng.randn(2) * 0.5
            obs_cam[p, j], obs_uv[p, j], obs_mask[p, j] = c, uv, True
    T0 = T.copy()
    T0[2:, :3, 3] += rng.randn(n_cams - 2, 3) * 0.05
    t = lambda a, dt=None: torch.from_numpy(np.asarray(a, dt))
    return ba.BAProblem(
        T_cw=t(T0, np.float32),
        cam_fixed=t(np.arange(n_cams) < 2), cam_mask=t(np.ones(n_cams, bool)),
        points=t(X + rng.randn(n_pts, 3) * 0.05, np.float32),
        point_mask=t(np.ones(n_pts, bool)), obs_cam=t(obs_cam),
        obs_uv=t(obs_uv), obs_mask=t(obs_mask))


@pytest.mark.parametrize("assembly", ["onehot", "scatter"])
def test_ba_solve_on_cuda_matches_cpu(cuda, assembly):
    """The LM solve on the card against the CPU from the same inputs: the
    scatter assembly accumulates in another order on the card, so costs are
    held to 1e-4 relative and poses to 1e-4, with equal accept flags."""
    problem = _ba_problem()
    cfg = BAConfig(iterations=8, schur_assembly=assembly)
    Kc = torch.from_numpy(CFG.camera.K())
    ps_c, st_c = ba.solve(problem, Kc, cfg)
    ps_g, st_g = ba.solve(_to(problem, cuda), Kc.to(cuda), cfg)
    assert ps_g.T_cw.is_cuda and st_g.costs.is_cuda
    assert torch.equal(st_g.accepted.cpu(), st_c.accepted)
    np.testing.assert_allclose(st_g.costs.cpu().numpy(), st_c.costs.numpy(),
                               rtol=1e-4)
    np.testing.assert_allclose(ps_g.T_cw.cpu().numpy(), ps_c.T_cw.numpy(),
                               atol=1e-4)
    assert float(st_c.final_cost) < 0.5 * float(st_c.initial_cost)


def test_wrappers_check_inputs_on_cuda(cuda):
    d = torch.zeros((4, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        k1.hamming_cuda(d, d.cpu())
    with pytest.raises(ValueError):
        k1.hamming_cuda(d.t().contiguous().t(), d)
    args = list(_scene(cuda, 3))
    args[0] = args[0].double()
    with pytest.raises(ValueError):
        k2.associate_cuda(*args, **point_map.gates(CFG.matching))


# ---- the chunked driver: one captured graph per frame ---------------------

def _chunk_scene(n, seed=2):
    from vslam_tpu_torch.datasets import synthetic
    scene = synthetic.make_scene(num_points=700, seed=seed,
                                 extent=(14, 6, 45), z_min=6.0)
    poses = synthetic.make_trajectory(n, step=0.6, yaw_rate=0.01, seed=seed)
    return np.stack(synthetic.render_sequence(CFG.camera.K(), poses, scene,
                                              W, H))


def _frame_rows(s):
    return [r for r in s.metrics.records
            if r.get("kind") == "frame" and "success" in r]


def _corridor_renderer(dev, n=12):
    """tests/test_scan_driver.py's on-device renderer case: a corridor
    scene made on ``dev`` and render_frame_device as the chunk's
    render_fn."""
    from vslam_tpu_torch.datasets import synthetic, synthetic_device
    poses = torch.from_numpy(synthetic.make_trajectory(n, step=0.6, seed=3)
                             .astype(np.float32)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    xyz, patches = synthetic_device.make_corridor_scene_device(gen, poses,
                                                               1200)
    Kd = torch.from_numpy(CFG.camera.K()).to(dev)
    render = lambda pose: synthetic_device.render_frame_device(
        xyz, patches, Kd, pose, W, H)
    return poses, render


CHUNK_CASES = {
    # uneven chunks, no BA: boundaries must not matter
    "uneven-no-ba": (17, False, (7, 5, 5)),
    # chunks aligned to keyframe_every * local_ba_every, window BA on
    "ba-aligned": (25, True, (5, 4, 4, 4, 4, 4)),
    # frames drawn inside the graph by render_frame_device
    "render-fn": (12, False, (6, 6)),
    # both front-end variants (oriented, track_carry) in the graph
    "variants": (17, False, (7, 5, 5)),
}


@pytest.mark.parametrize("case", list(CHUNK_CASES))
def test_chunk_matches_process_on_cuda(cuda, case):
    """SLAMSystem.process_chunk (captured graph, replayed per frame)
    against process on the card: equal flags and counters, equal keyframe
    counts and BA outcomes, poses to 1e-4; each kernel captured once per
    frame body and replayed once per frame."""
    from vslam_tpu_torch.pipeline import slam
    n, ba_on, sizes = CHUNK_CASES[case]
    cfg = CFG
    if case == "variants":
        cfg = CFG.replace(frontend=dataclasses.replace(
            CFG.frontend, oriented=True, track_carry=True))
    render = None
    if case == "render-fn":
        inputs, render = _corridor_renderer(cuda, n)
        frames = torch.stack([render(p) for p in inputs])
    else:
        inputs = frames = torch.from_numpy(_chunk_scene(n)).to(cuda)
    a = slam.SLAMSystem(cfg, cuda, enable_ba=ba_on)
    for f in frames:
        a.process(f)
    b = slam.SLAMSystem(cfg, cuda, enable_ba=ba_on)
    s0 = 0
    for k in sizes:
        b.process_chunk(inputs[s0:s0 + k], render_fn=render)
        s0 += k
    assert s0 == n
    ra, rb = _frame_rows(a), _frame_rows(b)
    assert len(ra) == len(rb) == n - 1
    for x, y in zip(ra, rb):
        # process logs the keyframe decision, the chunk the insert (the
        # decision and success), as the reference's two drivers do
        x = dict(x, keyframe=x["keyframe"] and x["success"])
        for k in y:
            if k not in ("t", "wall_s", "ran_ba"):
                assert x[k] == y[k], (x["frame"], k, x[k], y[k])
    np.testing.assert_allclose(b.poses(), a.poses(), atol=1e-4)
    assert int(a.kf_store.count) == int(b.kf_store.count)
    ea = [{k: v for k, v in r.items() if k not in ("t", "frame")}
          for r in a.metrics.records if r.get("kind") == "ba"]
    eb = [{k: v for k, v in r.items() if k not in ("t", "frame")}
          for r in b.metrics.records if r.get("kind") == "ba"]
    assert [e.get("skipped") for e in ea] == [e.get("skipped") for e in eb]
    assert ([e["ba_result_accepted"] for e in ea]
            == [e["ba_result_accepted"] for e in eb])
    if ba_on:
        assert ea, "premise: a BA event"
    else:
        assert sum(r["success"] for r in rb) >= n - 3
    g = b.chunk_graphs[render]
    assert g.captured_launches == {"hamming": 1, "associate": 1}
    assert g.replays == n - 1


def test_render_frame_device_on_cuda_matches_cpu(cuda):
    """render_frame_device on the card against its CPU run on the same
    arrays, with the CPU tests' tolerances against the reference: the
    no-overlap scene of tests/test_loaders.py to 2e-5 on every pixel; a
    corridor of 3000 landmarks (overlapping splats) to 2e-5 on >= 99.9% of
    the pixels of every frame (the projection's matmul rounds differently
    on the card, which moves a splat's subpixel phase by an ulp)."""
    from vslam_tpu_torch.datasets import synthetic, synthetic_device
    Kg = torch.tensor([[200.0, 0, 128], [0, 200.0, 96], [0, 0, 1]])
    gx, gy = np.meshgrid(np.linspace(-4, 4, 4), np.linspace(-2.5, 2.5, 3))
    grid = torch.from_numpy(np.stack([gx.ravel(), gy.ravel(),
                                      np.full(12, 20.0)], axis=1)
                            .astype(np.float32))
    gp = torch.from_numpy(synthetic.make_scene(num_points=12, seed=5).patches)
    gposes = torch.from_numpy(synthetic.make_trajectory(3, step=0.5, seed=5)
                              .astype(np.float32))
    poses, _ = _corridor_renderer("cpu")
    xyz, patches = synthetic_device.make_corridor_scene_device(
        torch.Generator().manual_seed(5), poses, 3000)
    Kc = torch.from_numpy(CFG.camera.K())
    for x, p, Km, ps, w, h, need in ((grid, gp, Kg, gposes, 256, 192, 1.0),
                                     (xyz, patches, Kc, poses, W, H, 0.999)):
        for pose in ps:
            want = synthetic_device.render_frame_device(x, p, Km, pose, w, h)
            got = synthetic_device.render_frame_device(
                x.to(cuda), p.to(cuda), Km.to(cuda), pose.to(cuda), w, h)
            close = ((got.cpu() - want).abs() <= 2e-5).float().mean()
            assert float(close) >= need, float(close)
            assert float((want != 0.35).float().mean()) > 0.01  # premise


def test_chunk_capture_failure_raises(cuda):
    """A frame body that reads a value back to the host cannot be
    captured: process_chunk raises and never runs the frames eagerly, and
    the system's state is left as it was."""
    from vslam_tpu_torch.pipeline import slam
    poses, render = _corridor_renderer(cuda, 6)
    syncing = lambda pose: render(pose) * float(pose[3, 3])
    s = slam.SLAMSystem(CFG, cuda, enable_ba=False)
    s.process_chunk(poses[:1], render_fn=syncing)        # bootstrap only
    before = s.state.pose.clone()
    with pytest.raises(RuntimeError):
        s.process_chunk(poses[1:], render_fn=syncing)
    assert s.frame_idx == 1 and len(_frame_rows(s)) == 0
    assert torch.equal(s.state.pose, before)
    assert s.chunk_graphs[syncing].graph is None


# ---- the front-end variants (oriented, track_carry) ------------------------

def _variant_frames(seed=3):
    from vslam_tpu_torch.datasets import synthetic
    scene = synthetic.make_scene(num_points=600, seed=seed,
                                 extent=(14, 6, 40), z_min=6.0)
    poses = synthetic.make_trajectory(2, step=0.6, seed=seed)
    return [torch.from_numpy(f) for f in synthetic.render_sequence(
        CFG.camera.K(), poses, scene, W, H)]


def test_detect_with_carry_on_cuda_matches_cpu(cuda):
    """Masks and order equal, coordinates to 2 ulps (the corner response
    is the same IEEE f32 operations on both devices)."""
    from vslam_tpu_torch.frontend import features
    fe = CFG.frontend
    f0, f1 = _variant_frames()
    uv0, _, ok0 = features.detect(f0, fe, H, W)
    carry = uv0 + torch.tensor([1.0, 0.5])
    want = features.detect_with_carry(f1, fe, H, W, carry, ok0)
    got = [t.cpu() for t in features.detect_with_carry(
        f1.to(cuda), fe, H, W, carry.to(cuda), ok0.to(cuda))]
    mask = want[2].numpy()
    assert torch.equal(got[2], want[2]) and mask.sum() > 100
    w = want[0].numpy()[mask]
    assert (np.abs(got[0].numpy()[mask] - w)
            <= 2 * np.spacing(np.abs(w))).all()


def test_orientation_map_on_cuda_matches_cpu(cuda):
    """The moments are bit-equal (the same shift-MAC sums); the angles
    differ by atan2's ulps: 1e-5 rad where |m| > 1e-2."""
    from vslam_tpu_torch.frontend import descriptors, features
    fe = CFG.frontend
    blur = features.gaussian_blur(_variant_frames()[1], fe.blur_sigma)
    m01, m10 = descriptors.centroid_moments(blur, fe.patch_radius)
    g01, g10 = (t.cpu() for t in descriptors.centroid_moments(
        blur.to(cuda), fe.patch_radius))
    assert torch.equal(g01, m01) and torch.equal(g10, m10)
    want = descriptors.orientation_map(blur, fe.patch_radius)
    got = descriptors.orientation_map(blur.to(cuda), fe.patch_radius).cpu()
    d = (torch.remainder(got - want + np.pi, 2 * np.pi) - np.pi).abs()
    assert float(d[torch.hypot(m01, m10) > 1e-2].max()) <= 1e-5


def test_describe_on_cuda_matches_cpu(cuda):
    """Steered BRIEF with one angle tensor on both devices: bits equal
    except at rounding ties (torch_scenes.describe_ties, 5e-6 px + 1 ulp)
    that can flip them."""
    from vslam_tpu_torch.frontend import descriptors, features
    fe = CFG.frontend
    blur = features.gaussian_blur(_variant_frames()[1], fe.blur_sigma)
    rng = np.random.RandomState(5)
    uv = torch.from_numpy(rng.uniform(0, [W, H], (512, 2))
                          .astype(np.float32))
    angle = torch.from_numpy(rng.uniform(-np.pi, np.pi, 512)
                             .astype(np.float32))
    angle[:5] = torch.tensor([0.0, np.pi / 2, -np.pi / 2, np.pi, -np.pi])
    want = descriptors.unpack_bits(descriptors.describe(blur, uv, angle, fe))
    got = descriptors.unpack_bits(descriptors.describe(
        blur.to(cuda), uv.to(cuda), angle.to(cuda), fe)).cpu()
    _, live = scenes.describe_ties(
        blur.numpy(), uv.numpy(), angle.numpy(),
        descriptors.brief_pattern(fe.descriptor_bits, fe.patch_radius),
        5e-6)
    assert not ((got != want).numpy() & ~live).any()


@pytest.mark.parametrize("n1,n2", [(3072, 3072), (17, 9), (1, 129)])
def test_hamming_matmul_on_cuda_matches_k1(cuda, n1, n2):
    """The f16 bit-plane GEMM is exact (0/1 operands, partial sums <= 256)
    and equals K1, also at all-zero / all-one rows."""
    from vslam_tpu_torch.matching import hamming
    rng = np.random.RandomState(n1 + n2)
    d1, d2 = _desc(rng, n1).to(cuda), _desc(rng, n2).to(cuda)
    d1[0], d2[-1] = 0, -1
    got = hamming.hamming_matmul(d1, d2)
    assert got.dtype == torch.int32
    assert torch.equal(got, k1.hamming_cuda(d1, d2))
