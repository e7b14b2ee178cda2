"""The port's CUDA kernels against their plain torch versions, on a card.

Every test here is marked ``gpu`` and skips without a CUDA device. The
module imports no jax (the GPU machine has none); run it there without the
repository's conftest, which imports jax:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

The plain versions are held to the JAX reference on the CPU by
tests/test_torch_kernels.py; here the kernels are held to the plain
versions, exactly, on the same device tensors.
"""
import numpy as np
import pytest
import torch

from vslam_tpu_torch.config import small_config
from vslam_tpu_torch.core import camera as cam
from vslam_tpu_torch.core.types import empty_map
from vslam_tpu_torch.mapping import point_map
from vslam_tpu_torch.ops import associate as k2
from vslam_tpu_torch.ops import hamming as k1

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
                                   (257, 1)])
def test_k1_kernel_matches_plain(cuda, n1, n2):
    rng = np.random.RandomState(n1 + n2)
    d1, d2 = _desc(rng, n1).to(cuda), _desc(rng, n2).to(cuda)
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


def test_k2_skips_chunks_past_the_cursor(cuda):
    """Chunks that start past the insert cursor exit without reading the
    map: with ``size`` forced below points that are alive (a state the map
    functions never produce), those points are never associated."""
    args = list(_scene(cuda, 2, capacity=8192))
    args[5] = torch.tensor(2048, dtype=torch.int32, device=cuda)
    kw = point_map.gates(CFG.matching)
    pid, _ = k2.decode(k2.associate_cuda(*args, **kw))
    # the kernel's chunks are 2048 points: only chunk 0 starts below size
    assert int(pid.max()) < 2048
    assert int((pid >= 0).sum()) > 0


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
