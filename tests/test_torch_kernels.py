"""The port's two hand kernels (vslam_tpu_torch.ops) against the reference.

On the CPU each wrapper runs its plain torch version; these tests hold that
version, bit for bit, to the JAX reference and to the Pallas kernel it
replaces (run in interpret mode, as tests/test_pallas.py runs it).
tests/test_torch_gpu.py holds each CUDA kernel to its plain version on a
card. Inputs come from numpy seeds and go through both frameworks.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_scenes as scenes

from vslam_tpu.config import small_config
from vslam_tpu.core import camera as jcam
from vslam_tpu.core.types import PT_COLS
from vslam_tpu.core.types import empty_map as jempty_map
from vslam_tpu.mapping import point_map as jpm
from vslam_tpu.matching import hamming as jhamming
from vslam_tpu.matching import matcher as jmatcher
from vslam_tpu.ops import pallas_associate, pallas_hamming
from vslam_tpu_torch import interop
from vslam_tpu_torch.core.types import MapState
from vslam_tpu_torch.mapping import point_map
from vslam_tpu_torch.matching import hamming as thamming
from vslam_tpu_torch.matching import matcher
from vslam_tpu_torch.ops import hamming as k1

torch.set_num_threads(2)

CFG = small_config()
W, H = CFG.camera.width, CFG.camera.height


def _desc(rng, n):
    return rng.randint(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(np.uint32)


def _t(a):
    a = np.array(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a)


# ---- K1: Hamming distance matrix ------------------------------------------

@pytest.mark.parametrize("n1,n2", [(256, 512), (100, 300), (1, 7)])
def test_k1_plain_matches_popcount_oracle(n1, n2):
    rng = np.random.RandomState(n1 + n2)
    d1, d2 = _desc(rng, n1), _desc(rng, n2)
    want = np.asarray(jhamming.hamming_popcount(jnp.asarray(d1),
                                                jnp.asarray(d2)))
    got = k1.hamming_cuda(_t(d1), _t(d2))          # CPU: plain version
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        thamming.hamming_popcount(_t(d1), _t(d2)).numpy(), want)


def test_k1_plain_matches_pallas_kernel():
    rng = np.random.RandomState(0)
    d1, d2 = _desc(rng, 256), _desc(rng, 512)
    want = np.asarray(pallas_hamming.hamming_pallas_interpret(
        jnp.asarray(d1), jnp.asarray(d2)))
    np.testing.assert_array_equal(k1.hamming_plain(_t(d1), _t(d2)).numpy(),
                                  want)
    # ragged shapes: the reference pads to its 256 tiles, the port masks
    d1, d2 = _desc(rng, 100), _desc(rng, 300)
    want = np.asarray(pallas_hamming.hamming(jnp.asarray(d1),
                                             jnp.asarray(d2)))
    np.testing.assert_array_equal(k1.hamming_plain(_t(d1), _t(d2)).numpy(),
                                  want)


@pytest.mark.parametrize("name", scenes.K1_SCENES)
def test_k1_plain_on_adversarial_descriptors(name):
    """All-zero against all-ones rows (d = 0 and 256) and one-hot e_i
    against e_j (d = 0 or 2): the plain version against the popcount oracle
    and the Pallas kernel (interpreted, padded to its 256 tiles)."""
    d1, d2 = scenes.k1_scene(name)
    j1, j2 = jnp.asarray(d1.view(np.uint32)), jnp.asarray(d2.view(np.uint32))
    want = np.asarray(jhamming.hamming_popcount(j1, j2))
    assert set(np.unique(want)) == ({0, 256} if name == "zeros_ones"
                                    else {0, 2})
    np.testing.assert_array_equal(k1.hamming_plain(_t(d1), _t(d2)).numpy(),
                                  want)
    np.testing.assert_array_equal(np.asarray(pallas_hamming.hamming(j1, j2)),
                                  want)


def test_match_matches_reference():
    """matcher.match (distance matrix from K1) vs the reference's match,
    guided and unguided: idx2, mask and distance bit-exact."""
    rng = np.random.RandomState(2)
    n = 256
    d1, d2 = _desc(rng, n), _desc(rng, n)
    # near-duplicates so the ratio test and cross-check have work to do
    d2[:128] = d1[:128] ^ (rng.rand(128, 8) < 0.04).astype(np.uint32)
    m1, m2 = rng.rand(n) > 0.1, rng.rand(n) > 0.1
    uv1 = rng.uniform(0, 200, (n, 2)).astype(np.float32)
    uv2 = (uv1 + rng.randn(n, 2) * 8).astype(np.float32)
    for kw in ({}, {"uv1": uv1, "uv2": uv2}):
        want = jmatcher.match(jnp.asarray(d1), jnp.asarray(m1),
                              jnp.asarray(d2), jnp.asarray(m2), CFG.matching,
                              **{k: jnp.asarray(v) for k, v in kw.items()})
        got = matcher.match(_t(d1), _t(m1), _t(d2), _t(m2), CFG.matching,
                            **{k: _t(v) for k, v in kw.items()})
        np.testing.assert_array_equal(got.idx2.numpy(),
                                      np.asarray(want.idx2))
        np.testing.assert_array_equal(got.mask.numpy(),
                                      np.asarray(want.mask))
        np.testing.assert_array_equal(got.distance.numpy(),
                                      np.asarray(want.distance))
        assert np.asarray(want.mask).sum() > 20


# ---- K2: search-by-projection association ---------------------------------

def _flip(rng, d, n_bits):
    bits = np.unpackbits(d.view(np.uint8), bitorder="little")
    bits[rng.choice(256, n_bits, replace=False)] ^= 1
    return np.packbits(bits, bitorder="little").view(np.uint32)


def _assoc_scene(seed=0, n_pts=600, n_kp=128, capacity=1024, obs=True):
    """A map with random descriptors (some points with extra archive
    slots), keypoints planted near projections with 0..110 flipped bits,
    random recency: exercises the strict tier, the 64-96 reacq band and
    the misses. Built with the reference's own map functions."""
    rng = np.random.RandomState(seed)
    K = jnp.asarray(CFG.camera.K())
    xyz = np.stack([rng.uniform(-8, 8, n_pts), rng.uniform(-6, 6, n_pts),
                    rng.uniform(4, 30, n_pts)], 1).astype(np.float32)
    desc = _desc(rng, n_pts)
    m = jempty_map(capacity, CFG.map.obs_per_point)
    m = jpm.insert_points(m, jnp.asarray(xyz), jnp.zeros((n_pts, 3)),
                          jnp.asarray(desc), jnp.ones(n_pts, bool))
    if obs:
        ids = rng.choice(n_pts, n_pts // 3, replace=False).astype(np.int32)
        for _ in range(2):
            m = jpm.add_observations(m, jnp.asarray(ids),
                                     jnp.asarray(_desc(rng, len(ids))),
                                     jnp.ones(len(ids), bool), 3)
    last = rng.randint(0, 12, n_pts)
    m = m.replace(last_seen=m.last_seen.at[:n_pts].set(jnp.asarray(last)))
    P = jcam.projection_matrix(K, jnp.eye(4))
    proj = xyz @ np.asarray(P[:, :3]).T + np.asarray(P[:, 3])
    uv_all = proj[:, :2] / proj[:, 2:3]
    sel = rng.choice(n_pts, n_kp, replace=False)
    kp_uv = (uv_all[sel] + rng.randn(n_kp, 2) * 3.0).astype(np.float32)
    archive = np.asarray(m.desc)
    kp_desc = np.stack([
        _flip(rng, archive[sel[i] * CFG.map.obs_per_point], rng.randint(110))
        for i in range(n_kp)])
    free = rng.rand(n_kp) < 0.9
    return m, P, kp_uv, kp_desc, free, 12


@pytest.mark.parametrize("seed", [0, 1])
def test_k2_plain_matches_xla_and_pallas(seed):
    """associate (K2's plain version on the CPU) vs the reference's XLA
    path and its fused Pallas kernel: ids and distances bit-exact, with
    hits in the strict tier and in the 64-96 reacq band."""
    m, P, kp_uv, kp_desc, free, frame = _assoc_scene(seed)
    mcfg = dataclasses.replace(CFG.map, capacity=1024, block_size=128)
    args = (jnp.asarray(kp_uv), jnp.asarray(kp_desc), jnp.asarray(free))
    fi = jnp.asarray(frame, jnp.int32)
    want = jpm.associate(m, P, *args, mcfg, CFG.matching, W, H, frame_idx=fi)
    fused = pallas_associate.associate_fused(
        m, P, *args, mcfg, CFG.matching, W, H, frame_idx=fi, interpret=True)
    tm = interop.from_jax(jax.tree_util.tree_map(np.asarray, m), MapState)
    got = point_map.associate(tm, _t(P), _t(kp_uv), _t(kp_desc), _t(free),
                              mcfg, CFG.matching, W, H,
                              frame_idx=torch.tensor(frame, dtype=torch.int32))
    pid = np.asarray(want.point_id)
    np.testing.assert_array_equal(got.point_id.numpy(), pid)
    np.testing.assert_array_equal(np.asarray(fused[0]), pid)
    hit = pid >= 0
    np.testing.assert_array_equal(got.distance.numpy()[hit],
                                  np.asarray(want.distance)[hit])
    d = np.asarray(want.distance)[hit]
    assert (d < CFG.matching.hamming_max).any()
    assert ((d >= CFG.matching.hamming_max)
            & (d < CFG.matching.reacq_hamming_max)).any(), \
        "scenario never exercised the reacq band"


def test_k2_without_reacq_tier():
    m, P, kp_uv, kp_desc, free, _ = _assoc_scene(3, obs=False)
    mcfg = dataclasses.replace(CFG.map, capacity=1024, block_size=256)
    want = jpm.associate(m, P, jnp.asarray(kp_uv), jnp.asarray(kp_desc),
                         jnp.asarray(free), mcfg, CFG.matching, W, H)
    tm = interop.from_jax(jax.tree_util.tree_map(np.asarray, m), MapState)
    got = point_map.associate(tm, _t(P), _t(kp_uv), _t(kp_desc), _t(free),
                              mcfg, CFG.matching, W, H)
    np.testing.assert_array_equal(got.point_id.numpy(),
                                  np.asarray(want.point_id))
    assert (np.asarray(want.point_id) >= 0).sum() > 5


def _scene_map(sc):
    """A K2 scene's map as the reference's MapState: point (u, v, 1)."""
    C = len(sc["alive"])
    pt = np.zeros((C, PT_COLS), np.float32)
    pt[:, :2] = sc["pix"]
    pt[:, 2] = 1.0
    return jempty_map(C, sc["desc"].shape[0] // C).replace(
        pt=jnp.asarray(pt), desc=jnp.asarray(sc["desc"].view(np.uint32)),
        desc_count=jnp.asarray(sc["dcount"]), alive=jnp.asarray(sc["alive"]),
        last_seen=jnp.asarray(sc["last_seen"]),
        size=jnp.asarray(sc["size"], jnp.int32))


@pytest.mark.parametrize("name", scenes.K2_SCENES)
def test_k2_plain_on_adversarial_scenes(name):
    """associate (K2's plain version on the CPU) against the reference's
    XLA path on a dense cluster, ties across ids and slots, and points on
    the gates' boundaries, seen through P = [I | 0]: ids and distances
    bit-exact, and the outcomes each scene was built to force."""
    g = CFG.matching
    sc = scenes.k2_scene(name, K=CFG.map.obs_per_point, r=g.search_radius,
                         rq=g.reacq_radius, hmax=g.hamming_max,
                         rq_hmax=g.reacq_hamming_max,
                         max_age=g.reacq_max_age)
    m = _scene_map(sc)
    mcfg = dataclasses.replace(CFG.map, capacity=m.capacity)
    P = np.eye(3, 4, dtype=np.float32)
    want = jpm.associate(m, jnp.asarray(P), jnp.asarray(sc["kp_uv"]),
                         jnp.asarray(sc["kp_desc"].view(np.uint32)),
                         jnp.asarray(sc["kp_free"]), mcfg, g, scenes.W,
                         scenes.H,
                         frame_idx=jnp.asarray(sc["frame"], jnp.int32))
    tm = interop.from_jax(jax.tree_util.tree_map(np.asarray, m), MapState)
    got = point_map.associate(
        tm, _t(P), _t(sc["kp_uv"]), _t(sc["kp_desc"]), _t(sc["kp_free"]),
        mcfg, g, scenes.W, scenes.H,
        frame_idx=torch.tensor(sc["frame"], dtype=torch.int32))
    pid, dist = np.asarray(want.point_id), np.asarray(want.distance)
    np.testing.assert_array_equal(got.point_id.numpy(), pid)
    hit = pid >= 0
    np.testing.assert_array_equal(got.distance.numpy()[hit], dist[hit])
    scenes.check_expect(sc, pid, dist)
    assert hit.sum() >= 40


def test_map_updates_match_reference():
    """insert_points / add_observations / cull_stale (the map writes of the
    tracking step, incl. dropped rows past capacity) leave the same state."""
    rng = np.random.RandomState(5)
    C, B = 64, 40
    jm = jempty_map(C, 3)
    tm = interop.from_jax(jax.tree_util.tree_map(np.asarray, jm), MapState)
    for frame in range(3):                    # the third insert overflows
        xyz = rng.randn(B, 3).astype(np.float32)
        desc = _desc(rng, B)
        valid = rng.rand(B) < 0.7
        prov = rng.rand(B) < 0.5
        conf = rng.rand(B).astype(np.float32)
        jm = jpm.insert_points(jm, jnp.asarray(xyz), jnp.zeros((B, 3)),
                               jnp.asarray(desc), jnp.asarray(valid), frame,
                               jnp.asarray(prov), conf=jnp.asarray(conf))
        tm = point_map.insert_points(tm, _t(xyz), torch.zeros(B, 3),
                                     _t(desc), _t(valid),
                                     torch.tensor(frame, dtype=torch.int32),
                                     _t(prov), conf=_t(conf))
        ids = rng.randint(-1, C, B).astype(np.int32)
        ok = rng.rand(B) < 0.8
        od = _desc(rng, B)
        # duplicate ids would race on the archive slot in both frameworks
        ids = _unique_or_neg(ids)
        jm = jpm.add_observations(jm, jnp.asarray(ids), jnp.asarray(od),
                                  jnp.asarray(ok), frame + 40)
        tm = point_map.add_observations(
            tm, _t(ids), _t(od), _t(ok),
            torch.tensor(frame + 40, dtype=torch.int32))
    jm = jpm.cull_stale(jm, 200)
    tm = point_map.cull_stale(tm, torch.tensor(200, dtype=torch.int32))
    want = jax.tree_util.tree_map(np.asarray, jm)
    got = interop.to_numpy(tm)
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(got[f.name], getattr(want, f.name),
                                      err_msg=f.name)
    assert int(want.size) == C and not want.alive.all()


def _unique_or_neg(ids):
    """Keep the first occurrence of each id, -1 for repeats."""
    out = ids.copy()
    seen = set()
    for i, v in enumerate(ids):
        if v in seen:
            out[i] = -1
        seen.add(v)
    return out


def test_wrappers_refuse_other_devices():
    """No fallback: a non-CPU tensor either launches a kernel or raises."""
    d = torch.zeros((4, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        k1.hamming_cuda(d, d)
    with pytest.raises(ValueError):
        k1.hamming_cuda(torch.zeros((4, 8), dtype=torch.int64),
                        torch.zeros((4, 8), dtype=torch.int64))
