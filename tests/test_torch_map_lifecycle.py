"""Map maintenance in the port: evict_lru, compact, remap_ids.

The same numpy-seeded map goes through the reference and the port, with
``last_seen`` drawn from a handful of frames so that eviction order rests
on ties (the reference breaks them by slot index). Every output is
integer or a moved copy of a payload row, so every comparison is exact.
The last test runs maintenance inside ``process_chunk`` against the
reference's per-frame driver.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vslam_tpu.core.types import empty_map as jempty_map
from vslam_tpu.mapping import point_map as jpm
from vslam_tpu_torch import interop
from vslam_tpu_torch.core.types import MapState, empty_map
from vslam_tpu_torch.mapping import point_map

torch.set_num_threads(2)


def _ref_map(seed, capacity=256, k=3, n=200, n_ages=4):
    """A reference map: n inserted points (random payload), a second and
    third observation on some, ages drawn from n_ages frames (heavy ties),
    a sixth retired, a quarter provisional."""
    rng = np.random.RandomState(seed)
    m = jempty_map(capacity, k)
    desc = lambda b: jnp.asarray(rng.randint(0, 2 ** 32, (b, 8),
                                             dtype=np.uint64)
                                 .astype(np.uint32))
    f32 = lambda *s: jnp.asarray(rng.randn(*s).astype(np.float32))
    m = jpm.insert_points(m, f32(n, 3), f32(n, 3), desc(n),
                          jnp.ones(n, bool), frame_idx=0,
                          provisional=jnp.asarray(rng.rand(n) < 0.25),
                          first_uv=f32(n, 2), first_P=f32(n, 3, 4),
                          first_C=f32(n, 3), conf=f32(n))
    for _ in range(2):
        ids = rng.choice(n, n // 2, replace=False).astype(np.int32)
        m = jpm.add_observations(m, jnp.asarray(ids), desc(len(ids)),
                                 jnp.ones(len(ids), bool), frame_idx=1)
    last = np.zeros(capacity, np.int32)
    last[:n] = rng.randint(0, n_ages, n)
    alive = np.asarray(m.alive) & ~(rng.rand(capacity) < 1 / 6)
    return m.replace(last_seen=jnp.asarray(last), alive=jnp.asarray(alive))


def _np_tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


def _assert_map_equal(port: MapState, ref):
    want = _np_tree(ref)
    got = interop.to_numpy(port)
    for f in ("pt", "desc", "desc_count", "alive", "last_seen", "prov",
              "size"):
        np.testing.assert_array_equal(got[f], getattr(want, f), err_msg=f)


@pytest.mark.parametrize("seed,min_free", [(0, 100), (1, 180), (2, 10),
                                           (3, 256)])
def test_evict_lru_matches_reference(seed, min_free):
    ref = _ref_map(seed)
    want = jpm.evict_lru(ref, min_free)
    got = point_map.evict_lru(interop.from_jax(_np_tree(ref), MapState),
                              min_free)
    _assert_map_equal(got, want)
    # the premise: some (all, at min_free = capacity) alive points go,
    # and ties in last_seen decide which
    n_dead = int((np.asarray(ref.alive) & ~np.asarray(want.alive)).sum())
    if min_free > 10:
        assert 0 < n_dead <= int(np.asarray(ref.alive).sum())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compact_and_remap_match_reference(seed):
    ref = jpm.evict_lru(_ref_map(seed), 120)
    m2j, remap_j = jpm.compact(ref)
    m2, remap = point_map.compact(interop.from_jax(_np_tree(ref), MapState))
    _assert_map_equal(m2, m2j)
    np.testing.assert_array_equal(remap.numpy(), np.asarray(remap_j))
    assert remap.dtype == torch.int32
    # id holders of both shapes the pipeline remaps: tracker (N,) and
    # keyframe observations (R, N), with -1 and retired ids among them
    rng = np.random.RandomState(seed)
    for shape in ((64,), (5, 40)):
        ids = rng.randint(-1, ref.capacity, shape).astype(np.int32)
        want = np.asarray(jpm.remap_ids(jnp.asarray(ids), remap_j))
        got = point_map.remap_ids(torch.from_numpy(ids), remap)
        np.testing.assert_array_equal(got.numpy(), want)
        assert (want == -1).any() and (want >= 0).any()


def test_maintenance_on_a_full_map():
    """Cursor at capacity (inserts would now drop): evict + compact frees
    exactly the slots asked for, identically in both."""
    ref = _ref_map(5, capacity=128, n=128, n_ages=3)
    assert int(ref.size) == ref.capacity
    m2j, _ = jpm.compact(jpm.evict_lru(ref, 48))
    m2, _ = point_map.compact(point_map.evict_lru(
        interop.from_jax(_np_tree(ref), MapState), 48))
    _assert_map_equal(m2, m2j)
    assert int(m2.size) == 128 - 48


def test_churn_inserts_survive_past_capacity():
    """tests/test_map_lifecycle.py's churn case on the port: 8x capacity
    of inserts with periodic maintenance, every batch lands in full."""
    C, B = 128, 32
    rng = np.random.RandomState(1)
    m = empty_map(C, 2, "cpu")
    total_inserted = 0
    for step in range(32):
        xyz = torch.from_numpy(rng.randn(B, 3).astype(np.float32))
        desc = torch.from_numpy(rng.randint(0, 2 ** 32, (B, 8),
                                            dtype=np.uint64)
                                .astype(np.uint32).view(np.int32))
        before = int(m.size)
        m = point_map.insert_points(m, xyz, torch.zeros((B, 3)), desc,
                                    torch.ones(B, dtype=torch.bool),
                                    frame_idx=step)
        assert int(m.size) - before == B, f"dropped inserts at step {step}"
        total_inserted += B
        if int(m.size) >= int(0.75 * C):
            m = point_map.evict_lru(m, min_free=C // 2)
            m, _ = point_map.compact(m)
    assert total_inserted == 1024
    assert int(m.size) <= C


@pytest.mark.parametrize("n_obs", [40, 3072])
def test_colliding_observations_keep_the_last(n_obs):
    """Many keypoints observing few points: of the colliding descriptor
    writes the last one stays, as in the reference's scatter
    (``index_put_`` alone leaves the winner unspecified on CUDA;
    tests/test_torch_gpu.py holds the card to this CPU result)."""
    rng = np.random.RandomState(n_obs)
    ref = _ref_map(3)
    ids = rng.randint(-1, 30, n_obs).astype(np.int32)
    desc = rng.randint(0, 2 ** 32, (n_obs, 8), dtype=np.uint64) \
        .astype(np.uint32)
    valid = rng.rand(n_obs) < 0.9
    want = jpm.add_observations(ref, jnp.asarray(ids), jnp.asarray(desc),
                                jnp.asarray(valid), frame_idx=7)
    got = point_map.add_observations(
        interop.from_jax(_np_tree(ref), MapState), torch.from_numpy(ids),
        torch.from_numpy(desc.view(np.int32)), torch.from_numpy(valid),
        frame_idx=7)
    _assert_map_equal(got, want)


def test_chunk_maintenance_matches_reference():
    """The port's ``process_chunk`` at capacity 512 (high-water 256), with
    the reference's RANSAC samples injected, against the reference's
    per-frame ``process``: maintenance runs inside the chunks at the frames
    where the reference runs it, no insert is dropped, decisions are equal,
    inlier counts and map sizes within +-2, poses to 1e-3."""
    from tests import test_torch_scan_driver as chunk
    from vslam_tpu.config import MapConfig as JMapConfig
    from vslam_tpu.config import small_config as jsmall
    from vslam_tpu.pipeline import slam as jslam
    from vslam_tpu_torch.config import MapConfig

    frames = chunk._scene(24)
    ref = jslam.SLAMSystem(jsmall().replace(map=JMapConfig(
        capacity=512, obs_per_point=4, block_size=32)), enable_ba=False)
    for f in frames:
        ref.process(f)
    port = chunk._injected_chunk(chunk.CFG.replace(map=MapConfig(
        capacity=512, obs_per_point=4, block_size=32)), frames,
        (9, 8, 7), False)
    chunk.assert_chunk_matches_reference(ref, port)
    assert port["maintenance_runs"] == ref.maintenance_runs >= 2  # premise
    assert port["dropped"] == ref.dropped_inserts_total == 0
