"""Inputs, references and the spawned groups of the port's sharded checks.

Shared by tests/test_torch_parallel.py, tests/test_torch_sharded_tracking.py
and tests/test_torch_multi_sequence.py. ``results(tmp_path_factory)``
builds every input from seeds (the reference's maps, RANSAC sample batches
and BA problems as numpy, and tests/torch_frozen.py's ``process`` case),
starts two groups of the port
(``torch_dist.group_worker`` at D = 2, joined through
``multihost.initialize`` from torchrun's environment variables, and at
D = 4), computes the references while they run (the JAX package on the
8-device virtual CPU mesh of tests/conftest.py, and the port's
single-device runs, with one thread as the ranks have), and joins the
groups. It runs once per pytest run (``torch_dist.shared``), so the suite
spawns these two groups once whatever the number of test files asking.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import torch

import tests.test_parallel as jpar
from tests import torch_dist, torch_frozen
from tests.test_ba import K as BA_K
from tests.test_ba import _make_problem
from tests.test_geometry import _two_view_setup
from vslam_tpu.config import BAConfig as JBAConfig
from vslam_tpu.config import MapConfig as JMapConfig
from vslam_tpu.config import VSLAMConfig as JVSLAMConfig
from vslam_tpu.config import small_config as jsmall
from vslam_tpu.geometry import ransac as jransac
from vslam_tpu.mapping import point_map as jpoint_map
from vslam_tpu.optimizer import ba as jba
from vslam_tpu.parallel import mesh as jmesh
from vslam_tpu.parallel import sharded_ba as jsharded_ba
from vslam_tpu.parallel import sharded_map as jsharded_map
from vslam_tpu.pipeline import slam as jslam
from vslam_tpu.pipeline import tracker as jtracker
from vslam_tpu_torch import interop
from vslam_tpu_torch.config import BAConfig, MapConfig, VSLAMConfig
from vslam_tpu_torch.config import small_config
from vslam_tpu_torch.datasets import synthetic
from vslam_tpu_torch.frontend.frame import extract_features
from vslam_tpu_torch.geometry import ransac
from vslam_tpu_torch.matching import matcher
from vslam_tpu_torch.optimizer import ba

SEED = 2                  # the SLAM systems' seed (reference key and port)
W_ASSOC, H_ASSOC = 640, 480


def _np_tree(x):
    """A reference dataclass as a dict of numpy leaves (picklable without
    jax, for the spawned ranks)."""
    return {f.name: np.asarray(getattr(x, f.name))
            for f in dataclasses.fields(x)}


def _i32(a):
    return np.asarray(a).view(np.int32)


def slam_frames(n, seed):
    """tests/test_sharded_tracking.py's scene and trajectory."""
    cfg = small_config()
    scene = synthetic.make_scene(num_points=700, seed=seed,
                                 extent=(14, 6, 40), z_min=6.0)
    poses = synthetic.make_trajectory(n, step=0.6, seed=seed)
    return np.stack(synthetic.render_sequence(
        cfg.camera.K(), poses, scene, cfg.camera.width, cfg.camera.height))


def _assoc_case():
    """tests/test_parallel.py's association scene (capacity 1024, block 64,
    256 keypoints, 5% dead slots)."""
    m, xyz, desc, rng = jpar.TestShardedMap._populated_map(None)
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)
    P_mat = np.hstack([K, np.zeros((3, 1), np.float32)])
    n_kp = 256
    sel = rng.choice(700, n_kp, replace=False)
    uvw = np.hstack([xyz[sel], np.ones((n_kp, 1), np.float32)]) @ P_mat.T
    kp_uv = (uvw[:, :2] / uvw[:, 2:3]
             + rng.randn(n_kp, 2) * 0.5).astype(np.float32)
    kp_desc = desc[sel].copy()
    kp_desc[:, 0] ^= 1
    kp_free = np.ones(n_kp, bool)
    kp_free[::7] = False
    cfg = VSLAMConfig(map=MapConfig(capacity=1024, obs_per_point=2,
                                    block_size=64))
    return m, dict(map=_np_tree(m), P=P_mat, kp_uv=kp_uv,
                   kp_desc=_i32(kp_desc), kp_free=kp_free, cfg=cfg.to_json(),
                   W=W_ASSOC, H=H_ASSOC), kp_desc


def _mapops_case():
    """Inputs of one insert (crossing the shard boundaries and overflowing
    the capacity), observe, update_xyz (with colliding ids) and cull."""
    rng = np.random.RandomState(5)
    B, N, C = 400, 256, 1024
    f32 = lambda *s: rng.randn(*s).astype(np.float32)
    upd_valid = rng.rand(N) < 0.5
    return dict(
        xyz=f32(B, 3), color=rng.rand(B, 3).astype(np.float32),
        desc=rng.randint(0, 2 ** 32, (B, 8), dtype=np.uint32),
        valid=rng.rand(B) < 0.85, frame_ins=np.int32(5),
        prov=rng.rand(B) < 0.3, first_uv=f32(B, 2), first_P=f32(B, 3, 4),
        first_C=f32(B, 3), conf=rng.rand(B).astype(np.float32),
        obs_ids=rng.randint(-1, C, N).astype(np.int32),
        obs_desc=rng.randint(0, 2 ** 32, (N, 8), dtype=np.uint32),
        obs_valid=rng.rand(N) < 0.8, frame_obs=np.int32(10),
        upd_ids=rng.randint(-1, C, N).astype(np.int32), upd_xyz=f32(N, 3),
        upd_valid=upd_valid, upd_promote=upd_valid & (rng.rand(N) < 0.5),
        upd_conf=rng.rand(N).astype(np.float32), frame_cull=np.int32(36))


def _mapops_reference(m, mo):
    """The same operations through the reference's single-device
    ``default_map_ops``."""
    cfg = jsmall().replace(map=JMapConfig(capacity=1024, obs_per_point=2,
                                          block_size=64))
    ops = jtracker.default_map_ops(cfg, W_ASSOC, H_ASSOC)
    j = {k: jnp.asarray(v) for k, v in mo.items()}
    m = ops.insert(m, j["xyz"], j["color"], j["desc"], j["valid"],
                   j["frame_ins"], j["prov"], j["first_uv"], j["first_P"],
                   j["first_C"], j["conf"])
    m = ops.observe(m, j["obs_ids"], j["obs_desc"], j["obs_valid"],
                    j["frame_obs"])
    m = ops.update_xyz(m, j["upd_ids"], j["upd_xyz"], j["upd_valid"],
                       j["upd_promote"], j["upd_conf"])
    rows = np.asarray(ops.gather_pt(m, j["upd_ids"]))
    prov = np.asarray(ops.gather_prov(m, j["upd_ids"]))
    m = ops.cull(m, j["frame_cull"])
    return dict(map=_np_tree(m), alive=int(ops.alive_count(m)), rows=rows,
                prov=prov)


def _slam_case(frames, cfg):
    """Per frame, the reference's RANSAC batch (key fold_in(PRNGKey(SEED),
    i), as the reference tracker draws it) for the frame's match mask,
    which depends only on the images (track_carry off)."""
    H, W = cfg.camera.height, cfg.camera.width
    feats = [extract_features(torch.from_numpy(f), cfg.frontend, H, W)
             for f in frames]
    masks, samples = [None], [None]
    for i in range(1, len(frames)):
        a, b = feats[i - 1], feats[i]
        mask = matcher.match(a.desc, a.mask, b.desc, b.mask, cfg.matching,
                             uv1=a.uv, uv2=b.uv).mask.numpy()
        key = jax.random.fold_in(jax.random.PRNGKey(SEED), i)
        masks.append(mask)
        samples.append(np.asarray(jransac.sample_minimal_sets(
            key, jnp.asarray(mask, jnp.float32),
            cfg.ransac.num_hypotheses, 8)))
    return masks, samples


def _reference_slam(frames):
    s = jslam.SLAMSystem(jsmall(), seed=SEED, enable_ba=True)
    infos = [s.process(f) for f in frames]
    return dict(poses=s.poses(), infos=infos)


def _compute():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with ThreadPoolExecutor(2) as pool:
            return _compute_all(pool)
    finally:
        torch.set_num_threads(threads)


def _compute_all(pool):
    jmap, assoc, kp_desc_u32 = _assoc_case()
    mapops = _mapops_case()

    K2v, _, _, uv1, uv2, vis, _, _ = _two_view_setup(noise=0.3,
                                                     outlier_frac=0.3)
    key = jax.random.PRNGKey(3)
    idx = np.asarray(jransac.sample_minimal_sets(
        key, jnp.asarray(vis, jnp.float32), 512, 8))
    rs = dict(uv1=uv1, uv2=uv2, vis=vis, K=K2v, idx=idx)
    _, _, _, fu1, fu2, fvis, _, f_out = _two_view_setup(noise=0.3,
                                                        outlier_frac=0.4)
    fund = dict(uv1=fu1, uv2=fu2, vis=fvis)

    problem = _make_problem(n_points=256, noise_px=0.3)[0]
    bac = dict(problem=_np_tree(problem), K=BA_K)

    cfg = small_config()
    frames = slam_frames(12, seed=11)
    masks, samples = _slam_case(frames, cfg)
    # the checkpoint is saved after keyframe 3, before window BA at frame 8
    slam = dict(cfg=cfg.to_json(), frames=frames, masks=masks,
                samples=samples, save_at=7)
    mcfg = cfg.replace(map=dataclasses.replace(cfg.map, capacity=128,
                                               block_size=32),
                       mesh=dataclasses.replace(cfg.mesh,
                                                shard_hypotheses=False))
    maint = dict(cfg=mcfg.to_json(), frames=slam_frames(22, seed=13))
    seqs = np.stack([multi_sequence_frames(s) for s in range(4)])
    multiseq = dict(cfg=cfg.to_json(), seqs=seqs,
                    seeds=np.arange(100, 104))

    process = dict(cfg=torch_frozen.CFG.to_json(),
                   frames=torch_frozen.frames())
    base = dict(assoc=assoc, mapops=mapops, ransac=rs, fund=fund, ba=bac,
                slam=slam, process=process)
    dirs = [tempfile.mkdtemp(prefix=f"vslam_d{d}_") for d in (2, 4, 1)]
    ckpt = [os.path.join(d, "ckpt") for d in dirs]
    g2 = pool.submit(torch_dist.run_group, torch_dist.group_worker, 2,
                     dict(base, multiseq=multiseq, ckpt=ckpt[0]), dirs[0],
                     torchrun_env=True)
    g4 = pool.submit(torch_dist.run_group, torch_dist.group_worker, 4,
                     dict(base, maint=maint, ckpt=ckpt[1]), dirs[1])

    # the references, while the ranks run
    mesh8 = jmesh.make_mesh("shard", 8)
    args = (jnp.asarray(assoc["P"]), jnp.asarray(assoc["kp_uv"]),
            jnp.asarray(kp_desc_u32), jnp.asarray(assoc["kp_free"]))
    jcfg = JVSLAMConfig()
    map_cfg = JMapConfig(capacity=1024, obs_per_point=2, block_size=64)
    jassoc = jsharded_map.associate_sharded(
        mesh8, "shard", jsharded_map.shard_map_state(mesh8, "shard", jmap),
        *args, map_cfg=map_cfg, match_cfg=jcfg.matching, width=W_ASSOC,
        height=H_ASSOC)
    jsingle = jpoint_map.associate(jmap, *args, map_cfg, jcfg.matching,
                                   W_ASSOC, H_ASSOC)
    ref = dict(
        assoc=tuple(np.asarray(x) for x in (jassoc.point_id,
                                            jassoc.distance)),
        assoc_single=tuple(np.asarray(x) for x in (jsingle.point_id,
                                                   jsingle.distance)),
        mapops=_mapops_reference(jmap, mapops))
    jpose = jransac.ransac_pose(key, jnp.asarray(uv1), jnp.asarray(uv2),
                                jnp.asarray(vis), jnp.asarray(K2v),
                                num_hypotheses=512)
    ref["pose"] = {k: np.asarray(getattr(jpose, k)) for k in jpose._fields}
    jcfg_ba = JBAConfig(iterations=8)
    for name, fn in (("ba_sharded", lambda: jsharded_ba.solve_sharded(
            mesh8, "shard", problem, jnp.asarray(BA_K), jcfg_ba)),
                     ("ba_single", lambda: jba.solve(
                         problem, jnp.asarray(BA_K), jcfg_ba))):
        p, st = fn()
        ref[name] = dict(T_cw=np.asarray(p.T_cw), points=np.asarray(p.points),
                         point_mask=np.asarray(p.point_mask),
                         **{k: np.asarray(getattr(st, k))
                            for k in st._fields})
    ref["slam"] = _reference_slam(frames)

    port = {}
    pose = ransac.ransac_pose_from_samples(
        *(torch.from_numpy(np.array(a)) for a in (idx, uv1, uv2, vis, K2v)))
    port["pose"] = {k: getattr(pose, k).numpy() for k in pose._fields}
    p, st = ba.solve(interop.from_jax(bac["problem"], ba.BAProblem),
                     torch.from_numpy(BA_K), BAConfig(iterations=8))
    port["ba"] = dict(T_cw=p.T_cw.numpy(), points=p.points.numpy(),
                      point_mask=p.point_mask.numpy(),
                      **{k: getattr(st, k).numpy() for k in st._fields})
    off = cfg.replace(mesh=dataclasses.replace(cfg.mesh,
                                               shard_hypotheses=False))
    port["slam_off"] = torch_dist.run_slam(off, frames,
                                           save_at=slam["save_at"],
                                           ckpt=ckpt[2])
    port["maint"] = torch_dist.run_slam(mcfg, maint["frames"],
                                        enable_ba=False)
    port["multiseq"] = [torch_dist.track_sequence(cfg, seqs[s], 100 + s)
                        for s in range(4)]
    return dict(d2=g2.result(), d4=g4.result(), ref=ref, port=port,
                fund_outliers=f_out, fund_vis=fvis)


def multi_sequence_frames(s, n_frames=4):
    """tests/test_multi_sequence.py's sequence s."""
    cfg = small_config()
    scene = synthetic.make_scene(num_points=500, seed=10 + s,
                                 extent=(14, 6, 40), z_min=6.0)
    poses = synthetic.make_trajectory(n_frames, step=0.6, seed=10 + s)
    return np.stack(synthetic.render_sequence(
        cfg.camera.K(), poses, scene, cfg.camera.width, cfg.camera.height))


def results(tmp_path_factory):
    return torch_dist.shared("sharded_cases", tmp_path_factory, _compute)
