"""Spawned process groups for the port's distributed tests, on the CPU.

numpy, torch and the port only, never jax: the ranks are spawned processes
that import this module by its path (``tests.torch_dist``) to find their
worker, so they never load JAX. Ranks join by a FileStore in a test
directory (no port is needed, safe under pytest-xdist), run one thread each
on gloo, and hand back picklable numpy results.

``group_worker`` runs every sharded check of one mesh size D in one group:
association, the shard-local map operations, hypothesis-sharded RANSAC,
landmark-sharded BA, the SLAM system with the sharded map (with and without
hypothesis sharding, then sharded global BA; the latter saved partway by
``save_state`` and resumed by ``load_state`` into a fresh meshed system),
``process`` on the mesh against the frozen eager mesh path
(``torch_frozen.EagerProcess``, with window BA, structure refinement and
maintenance, hypothesis sharding on and off), maintenance through the
sharded map (D = 4) and multi-sequence tracking (D = 2, also against the
frozen eager loop); and that gloo's collectives are not captured.
"""
from __future__ import annotations

import dataclasses
import datetime
import fcntl
import json
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

JOIN_TIMEOUT_S = 900
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=240)
_MEMO = {}


def shared(name: str, tmp_path_factory, compute):
    """``compute()`` once per pytest run: in this process, or under
    pytest-xdist by the first worker that asks, whose pickled result the
    other workers read from the run's shared temporary directory."""
    if "PYTEST_XDIST_WORKER" not in os.environ:
        if name not in _MEMO:
            _MEMO[name] = compute()
        return _MEMO[name]
    root = tmp_path_factory.getbasetemp().parent
    out = root / f"{name}.pkl"
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():
            out.write_bytes(pickle.dumps(compute()))
        return pickle.loads(out.read_bytes())


def run_group(worker, world_size: int, payload, tmp_dir,
              torchrun_env: bool = False, timeout: float = JOIN_TIMEOUT_S):
    """``world_size`` spawned ranks running ``worker(rank, world_size,
    payload)`` (``multihost.spawn``); returns each rank's result.
    ``torchrun_env`` joins through ``multihost.initialize`` from torchrun's
    environment variables (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``), else
    from arguments."""
    from vslam_tpu_torch.parallel import multihost

    codes = multihost.spawn(_entry, world_size, (
        worker, world_size, torchrun_env, payload, tmp_dir), timeout)
    if any(codes):
        raise RuntimeError(f"ranks exited with {codes} (join timeout "
                           f"{timeout} s)")
    results = []
    for r in range(world_size):
        with open(os.path.join(tmp_dir, f"rank{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


def _entry(rank, init, worker, world_size, torchrun_env, payload, tmp_dir):
    from vslam_tpu_torch.parallel import multihost

    torch.set_num_threads(1)
    if torchrun_env:
        os.environ.update(WORLD_SIZE=str(world_size), RANK=str(rank),
                          LOCAL_RANK=str(rank))
        active = multihost.initialize(init, device_type="cpu",
                                      timeout=COLLECTIVE_TIMEOUT)
    else:
        active = multihost.initialize(init, world_size=world_size, rank=rank,
                                      device_type="cpu",
                                      timeout=COLLECTIVE_TIMEOUT)
    assert active and dist.get_world_size() == world_size
    try:
        result = worker(rank, world_size, payload)
    finally:
        multihost.shutdown()
    with open(os.path.join(tmp_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def _t(a):
    """numpy -> tensor; uint32 descriptor words as their int32 bit-view."""
    a = np.array(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _infos(s, infos):
    """A run's per-frame infos without wall time and spans, and its BA
    events."""
    strip = lambda d: {k: v for k, v in d.items()
                       if k not in ("wall_s", "t", "spans")}
    events = [strip(r) for r in s.metrics.records
              if r.get("kind") in ("ba", "global_ba", "map_maintenance")]
    return [strip(x) for x in infos], events


def run_slam(cfg, frames, seed=2, mesh=None, enable_ba=True, samples=None,
             masks=None, global_ba=False, save_at=None, ckpt=None):
    """A ``SLAMSystem`` of the port on the CPU over ``frames``; with
    ``samples``, frame i's RANSAC draws ``samples[i]`` (the reference's
    batch for the match mask ``masks[i]``) instead of the generator's.
    With ``save_at``, ``save_state`` writes ``ckpt`` before that frame and
    the result holds the files' contents. Returns a dict of numpy
    results."""
    from vslam_tpu_torch.geometry import ransac
    from vslam_tpu_torch.optimizer import ba
    from vslam_tpu_torch.parallel import sharded_ba
    from vslam_tpu_torch.pipeline.slam import SLAMSystem
    from vslam_tpu_torch.utils import checkpoint

    current = {}

    def injected(gen, weights, num_hypotheses, sample_size):
        i = current["frame"]
        assert np.array_equal((weights > 0).numpy(), masks[i]), i
        assert samples[i].shape == (num_hypotheses, sample_size)
        return _t(samples[i]).long()

    real_sample = ransac.sample_minimal_sets
    if samples is not None:
        ransac.sample_minimal_sets = injected
    try:
        s = SLAMSystem(cfg, "cpu", seed=seed, enable_ba=enable_ba, mesh=mesh)
        infos = []
        for i, f in enumerate(frames):
            if i == save_at:
                checkpoint.save_state(ckpt, s)
            current["frame"] = i
            infos.append(s.process(f))
    finally:
        ransac.sample_minimal_sets = real_sample
    infos, events = _infos(s, infos)
    out = dict(poses=s.poses(), infos=infos, events=events,
               maintenance_runs=s.maintenance_runs,
               dropped=s.dropped_inserts_total,
               map_size=int(s.state.map.size))
    if save_at is not None:
        out["ckpt"] = read_checkpoint(ckpt)
    if global_ba:
        # sharded global BA, its solve held to the single-device solve of
        # the same (post-rejection) problem
        seen = {}
        real_solve = sharded_ba.solve_sharded

        def spy(mesh_, axis, problem, K, ba_cfg):
            seen.update(problem=problem, cfg=ba_cfg)
            seen["out"] = real_solve(mesh_, axis, problem, K, ba_cfg)
            return seen["out"]
        sharded_ba.solve_sharded = spy
        try:
            stats = s.run_global_ba(mesh=mesh, axis_name=cfg.mesh.axis_map)
        finally:
            sharded_ba.solve_sharded = real_solve
        ref, ref_stats = ba.solve(seen["problem"], s._K, seen["cfg"])
        out.update(global_stats=_stats(stats), global_ref=_stats(ref_stats),
                   global_T_cw=seen["out"][0].T_cw.numpy(),
                   global_ref_T_cw=ref.T_cw.numpy(),
                   global_kf=s.keyframe_poses(),
                   global_coverage=s.last_global_ba_coverage)
    return out


def _stats(st):
    return {k: getattr(st, k).numpy() for k in st._fields}


def read_checkpoint(path):
    """A ``save_state`` checkpoint's arrays (by key) and its metadata."""
    with np.load(path + ".npz") as npz:
        arrays = {k: npz[k] for k in npz.files}
    with open(path + ".json") as f:
        return arrays, json.load(f)


def resume_slam(cfg, frames, start, ckpt, mesh=None, seed=2):
    """A fresh ``SLAMSystem`` loaded from ``ckpt`` (saved before frame
    ``start``), then ``frames[start:]``: the whole trajectory, the resumed
    frames' infos and the events they logged."""
    from vslam_tpu_torch.pipeline.slam import SLAMSystem
    from vslam_tpu_torch.utils import checkpoint

    s = SLAMSystem(cfg, "cpu", seed=seed, mesh=mesh)
    checkpoint.load_state(ckpt, s)
    infos, events = _infos(s, [s.process(f) for f in frames[start:]])
    return dict(poses=s.poses(), infos=infos, events=events)


def track_sequence(cfg, frames, seed):
    """The port's tracker alone over one sequence: (F-1, 4, 4) poses and
    each step's inlier count."""
    from vslam_tpu_torch.pipeline import tracker

    st = tracker.bootstrap(frames[0], cfg, "cpu", seed=seed)
    poses, inl = [], []
    for f in frames[1:]:
        st, o = tracker.track_step(st, f, cfg)
        poses.append(o.pose.numpy())
        inl.append(int(o.num_inliers))
    return np.stack(poses), np.array(inl)


def _failure(check, *args):
    """None when ``check(*args)`` passes, else its AssertionError's text
    (what a rank hands back instead of raising)."""
    try:
        check(*args)
    except AssertionError as e:
        return f"{check.__name__}: {e!r}"
    return None


def frozen_process(mesh, cfg_json, frames):
    """``process`` on ``mesh`` (through ``scan_driver.track_frame``)
    against ``torch_frozen.EagerProcess``, the eager mesh path as it was,
    over ``frames``, with hypothesis sharding on and off: per setting,
    whether the two runs are equal (None) or how they differ, the
    premises' verdict, the step graph (None on the CPU) and the poses."""
    import torch_frozen
    from vslam_tpu_torch.config import VSLAMConfig
    from vslam_tpu_torch.pipeline.slam import SLAMSystem

    cfg = VSLAMConfig.from_json(cfg_json)
    out = {}
    for hyp in (True, False):
        c = cfg.replace(mesh=dataclasses.replace(cfg.mesh,
                                                 shard_hypotheses=hyp))
        a, ia, oa = torch_frozen.run(SLAMSystem, c, "torch", frames, "cpu",
                                     mesh)
        b, ib, ob = torch_frozen.run(torch_frozen.EagerProcess, c, "torch",
                                     frames, "cpu", mesh)
        out[hyp] = dict(
            differs=_failure(torch_frozen.assert_same_run, a, ia, oa, b, ib,
                             ob),
            premises=_failure(torch_frozen.premises, a, ia),
            step_graph=a.step_graph, poses=a.poses())
    return out


def group_worker(rank, D, p):
    """Every sharded check of mesh size D (see the module docstring)."""
    import torch_frozen
    from vslam_tpu_torch import interop
    from vslam_tpu_torch.config import BAConfig, VSLAMConfig
    from vslam_tpu_torch.optimizer import ba
    from vslam_tpu_torch.parallel import (mesh as mesh_mod, multi_sequence,
                                          sharded_ba, sharded_map,
                                          sharded_ransac, sharded_tracker)
    from vslam_tpu_torch.pipeline import scan_driver

    mesh = mesh_mod.make_mesh("map", D, device_type="cpu")
    out = {"capturable": mesh_mod.capturable(mesh)}
    try:
        scan_driver.step_graph(VSLAMConfig(), mesh=mesh)
        out["step_graph_refused"] = False
    except ValueError:
        out["step_graph_refused"] = True

    a = p["assoc"]
    cfg = VSLAMConfig.from_json(a["cfg"])
    m = interop.map_shard(a["map"], rank, D)
    res = sharded_map.associate_sharded(
        mesh, "map", m, _t(a["P"]), _t(a["kp_uv"]), _t(a["kp_desc"]),
        _t(a["kp_free"]), cfg.map, cfg.matching, a["W"], a["H"])
    out["assoc"] = (res.point_id.numpy(), res.distance.numpy())

    # the tracker's shard-local map operations, in a step's order
    ops = sharded_tracker._local_ops(cfg, mesh, "map",
                                     cfg.map.capacity // D, a["W"], a["H"])
    mo = {k: _t(v) for k, v in p["mapops"].items()}
    m = ops.insert(m, mo["xyz"], mo["color"], mo["desc"], mo["valid"],
                   mo["frame_ins"], mo["prov"], mo["first_uv"],
                   mo["first_P"], mo["first_C"], mo["conf"])
    m = ops.observe(m, mo["obs_ids"], mo["obs_desc"], mo["obs_valid"],
                    mo["frame_obs"])
    m = ops.update_xyz(m, mo["upd_ids"], mo["upd_xyz"], mo["upd_valid"],
                       mo["upd_promote"], mo["upd_conf"])
    rows = ops.gather_pt(m, mo["upd_ids"]).numpy()
    prov = ops.gather_prov(m, mo["upd_ids"]).numpy()
    m = ops.cull(m, mo["frame_cull"])
    n_alive = int(ops.alive_count(m))
    out["mapops"] = dict(
        map=interop.to_numpy(sharded_map.gather_map_state(mesh, "map", m)),
        alive=n_alive, rows=rows, prov=prov, local_size=int(m.size),
        local_capacity=m.capacity)

    r = p["ransac"]
    args = [_t(r[k]) for k in ("uv1", "uv2", "vis", "K")]
    res = sharded_ransac.ransac_pose_hypsharded_from_samples(
        mesh, "map", _t(r["idx"]).long(), *args)
    out["pose"] = {k: getattr(res, k).numpy() for k in res._fields}
    f = p["fund"]
    res = sharded_ransac.ransac_fundamental_sharded(
        mesh, "map", torch.Generator().manual_seed(0), _t(f["uv1"]),
        _t(f["uv2"]), _t(f["vis"]), num_hypotheses=512)
    out["fund"] = dict(inliers=res.inliers.numpy(),
                       success=bool(res.success))

    b = p["ba"]
    problem = interop.from_jax(b["problem"], ba.BAProblem)
    solved, st = sharded_ba.solve_sharded(mesh, "map", problem, _t(b["K"]),
                                          BAConfig(iterations=8))
    out["ba"] = dict(T_cw=solved.T_cw.numpy(), points=solved.points.numpy(),
                     point_mask=solved.point_mask.numpy(), **_stats(st))

    s = p["slam"]
    scfg = VSLAMConfig.from_json(s["cfg"])
    out["slam_hyp"] = run_slam(scfg, s["frames"], mesh=mesh,
                               samples=s["samples"], masks=s["masks"])
    off = scfg.replace(mesh=dataclasses.replace(scfg.mesh,
                                                shard_hypotheses=False))
    out["slam_off"] = run_slam(off, s["frames"], mesh=mesh, global_ba=True,
                               save_at=s["save_at"], ckpt=p["ckpt"])
    out["resumed"] = resume_slam(off, s["frames"], s["save_at"], p["ckpt"],
                                 mesh=mesh)
    out["process"] = frozen_process(mesh, p["process"]["cfg"],
                                    p["process"]["frames"])
    if "maint" in p:
        mt = p["maint"]
        out["maint"] = run_slam(VSLAMConfig.from_json(mt["cfg"]),
                                mt["frames"], mesh=mesh, enable_ba=False)
    if "multiseq" in p:
        ms = p["multiseq"]
        mcfg = VSLAMConfig.from_json(ms["cfg"])
        dmesh = mesh_mod.make_mesh("data", D, device_type="cpu")
        seqs = ms["seqs"]
        bst = multi_sequence.batched_bootstrap(seqs[:, 0], mcfg, dmesh,
                                               "data", seeds=ms["seeds"],
                                               device="cpu")
        frozen = multi_sequence.batched_bootstrap(
            seqs[:, 0], mcfg, dmesh, "data", seeds=ms["seeds"],
            device="cpu")
        poses, inl, differs = [], [], []
        for fi in range(1, seqs.shape[1]):
            bst, o = multi_sequence.batched_track_step(bst, seqs[:, fi],
                                                       mcfg, dmesh, "data")
            frozen, want = torch_frozen.eager_batched_track_step(
                frozen, seqs[:, fi], mcfg, dmesh, "data")
            poses.append(o.pose.numpy())
            inl.append(o.num_inliers.numpy())
            differs += [(fi, k) for k, x, y in zip(o._fields, o, want)
                        if not torch.equal(x, y)]
        out["multiseq"] = dict(poses=np.stack(poses, axis=1),
                               inliers=np.stack(inl, axis=1),
                               owned=len(bst.states), graph=bst.graph,
                               frozen_differs=differs)
    return out


# --- one-rank NCCL groups on a card (the ``gpu`` tests) -------------------


def run_on_card(worker, payload, tmp_dir, timeout: float = JOIN_TIMEOUT_S):
    """``worker(payload)`` in one spawned process on card 0, which makes
    its own one-rank NCCL group (``mesh.make_mesh(axis, 1)``) so that no
    other test's process inherits that backend; returns its result."""
    from vslam_tpu_torch.parallel import multihost

    codes = multihost.spawn(_card_entry, 1, (worker, payload, tmp_dir),
                            timeout)
    if any(codes):
        raise RuntimeError(f"the card's process exited with {codes}")
    with open(os.path.join(tmp_dir, "card.pkl"), "rb") as f:
        return pickle.load(f)


def _card_entry(rank, init, worker, payload, tmp_dir):
    from vslam_tpu_torch.parallel import multihost

    del rank, init
    torch.cuda.set_device(0)
    try:
        result = worker(payload)
    finally:
        multihost.shutdown()
    with open(os.path.join(tmp_dir, "card.pkl"), "wb") as f:
        pickle.dump(result, f)


def card_process_case(p):
    """``process`` of ``p["cfg"]`` on a one-rank NCCL mesh over
    ``p["frames"]``, replaying its step graph, against the frozen eager
    mesh path and the single-device system (which replays its own step
    graph): how each differs (None: equal), and what the graph did."""
    import torch_frozen
    from vslam_tpu_torch.config import VSLAMConfig
    from vslam_tpu_torch.ops import associate as k2
    from vslam_tpu_torch.ops import hamming as k1
    from vslam_tpu_torch.parallel import mesh as mesh_mod
    from vslam_tpu_torch.pipeline.slam import SLAMSystem

    cfg, rng, frames = VSLAMConfig.from_json(p["cfg"]), p["rng"], p["frames"]
    dev = torch.device("cuda", 0)
    mesh = mesh_mod.make_mesh(cfg.mesh.axis_map, 1)
    eager = torch_frozen.run(torch_frozen.EagerProcess, cfg, rng, frames,
                             dev, mesh)
    s = SLAMSystem(cfg, dev, rng=rng, mesh=mesh)
    ia = [s.process(torch.from_numpy(frames[0]).to(dev))]
    g = s.step_graph
    before = (k1.launches, k2.launches)
    oa = []
    for f in frames[1:]:
        ia.append(s.process(torch.from_numpy(f).to(dev)))
        oa.append(s.last_output)
    out = dict(
        backend=dist.get_backend(), capture_s=ia[0].get("capture_s"),
        graph_capture_s=g.capture_s, replays=g.replays,
        captured_launches=g.captured_launches, nodes=g.nodes,
        launched_outside=(k1.launches, k2.launches) != before,
        later_capture=any("capture_s" in x for x in ia[1:]),
        vs_eager=_failure(torch_frozen.assert_same_run, s, ia, oa, *eager),
        premises=(_failure(torch_frozen.premises, s, ia) if p["premises"]
                  else None))
    single = torch_frozen.run(SLAMSystem, cfg, rng, frames, dev)
    out["vs_single"] = _failure(torch_frozen.assert_same_run, s, ia, oa,
                                *single)
    return out


def card_restore_case(p):
    """A meshed system (one NCCL rank) saved after ``p["cut"]`` frames and
    restored by ``load_state`` into a fresh meshed system: whether the
    latter captured its step graph at its first tracked frame, and how the
    two differ over the remaining frames."""
    import torch_frozen
    from vslam_tpu_torch.parallel import mesh as mesh_mod
    from vslam_tpu_torch.pipeline.slam import SLAMSystem
    from vslam_tpu_torch.utils import checkpoint

    cfg, frames, cut = torch_frozen.CFG, p["frames"], p["cut"]
    dev = torch.device("cuda", 0)
    mesh = mesh_mod.make_mesh(cfg.mesh.axis_map, 1)
    a = SLAMSystem(cfg, dev, rng="threefry", mesh=mesh)
    for f in frames[:cut]:
        a.process(torch.from_numpy(f).to(dev))
    checkpoint.save_state(p["ckpt"], a)
    b = SLAMSystem(cfg, dev, rng="threefry", mesh=mesh)
    checkpoint.load_state(p["ckpt"], b)
    out = dict(graph_before=b.step_graph.graph is not None)
    ia, ib = [], []
    for f in frames[cut:]:
        x = torch.from_numpy(f).to(dev)
        ia.append(a.process(x))
        ib.append(b.process(x))
    state = [(n, torch.equal(x, y)) for (n, x), (_, y) in zip(
        torch_frozen.tensors(a.state), torch_frozen.tensors(b.state))]
    out.update(
        first_capture_s=ib[0].get("capture_s"),
        graph_capture_s=b.step_graph.capture_s,
        replays=b.step_graph.replays,
        same_infos=torch_frozen.strip(ia) == torch_frozen.strip(ib),
        same_trajectory=all(np.array_equal(x, y) for x, y in zip(
            a.trajectory, b.trajectory)),
        state_differs=[n for n, same in state if not same])
    return out


def card_batched_case(p):
    """``multi_sequence`` on a one-rank NCCL mesh: the batched step
    replaying its graph, the same step eager (the state's graph dropped)
    and the frozen eager loop, from three bootstraps of the same
    sequences: the fields that differ, per step, and the graph's record."""
    import torch_frozen
    from vslam_tpu_torch.config import VSLAMConfig
    from vslam_tpu_torch.ops import associate as k2
    from vslam_tpu_torch.ops import hamming as k1
    from vslam_tpu_torch.parallel import mesh as mesh_mod
    from vslam_tpu_torch.parallel import multi_sequence
    from vslam_tpu_torch.utils import jit

    cfg = VSLAMConfig.from_json(p["cfg"])
    dev = torch.device("cuda", 0)
    dmesh = mesh_mod.make_mesh("data", 1)
    seqs = torch.from_numpy(p["seqs"]).to(dev)
    boot = lambda: multi_sequence.batched_bootstrap(
        seqs[:, 0], cfg, dmesh, "data", seeds=p["seeds"], device=dev)
    a, b, c = boot(), dataclasses.replace(boot(), graph=None), boot()
    differs, launched = [], []
    for fi in range(1, seqs.shape[1]):
        before = (k1.launches, k2.launches)
        a, oa = multi_sequence.batched_track_step(a, seqs[:, fi], cfg,
                                                  dmesh, "data")
        launched.append((k1.launches - before[0], k2.launches - before[1]))
        with jit.disable_jit():
            b, ob = multi_sequence.batched_track_step(b, seqs[:, fi], cfg,
                                                      dmesh, "data")
        c, oc = torch_frozen.eager_batched_track_step(c, seqs[:, fi], cfg,
                                                      dmesh, "data")
        for name, x, y, z in zip(oa._fields, oa, ob, oc):
            if not (torch.equal(x, y) and torch.equal(x, z)):
                differs.append((fi, name))
    for j, (x, y) in enumerate(zip(a.states, b.states)):
        differs += [(j, n) for (n, u), (_, v) in zip(
            torch_frozen.tensors(x), torch_frozen.tensors(y))
            if not torch.equal(u, v)]
        if not torch.equal(x.key.get_state(), y.key.get_state()):
            differs.append((j, "key"))
    try:                       # an input of another shape than the slot's
        multi_sequence.batched_track_step(a, seqs[:, 1, :, :-8], cfg, dmesh,
                                          "data")
        shape_refused = False
    except ValueError:
        shape_refused = True
    g = a.graph
    return dict(differs=differs, launched=launched, replays=g.replays,
                shape_refused=shape_refused,
                nodes=g.nodes, capture_s=g.capture_s,
                eager_graph=b.graph, poses=oa.pose.cpu().numpy())


def card_jit_step_case(p):
    """``tracker.track_step(mesh=)`` called directly on a one-rank NCCL
    mesh over ``p["frames"]``: replays of the sharded step's graph cached
    by ``utils.jit`` against the same steps eager (``disable_jit``), from
    two bootstraps; then ``multihost.shutdown`` and what is left cached."""
    import torch_frozen
    from vslam_tpu_torch.config import VSLAMConfig
    from vslam_tpu_torch.parallel import mesh as mesh_mod
    from vslam_tpu_torch.parallel import multihost
    from vslam_tpu_torch.pipeline import tracker
    from vslam_tpu_torch.utils import jit

    cfg, frames = VSLAMConfig.from_json(p["cfg"]), p["frames"]
    dev = torch.device("cuda", 0)
    axis = cfg.mesh.axis_map
    mesh = mesh_mod.make_mesh(axis, 1)
    xs = [torch.from_numpy(f).to(dev) for f in frames]

    def run(eager):
        st = tracker.bootstrap(xs[0], cfg, dev, rng=p["rng"])
        outs = []
        for x in xs[1:]:
            if eager:
                with jit.disable_jit():
                    st, o = tracker.track_step(st, x, cfg, mesh=mesh,
                                               map_axis=axis)
            else:
                st, o = tracker.track_step(st, x, cfg, mesh=mesh,
                                           map_axis=axis)
            outs.append(o)
        return st, outs

    want, wo = run(eager=True)
    got, go = run(eager=False)
    (g,) = jit.cache().values()
    differs = [(i, k) for i, (a, b) in enumerate(zip(go, wo))
               for k, x, y in zip(a._fields, a, b) if not torch.equal(x, y)]
    differs += [n for (n, x), (_, y) in zip(torch_frozen.tensors(got),
                                            torch_frozen.tensors(want))
                if not torch.equal(x, y)]
    if isinstance(got.key, torch.Generator) and not torch.equal(
            got.key.get_state(), want.key.get_state()):
        differs.append("key")
    out = dict(backend=dist.get_backend(), has_mesh=g.mesh is mesh,
               replays=g.replays, captured_launches=g.captured_launches,
               differs=differs,
               poses=np.stack([o.pose.cpu().numpy() for o in go]))
    multihost.shutdown()
    out["cached_after_shutdown"] = len(jit.cache())
    return out


def card_teardown_case(p):
    """``cli run --mesh 1`` on one NCCL rank, made to raise after its step
    graph was captured and replayed (``SLAMSystem.snapshot`` raises): what
    was raised, whether the group was left, and whether the system's graph
    was freed although the traceback still holds the system."""
    from vslam_tpu_torch import cli
    from vslam_tpu_torch.pipeline import slam

    systems = []

    def snapshot(self):
        systems.append(self)
        raise RuntimeError("planted after the capture")

    slam.SLAMSystem.snapshot = snapshot
    try:
        cli.main(["run", "--synthetic", "--small", "--frames",
                  str(p["frames"]), "--mesh", "1", "--out", p["out"]])
        raised = None
    except RuntimeError as e:
        raised = str(e)
    g = systems[0].step_graph if systems else None
    freed = None
    if g is not None:
        try:
            g.graph.replay()
            freed = False
        except RuntimeError:
            freed = True
    return dict(raised=raised, left=not dist.is_initialized(),
                replays=None if g is None else g.replays, freed=freed)
