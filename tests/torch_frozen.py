"""Frozen copies of the port's eager drivers, and the comparisons that
hold the graph-driven ones to them.

``EagerProcess`` is ``SLAMSystem`` with ``process`` as it was before the
step went through ``scan_driver``: the eager ``tracker.track_step`` (with
the system's mesh, if any) and one ``torch.cat`` fetch.
``eager_batched_track_step`` is ``parallel.multi_sequence.
batched_track_step`` as it was before it could replay a graph: a loop of
eager ``track_step``s, then one ``all_gather`` a field. Both call the
step under ``utils.jit.disable_jit``, so on a card too it runs eagerly
(a direct call there replays a cached graph). ``refine_pose_gn`` and
``refine_pose_gn_multistart`` are ``geometry.epipolar``'s polish as it was
before its loop body went through ``ops.sampson_gn``: residuals, forward-mode
Jacobian, normal equations and costs inline. numpy, torch and
the port only, never jax: the spawned ranks of tests/torch_dist.py and the
``gpu`` tests' spawned processes import it.
"""
import dataclasses

import numpy as np
import torch

from vslam_tpu_torch.config import MapConfig, small_config
from vslam_tpu_torch.core import lie
from vslam_tpu_torch.core.types import pick
from vslam_tpu_torch.datasets import synthetic
from vslam_tpu_torch.geometry import epipolar
from vslam_tpu_torch.parallel.mesh import all_gather
from vslam_tpu_torch.pipeline import keyframes, scan_driver, slam, tracker
from vslam_tpu_torch.utils import jit

_SMALL = small_config()
# structure refinement every 2nd keyframe; a 512-slot map, so maintenance
# runs (high-water 256)
CFG = _SMALL.replace(
    ba=dataclasses.replace(_SMALL.ba, structure_every=2),
    map=MapConfig(capacity=512, obs_per_point=4, block_size=32))
VARIANTS = CFG.replace(frontend=dataclasses.replace(
    CFG.frontend, oriented=True, track_carry=True))
CASES = {"torch": (CFG, "torch"), "threefry": (CFG, "threefry"),
         "variants": (VARIANTS, "torch")}
N_FRAMES = 16

# TrackOutput scalars fetched with the pose in one transfer per frame
_SCALARS = ("num_matches", "num_inliers", "num_associated",
            "num_tracked_map", "num_tracked_prov", "num_pnp_inliers",
            "num_refined", "num_promoted", "num_new_points",
            "num_dropped_inserts", "map_size", "map_alive", "scale",
            "success")


class EagerProcess(slam.SLAMSystem):
    """``SLAMSystem`` with ``process`` frozen as it was before the step
    went through ``scan_driver``: the eager ``tracker.track_step`` and one
    ``torch.cat`` fetch of the pose and counters."""

    def process(self, img):
        import time
        t0 = time.perf_counter()
        if self.state is None:
            state = tracker.bootstrap(img, self.cfg, self.device,
                                      seed=self._seed, rng=self._rng)
            self.state = state.replace(map=self._local(state.map))
            self.trajectory.append(np.eye(4, dtype=np.float32))
            info = {"kind": "frame", "frame": 0, "bootstrap": True,
                    "wall_s": time.perf_counter() - t0}
            self.metrics.log(**info)
            self.frame_idx = 1
            return info

        with jit.disable_jit():
            self.state, out = tracker.track_step(self.state, img, self.cfg,
                                                 mesh=self.mesh,
                                                 map_axis=self._map_axis)
        self.last_output = out
        host = torch.cat([
            out.pose.reshape(16).to(torch.float64),
            torch.stack([getattr(out, k).reshape(()).to(torch.float64)
                         for k in _SCALARS])]).cpu().numpy()
        pose = host[:16].reshape(4, 4).astype(np.float32)
        o = dict(zip(_SCALARS, host[16:].tolist()))
        self.trajectory.append(pose)
        counts = {k: int(o[k]) for k in _SCALARS[:-2]}
        success = bool(o["success"])

        inlier_ratio = counts["num_inliers"] / max(counts["num_matches"], 1.0)
        is_kf = (
            self.frame_idx % self.cfg.pipeline.keyframe_every == 0
            or inlier_ratio < self.cfg.pipeline.keyframe_min_inlier_ratio
        )
        ran_ba = False
        if is_kf and success:
            self.kf_store = keyframes.insert_keyframe(
                self.kf_store, self.state.pose,
                torch.full((), self.frame_idx, dtype=torch.int32,
                           device=self.device),
                self.state.prev.uv, self.state.prev_map_id,
                self.state.prev.mask)
            self._kf_count += 1
            se = self.cfg.ba.structure_every
            if (self.enable_ba and se > 0 and self._kf_count >= 3
                    and self._kf_count % se == 0):
                self._refine_structure()
            if (self.enable_ba and self._kf_count >= 3
                    and self._kf_count % self.cfg.pipeline.local_ba_every
                    == 0):
                ran_ba = True
                self._run_window_ba()

        self.dropped_inserts_total += counts["num_dropped_inserts"]
        ran_maintenance = False
        if counts["map_size"] >= self._maint_high_water:
            m2, pid2, obs2 = scan_driver._maintenance(
                self.whole_map(), self.state.prev_map_id,
                self.kf_store.obs_pid, self._maint_min_free)
            self.state = self.state.replace(map=self._local(m2),
                                            prev_map_id=pid2)
            self.kf_store = self.kf_store.replace(
                obs_pid=obs2, obs_mask=self.kf_store.obs_mask & (obs2 >= 0))
            self.maintenance_runs += 1
            ran_maintenance = True
            self.metrics.log(kind="map_maintenance", frame=self.frame_idx,
                             size_before=counts["map_size"],
                             size_after=int(m2.size))

        info = {"kind": "frame", "frame": self.frame_idx, **counts,
                "scale": o["scale"], "success": success,
                "keyframe": bool(is_kf), "ran_ba": ran_ba,
                "ran_maintenance": ran_maintenance,
                "wall_s": time.perf_counter() - t0}
        self.metrics.log(**info)
        self.frame_idx += 1
        return info


def frames(n=N_FRAMES, seed=2, cfg=CFG):
    """tests/test_slam.py's scene, seen by ``cfg``'s camera."""
    cam = cfg.camera
    scene = synthetic.make_scene(num_points=700, seed=seed,
                                 extent=(14, 6, 45), z_min=6.0)
    poses = synthetic.make_trajectory(n, step=0.6, yaw_rate=0.01, seed=seed)
    return np.stack(synthetic.render_sequence(cam.K(), poses, scene,
                                              cam.width, cam.height))


def tensors(obj, path=""):
    """(name, tensor) of every tensor of a dataclass of tensors, nested
    dataclasses included."""
    out = []
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out += tensors(v, path + f.name + ".")
        elif isinstance(v, torch.Tensor):
            out.append((path + f.name, v))
    return out


# what the frozen driver predates: the spans and sync count of a record,
# the step graph's stage times and the solves' device times
TRACING = ("spans", "syncs", "device_ms", "solve_device_ms")


def strip(records):
    """Records without the host clock's keys, the tracing's and the
    counters the carry notes (``scan_driver.NOTED``), which the frozen
    driver's ``TrackOutput`` fetch does not hold."""
    return [{k: v for k, v in r.items()
             if k not in ("t", "wall_s", "capture_s") + TRACING
             + scan_driver.NOTED}
            for r in records]


def run(cls, cfg, rng, frames, dev, mesh=None):
    """``frames`` through a new ``cls`` system (on ``mesh`` if given).
    Returns it, the info dicts and each tracked frame's ``last_output``."""
    s = cls(cfg, dev, rng=rng, mesh=mesh)
    infos, outs = [], []
    for f in frames:
        infos.append(s.process(torch.from_numpy(f).to(dev)))
        outs.append(s.last_output)
    return s, infos, outs[1:]


def assert_same_run(a, ia, oa, b, ib, ob):
    """Two systems' runs equal: info dicts and metrics records (host clock
    apart), trajectory, keyframe store, state, RANSAC stream, and every
    frame's last output as the run ends (no later frame overwrote one)."""
    assert strip(ia) == strip(ib)
    assert strip(a.metrics.records) == strip(b.metrics.records)
    assert len(a.trajectory) == len(b.trajectory)
    for i, (x, y) in enumerate(zip(a.trajectory, b.trajectory)):
        assert np.array_equal(x, y), i
    for obj in ("state", "kf_store"):
        for (name, x), (_, y) in zip(tensors(getattr(a, obj)),
                                     tensors(getattr(b, obj))):
            assert x.dtype == y.dtype and torch.equal(x, y), (obj, name)
    if isinstance(a.state.key, torch.Generator):
        assert torch.equal(a.state.key.get_state(), b.state.key.get_state())
    assert len(oa) == len(ob) == len(ia) - 1
    for i, (p, q) in enumerate(zip(oa, ob), 1):
        for name, x, y in zip(tracker.TrackOutput._fields, p, q):
            assert torch.equal(x, y), (i, name)
    assert a.dropped_inserts_total == b.dropped_inserts_total
    assert a.maintenance_runs == b.maintenance_runs


def premises(s, infos):
    """What the cases are for: a solved window-BA event, a structure
    refinement and a maintenance pass, and tracking throughout."""
    kinds = [r["kind"] for r in s.metrics.records]
    solved = [r for r in s.metrics.records
              if r["kind"] == "ba" and "skipped" not in r]
    assert solved, "premise: a solved window-BA event"
    assert "structure_refine" in kinds, "premise: a structure refinement"
    assert s.maintenance_runs >= 1, "premise: a maintenance pass"
    assert sum(x["success"] for x in infos[1:]) >= len(infos) - 3
    return solved


def eager_batched_track_step(state, imgs, cfg, mesh, axis_name: str):
    """``multi_sequence.batched_track_step`` as it was: each of this
    rank's sequences' eager ``track_step``, then the gather."""
    with jit.disable_jit():
        steps = [tracker.track_step(st, imgs[state.first + j], cfg)
                 for j, st in enumerate(state.states)]
    S = state.num_sequences
    out = tracker.TrackOutput(*(
        all_gather(mesh, axis_name, torch.stack(f)).reshape(
            (S,) + tuple(f[0].shape))
        for f in zip(*(o for _, o in steps))))
    return dataclasses.replace(state, states=[s for s, _ in steps]), out


def _t_basis(t):
    """(…, 3, 2) orthonormal basis of the plane orthogonal to unit t."""
    ax = torch.argmin(torch.abs(t), dim=-1)
    e = (torch.arange(3, device=t.device) == ax[..., None]).to(t.dtype)
    b1 = torch.linalg.cross(t, e, dim=-1)
    b1 = b1 / (torch.linalg.vector_norm(b1, dim=-1, keepdim=True) + 1e-12)
    b2 = torch.linalg.cross(t, b1, dim=-1)
    return torch.stack([b1, b2], dim=-1)


def _sampson_res(params, R0, t0, x1, x2):
    """Signed normalized Sampson residuals (S, N) of S starts perturbed by
    params (S, 5) = (rotation tangent, translation-direction tangent)."""
    dw, dt = params[:, :3], params[:, 3:]
    Rn = R0 @ lie.so3_exp(dw)
    tn = t0 + (_t_basis(t0) @ dt[:, :, None])[..., 0]
    tn = tn / (torch.linalg.vector_norm(tn, dim=-1, keepdim=True) + 1e-12)
    E = lie.hat(tn) @ Rn
    Ex1 = torch.einsum("sij,nj->sni", E, x1)
    Etx2 = torch.einsum("sji,nj->sni", E, x2)
    num = torch.einsum("ni,sni->sn", x2, Ex1)
    den = (Ex1[..., 0] * Ex1[..., 0] + Ex1[..., 1] * Ex1[..., 1]
           + Etx2[..., 0] * Etx2[..., 0] + Etx2[..., 1] * Etx2[..., 1])
    return num / torch.sqrt(torch.clamp(den, min=1e-18))


def _sampson_jac(params, R0, t0, x1, x2):
    """(S, N, 5) Jacobian of ``_sampson_res`` by forward-mode AD."""
    f = lambda p: _sampson_res(p, R0, t0, x1, x2)
    eye = torch.eye(5, dtype=params.dtype, device=params.device)
    cols = [torch.func.jvp(f, (params,), (eye[k].expand_as(params),))[1]
            for k in range(5)]
    return torch.stack(cols, dim=-1)


def refine_pose_gn(R, t, K, uv1, uv2, w, iters: int = 16,
                   huber_px: float = 1.0):
    """The polish's monolithic loop: every iteration's residuals,
    Jacobian, normal equations and costs inline."""
    K_inv = torch.linalg.inv_ex(K)[0]
    ones = torch.ones_like(uv1[..., :1])
    x1 = torch.einsum("ij,nj->ni", K_inv, torch.cat([uv1, ones], -1))
    x2 = torch.einsum("ij,nj->ni", K_inv, torch.cat([uv2, ones], -1))
    f = 0.5 * (K[0, 0] + K[1, 1])
    c = huber_px / f                                  # 0-d tensor
    valid = (w > 0).to(uv1.dtype)
    S = R.shape[0]
    eye5 = torch.eye(5, dtype=R.dtype, device=R.device)

    def cost(r):
        q = r / c
        return torch.sum(valid * 0.5 * (c * c) * torch.log1p(q * q), dim=-1)

    lam = torch.full((S,), 1e-3, dtype=R.dtype, device=R.device)
    z = torch.zeros((S, 5), dtype=R.dtype, device=R.device)
    for _ in range(iters):
        r = _sampson_res(z, R, t, x1, x2)                     # (S, N)
        q = r / c
        rw = valid / (1.0 + q * q)
        J = _sampson_jac(z, R, t, x1, x2)                     # (S, N, 5)
        Jw = J * rw[..., None]
        H = Jw.transpose(-1, -2) @ J                          # (S, 5, 5)
        g = torch.einsum("snk,sn->sk", Jw, r)
        dH = torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1), min=1e-12)
        Hd = H + lam[:, None, None] * torch.diag_embed(dH) + 1e-10 * eye5
        delta = -torch.linalg.solve_ex(Hd, g[..., None])[0][..., 0]
        r_new = _sampson_res(delta, R, t, x1, x2)
        better = cost(r_new) < cost(r)
        delta = torch.where(better[:, None], delta, 0.0)
        lam = torch.clamp(torch.where(better, lam * 0.25, lam * 8.0),
                          1e-9, 1e6)
        R = R @ lie.so3_exp(delta[:, :3])
        t = t + (_t_basis(t) @ delta[:, 3:, None])[..., 0]
        t = t / (torch.linalg.vector_norm(t, dim=-1, keepdim=True) + 1e-12)
    r_fin = _sampson_res(z, R, t, x1, x2)
    return R, t, cost(r_fin)


def refine_pose_gn_multistart(R, t, K, uv1, uv2, w, iters: int = 16,
                              huber_px: float = 1.0,
                              spread_deg=(30.0, 60.0),
                              extra_starts=None):
    """The multi-start polish over the frozen ``refine_pose_gn``."""
    B = _t_basis(t)
    angs = np.deg2rad(np.asarray(spread_deg, np.float32))
    cs = [(float(c), float(s)) for c, s in zip(np.cos(angs), np.sin(angs))]
    dirs = []
    for sx, sy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        d = B[:, 0] * sx + B[:, 1] * sy
        dirs += [c * t + s * d for c, s in cs]
    t0s = torch.stack([t] + dirs, dim=0)
    R0s = R.expand((t0s.shape[0], 3, 3))
    if extra_starts is not None:
        Re, te = extra_starts
        t0s = torch.cat([t0s, te], dim=0)
        R0s = torch.cat([R0s, Re], dim=0)
    t0s = t0s / (torch.linalg.vector_norm(t0s, dim=1, keepdim=True) + 1e-12)

    Rs, ts, costs = refine_pose_gn(R0s, t0s, K, uv1, uv2, w, iters=iters,
                                   huber_px=huber_px)
    costs = torch.where(torch.isnan(costs), torch.inf, costs)

    z1p, z2p = epipolar.triangulate_midpoint_depths(K, Rs, ts, uv1, uv2)
    z1m, z2m = epipolar.triangulate_midpoint_depths(K, Rs, -ts, uv1, uv2)
    valid = (w > 0)[None, :]
    vp = ((z1p > 0) & (z2p > 0) & valid).sum(dim=1)
    vm = ((z1m > 0) & (z2m > 0) & valid).sum(dim=1)
    ts = torch.where((vm > vp)[:, None], -ts, ts)
    votes = torch.maximum(vp, vm)
    floor = torch.clamp((0.5 * votes.max()).to(votes.dtype), min=1)
    costs = torch.where(votes >= floor, costs, torch.inf)
    best = torch.argmin(costs)
    return pick(Rs, best), pick(ts, best)
