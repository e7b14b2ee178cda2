"""The port's own copies on the captured step, removed value for value.

A contiguous same-dtype ``clone`` / ``copy_`` on a card is a
``cudaMemcpyAsync``: a memcpy node in a CUDA graph capture, one more node
of the ~30000 the step's graph replays (a replay's time in its slow mode
grows by ~0.35 us a node, PERF.md §6). The functions rewritten
without such copies (Jacobi's rounds out of place, ``torch.cat`` and
``torch.where`` in place of a clone and a slice assignment, the graph's
write-back as one foreach copy a dtype) must return what they returned
before, bit for bit: each is held here, with ``torch.equal`` and no
tolerance, to a frozen copy of its previous version, on numpy-seeded
inputs, and four whole steps with the new functions to four with the old
ones. The comparisons with the JAX package stay in the other test files
at their tolerances. The ``gpu`` cases hold the same functions to their
frozen copies on the card, and capture ``scan_driver.step_graph`` at
``small_config()`` from the default stream, read its nodes by type and
hold its replays to eager ``track_step`` on the card.
"""
import dataclasses

import numpy as np
import pytest
import torch

from vslam_tpu_torch.config import small_config
from vslam_tpu_torch.core import lie, types
from vslam_tpu_torch.ops import jacobi
from vslam_tpu_torch.pipeline import scan_driver
from vslam_tpu_torch.utils import jit

torch.set_num_threads(2)

# --- the previous versions, frozen -------------------------------------


def _old_round_step(A, V, ps, qs, pair_mask):
    diag = torch.diagonal(A, dim1=-2, dim2=-1)
    app = diag[..., ps]
    aqq = diag[..., qs]
    apq = A[..., ps, qs]
    safe = torch.where(torch.abs(apq) < 1e-30, 1e-30, 2.0 * apq)
    tau = (aqq - app) / safe
    t = -torch.sign(tau) / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
    t = torch.where(tau == 0.0, 1.0, t)
    c = torch.rsqrt(1.0 + t * t)
    s = t * c
    tiny = torch.abs(apq) < 1e-30
    c = torch.where(tiny, 1.0, c)
    s = torch.where(tiny, 0.0, s)

    cc = c[..., None]
    ss = s[..., None]
    A = A.clone()
    rp = A[..., ps, :]
    rq = A[..., qs, :]
    A[..., ps, :] = cc * rp + ss * rq
    A[..., qs, :] = -ss * rp + cc * rq
    cp = A[..., :, ps].transpose(-1, -2)
    cq = A[..., :, qs].transpose(-1, -2)
    A[..., :, ps] = (cc * cp + ss * cq).transpose(-1, -2)
    A[..., :, qs] = (-ss * cp + cc * cq).transpose(-1, -2)
    A = torch.where(pair_mask, 0.0, A)

    V = V.clone()
    vp = V[..., :, ps].transpose(-1, -2)
    vq = V[..., :, qs].transpose(-1, -2)
    V[..., :, ps] = (cc * vp + ss * vq).transpose(-1, -2)
    V[..., :, qs] = (-ss * vp + cc * vq).transpose(-1, -2)
    return A, V


def _old_rounds(n, device):
    out = []
    for pairs in jacobi._round_robin_schedule(n):
        hit = {(p, q) for p, q in pairs} | {(q, p) for p, q in pairs}
        mask = [[(i, j) in hit for j in range(n)] for i in range(n)]
        out.append((torch.tensor([p for p, _ in pairs], device=device),
                    torch.tensor([q for _, q in pairs], device=device),
                    torch.tensor(mask, device=device)))
    return out


def old_jacobi_eigh(A, sweeps=8):
    n = A.shape[-1]
    V = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape)
    rounds = _old_rounds(n, A.device)
    for _ in range(sweeps):
        for ps, qs, pair_mask in rounds:
            A, V = _old_round_step(A, V, ps, qs, pair_mask)
    evals = torch.diagonal(A, dim1=-2, dim2=-1)
    order = torch.argsort(evals, dim=-1, stable=True)
    return (torch.take_along_dim(evals, order, dim=-1),
            torch.take_along_dim(V, order[..., None, :], dim=-1))


def old_null_vector(A, sweeps=8):
    AtA = torch.einsum("...ji,...jk->...ik", A, A)
    _, V = old_jacobi_eigh(AtA, sweeps=sweeps)
    V2 = V[..., :, :2]
    B = torch.einsum("...ij,...jk->...ik", A, V2)
    a = torch.sum(B[..., 0] * B[..., 0], dim=-1)
    b = torch.sum(B[..., 0] * B[..., 1], dim=-1)
    c = torch.sum(B[..., 1] * B[..., 1], dim=-1)
    d = a - c
    lmax = 0.5 * (a + c) + torch.sqrt(0.25 * (d * d) + b * b)
    det = a * c - b * b
    lam = det / torch.clamp(lmax, min=1e-30)
    use2 = torch.abs(c - lam) >= torch.abs(a - lam)
    vx = torch.where(use2, c - lam, b)
    vy = torch.where(use2, -b, lam - a)
    deg = (vx * vx + vy * vy) == 0.0
    vx = torch.where(deg, 1.0, vx)
    vy = torch.where(deg, 0.0, vy)
    nrm = torch.sqrt(vx * vx + vy * vy)
    coef = torch.stack([vx / nrm, vy / nrm], dim=-1)
    x = torch.einsum("...nk,...k->...n", V2, coef)
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-30)


def old_rank2_project(F, sweeps=8):
    FtF = torch.einsum("...ji,...jk->...ik", F, F)
    v3 = old_jacobi_eigh(FtF, sweeps=sweeps)[1][..., :, 0]
    eye = torch.eye(3, dtype=F.dtype, device=F.device)
    proj = eye - v3[..., :, None] * v3[..., None, :]
    return torch.einsum("...ij,...jk->...ik", F, proj)


def old_svd3(E, sweeps=10):
    EtE = torch.einsum("...ji,...jk->...ik", E, E)
    w, V = old_jacobi_eigh(EtE, sweeps=sweeps)
    S = torch.sqrt(torch.clamp(w.flip(-1), min=0.0))
    Vd = V.flip(-1)
    Ev = torch.einsum("...ij,...jk->...ik", E, Vd)
    u1 = Ev[..., :, 0] / torch.clamp(S[..., 0:1], min=1e-12)
    u2 = Ev[..., :, 1] / torch.clamp(S[..., 1:2], min=1e-12)
    u1 = u1 / (torch.linalg.vector_norm(u1, dim=-1, keepdim=True) + 1e-12)
    u2 = u2 - torch.sum(u1 * u2, dim=-1, keepdim=True) * u1
    u2 = u2 / (torch.linalg.vector_norm(u2, dim=-1, keepdim=True) + 1e-12)
    u3_cross = torch.linalg.cross(u1, u2, dim=-1)
    Ev3 = Ev[..., :, 2]
    degen = S[..., 2] < 1e-6 * torch.clamp(S[..., 0], min=1e-12)
    sign = torch.where(torch.sum(u3_cross * Ev3, dim=-1) < 0, -1.0, 1.0)
    u3 = torch.where(degen[..., None], u3_cross, sign[..., None] * u3_cross)
    U = torch.stack([u1, u2, u3], dim=-1)
    return U, S, Vd.transpose(-1, -2)


def old_scatter_drop(base, idx, values, accumulate=False):
    buf = torch.empty((base.shape[0] + 1,) + tuple(base.shape[1:]),
                      dtype=base.dtype, device=base.device)
    buf[:-1] = base
    buf.index_put_((idx,), values.to(base.dtype).expand(
        (idx.shape[0],) + tuple(base.shape[1:])), accumulate=accumulate)
    return buf[:-1]


def old_last_writes(idx, dump):
    order = torch.sort(idx, stable=True).indices
    s = idx[order]
    last = torch.ones_like(s, dtype=torch.bool)
    last[:-1] = s[1:] != s[:-1]
    keep = torch.empty_like(last).scatter_(0, order, last)
    return torch.where(keep, idx, dump)


def old_orthonormalize_T(T, iters=2):
    R = T[..., :3, :3]
    eye = torch.eye(3, dtype=T.dtype, device=T.device)
    for _ in range(iters):
        R = R @ (1.5 * eye - 0.5 * R.transpose(-1, -2) @ R)
    out = T.clone()
    out[..., :3, :3] = R
    return out


def old_with_translation(T, t):        # tracker's dT_scaled
    out = T.clone()
    out[:3, 3] = t
    return out


def old_with_rotation(T, R):           # tracker's rotation blend
    out = T.clone()
    out[:3, :3] = R
    return out


# --- inputs --------------------------------------------------------------


def _batch(seed, shape, sym):
    """(B, ...) float32 matrices from a numpy seed, with the Jacobi
    rotation's special cases mixed in: an exact zero matrix, a diagonal
    one (every apq below 1e-30), equal diagonal entries (tau = 0), a
    rank-deficient one and negative zeros."""
    rng = np.random.RandomState(seed)
    X = rng.randn(48, *shape).astype(np.float32)
    X[1] *= 1e3
    X[2] *= 1e-3
    X[3, ..., -1] = 0.0                         # rank deficient
    if sym:
        X = np.einsum("bji,bjk->bik", X, X)
        n = shape[-1]
        X[4] = 0.0
        X[5] = np.diag(rng.randn(n)).astype(np.float32)
        X[6] = np.eye(n, dtype=np.float32) + 0.5
        X[7] = -0.0
    else:
        X[4] = 0.0
        X[5, ..., 0] = -0.0
    return torch.from_numpy(X)


CASES = ([("jacobi_eigh", n, s) for n in (3, 4, 9) for s in (4, 6, 7, 8, 10)]
         + [("null_vector", n, s) for n in (3, 4, 9)
            for s in (4, 6, 7, 8, 10)]
         + [("rank2_project", 3, s) for s in (4, 6, 7, 8, 10)]
         + [("svd3", 3, s) for s in (4, 6, 7, 8, 10)])


def _check_bit_equal(fn, n, sweeps, dev):
    seed = 1000 * n + sweeps
    if fn == "jacobi_eigh":
        args = (_batch(seed, (n, n), sym=True),)
        new, old = jacobi.jacobi_eigh, old_jacobi_eigh
    elif fn == "null_vector":
        args = (_batch(seed, (n + 3, n), sym=False),)
        new, old = jacobi.null_vector, old_null_vector
    elif fn == "rank2_project":
        args = (_batch(seed, (3, 3), sym=False),)
        new, old = jacobi.rank2_project, old_rank2_project
    else:
        args = (_batch(seed, (3, 3), sym=False),)
        new, old = jacobi.svd3, old_svd3
    args = tuple(a.to(dev) for a in args)
    before = [a.clone() for a in args]
    got = new(*args, sweeps=sweeps)
    want = old(*args, sweeps=sweeps)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert torch.equal(g, w), (fn, n, sweeps)
    for a, b in zip(args, before):
        assert torch.equal(a, b)


@pytest.mark.parametrize("fn,n,sweeps", CASES)
def test_bit_equal_to_previous_version(fn, n, sweeps):
    """Each rewritten function returns its previous version's values bit
    for bit (``torch.equal``, no tolerance), and leaves its input as it
    was."""
    _check_bit_equal(fn, n, sweeps, "cpu")


def _pose(rng):
    w = rng.randn(3).astype(np.float32)
    T = lie.make_T(lie.so3_exp(torch.from_numpy(w)),
                   torch.from_numpy(rng.randn(3).astype(np.float32)))
    return T + torch.from_numpy(1e-3 * rng.randn(4, 4).astype(np.float32))


HELPERS = ("scatter_drop", "scatter_drop_accumulate", "scatter_drop_empty",
           "last_writes",
           "orthonormalize_T", "with_translation", "with_rotation",
           "copy_into")


def _check_helper(name, seed, dev):
    rng = np.random.RandomState(seed)
    if name == "scatter_drop_empty":              # every write dropped
        args = (torch.zeros((0, 5)), torch.zeros(7, dtype=torch.long),
                torch.from_numpy(rng.randn(7, 5).astype(np.float32)), False)
        new, old = types.scatter_drop, old_scatter_drop
    elif name.startswith("scatter_drop"):
        base = torch.from_numpy(rng.randn(64, 5).astype(np.float32))
        idx = torch.from_numpy(rng.randint(0, 65, 40))   # 64: dropped
        idx[:4] = idx[4]                                 # collisions
        vals = torch.from_numpy(rng.randn(40, 5).astype(np.float32))
        acc = name.endswith("accumulate")
        if not acc:
            idx = types.last_writes(idx, 64)
        args = (base, idx, vals, acc)
        new, old = types.scatter_drop, old_scatter_drop
    elif name == "last_writes":
        idx = torch.from_numpy(rng.randint(0, 20, 300))
        args = (idx, 20)
        new, old = types.last_writes, old_last_writes
    elif name == "orthonormalize_T":
        T = torch.stack([_pose(rng) for _ in range(6)])
        args = (T,)
        new, old = lie.orthonormalize_T, old_orthonormalize_T
    elif name == "with_translation":
        args = (_pose(rng), torch.from_numpy(rng.randn(3).astype(
            np.float32)))
        new, old = lie.with_translation, old_with_translation
    elif name == "with_rotation":
        args = (_pose(rng), lie.so3_exp(torch.from_numpy(
            rng.randn(3).astype(np.float32))))
        new, old = lie.with_rotation, old_with_rotation
    else:
        from vslam_tpu_torch.core.types import empty_features
        src = empty_features(6, "cpu").replace(
            uv=torch.from_numpy(rng.randn(6, 2).astype(np.float32)),
            desc=torch.from_numpy(rng.randint(-9, 9, (6, 8)).astype(
                np.int32)),
            mask=torch.from_numpy(rng.rand(6) > 0.5),
            angle=torch.from_numpy(np.array([-0.0, 1, 2, 3, 4, 5],
                                            np.float32)))
        src = scan_driver._map(lambda t: t.to(dev), src)

        def run(copy):
            dst = empty_features(6, dev)
            copy(dst, src)
            return tuple(t for _, t in _tensors(dst))
        args = ()
        new = lambda: run(scan_driver._copy_into)
        old = lambda: run(lambda d, s: [a.copy_(b) for (_, a), (_, b) in
                                        zip(_tensors(d), _tensors(s))])
    args = tuple(a.to(dev) if isinstance(a, torch.Tensor) else a
                 for a in args)
    before = [a.clone() for a in args if isinstance(a, torch.Tensor)]
    got, want = new(*args), old(*args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    for a, b in zip([a for a in args if isinstance(a, torch.Tensor)],
                    before):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", HELPERS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_helper_bit_equal_to_previous_version(name, seed):
    """The step's helpers rewritten without a clone or a copy into a slice
    return what the previous versions returned, bit for bit, and leave
    their inputs as they were; colliding and dropped writes included."""
    _check_helper(name, seed, "cpu")


CFG = small_config()


def _frames(n, seed=2):
    from vslam_tpu_torch.datasets import synthetic
    scene = synthetic.make_scene(num_points=700, seed=seed,
                                 extent=(14, 6, 45), z_min=6.0)
    poses = synthetic.make_trajectory(n, step=0.6, yaw_rate=0.01, seed=seed)
    return torch.from_numpy(np.stack(synthetic.render_sequence(
        CFG.camera.K(), poses, scene, CFG.camera.width, CFG.camera.height)))


def _tensors(obj, path=""):
    out = []
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out += _tensors(v, path + f.name + ".")
        elif isinstance(v, torch.Tensor):
            out.append((path + f.name, v))
    return out


def _run_steps(frames, dev="cpu", rng="torch"):
    from vslam_tpu_torch.pipeline import tracker
    st = tracker.bootstrap(frames[0].to(dev), CFG, dev, rng=rng)
    rows = []
    with jit.disable_jit():             # eager on a card too
        for t in range(1, frames.shape[0]):
            st, _, row, _ = scan_driver.step_body(st, None,
                                                  frames[t].to(dev), CFG)
            rows.append(row)
    return st, torch.stack(rows)


def test_track_steps_bit_equal_to_previous_helpers(monkeypatch):
    """Four ``track_step``s of ``small_config()`` with the rewritten Jacobi
    and helpers against the same steps with their previous versions put
    back: every per-frame row and every field of the final state equal
    bit for bit."""
    frames = _frames(5)
    got_state, got_rows = _run_steps(frames)
    monkeypatch.setattr(jacobi, "jacobi_eigh", old_jacobi_eigh)
    monkeypatch.setattr(types, "scatter_drop", old_scatter_drop)
    monkeypatch.setattr(types, "last_writes", old_last_writes)
    monkeypatch.setattr(lie, "orthonormalize_T", old_orthonormalize_T)
    from vslam_tpu_torch.mapping import point_map
    from vslam_tpu_torch.pipeline import tracker
    for mod in (point_map, tracker):
        for name, fn in (("scatter_drop", old_scatter_drop),
                         ("last_writes", old_last_writes)):
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, fn)
    want_state, want_rows = _run_steps(frames)
    assert scan_driver.ChunkScalars.unpack(
        got_rows.numpy()).success.sum() >= 3          # premise: it tracks
    assert torch.equal(got_rows, want_rows)
    for (name, a), (_, b) in zip(_tensors(got_state), _tensors(want_state)):
        assert torch.equal(a, b), name


# --- on the card ---------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs and the copy kernels "
                    "have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("fn,n,sweeps", CASES)
def test_bit_equal_to_previous_version_on_cuda(cuda, fn, n, sweeps):
    """``test_bit_equal_to_previous_version`` on the card."""
    _check_bit_equal(fn, n, sweeps, cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("name", HELPERS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_helper_bit_equal_to_previous_version_on_cuda(cuda, name, seed):
    """``test_helper_bit_equal_to_previous_version`` on the card."""
    _check_helper(name, seed, cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("rng", ["torch", "threefry"])
def test_step_graph_nodes_and_replay_on_cuda(cuda, rng):
    """``scan_driver.step_graph`` at ``small_config()``, captured and
    replayed from the default stream as ``SLAMSystem`` does (the graph
    keeps its own stream): its nodes by type are read from the driver
    (kernels, and the memcpy / memset nodes that PyTorch's own operators
    record), and its replays equal eager ``track_step`` on the card bit
    for bit."""
    frames = _frames(5)
    want_state, want_rows = _run_steps(frames, cuda, rng)
    from vslam_tpu_torch.pipeline import tracker
    g = scan_driver.step_graph(CFG)
    st0 = tracker.bootstrap(frames[0].to(cuda), CFG, cuda, rng=rng)
    got_state, got_rows = scan_driver.carried(st0, frames[1:].to(cuda), CFG,
                                              g)
    assert g.nodes["kernel"] > 1000, g.nodes
    assert set(g.nodes) <= {"kernel", "memcpy", "memset"}, g.nodes
    assert torch.equal(got_rows, want_rows)
    for (name, a), (_, b) in zip(_tensors(got_state), _tensors(want_state)):
        assert torch.equal(a, b), name
