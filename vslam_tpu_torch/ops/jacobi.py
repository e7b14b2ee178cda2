"""Batched small symmetric eigendecomposition via cyclic Jacobi sweeps.

Port of ``vslam_tpu/ops/jacobi.py``, sweep for sweep: the same round-robin
schedule, the same algebraic Givens rotations and the same fixed sweep
counts. The 8-point fits deliberately run unconverged (4 sweeps inside
RANSAC), so ``torch.linalg.eigh`` would give other hypotheses; this keeps
the reference's arithmetic instead.

``jacobi_eigh_plain`` is the sweeps as torch ops, ~50 kernels a round. On a
CUDA tensor ``jacobi_eigh`` runs them as one launch of ``csrc/jacobi.cu``,
which reads the schedule as ``_partner_table`` packs it and gives the plain
version's bits (f32, 2 <= n <= 9, any leading batch shape; anything else
on the card raises). On the CPU it is the plain version. ``launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..core.types import device_constant
from . import _build

launches = 0

MAX_N = 9           # csrc/jacobi.cu's largest matrix

# (shape, sweeps) of the tracking step's calls at the default config, in
# order: RANSAC's fits (A^T A, then F^T F), stage 1's svd3, the LO's
# weighted 8-point (A^T A, F^T F) and its svd3, then the two
# triangulations (ops.bench_kernels.step_eigh_inputs records them)
STEP_CALLS = (((1024, 9, 9), 4), ((1024, 3, 3), 4), ((1024, 3, 3), 10),
              ((9, 9), 6), ((3, 3), 8), ((3, 3), 10),
              ((3072, 4, 4), 7), ((3072, 4, 4), 7))


@functools.lru_cache(maxsize=None)
def _round_robin_schedule(n):
    """Rounds of disjoint (p, q) pairs covering all n(n-1)/2 pairs
    (circle-method tournament, identical to the reference)."""
    m = n + (n % 2)
    players = list(range(m))
    rounds = []
    for _ in range(m - 1):
        pairs = []
        for i in range(m // 2):
            a, b = players[i], players[m - 1 - i]
            if a < n and b < n:
                pairs.append((min(a, b), max(a, b)))
        rounds.append(tuple(pairs))
        players = [players[0]] + [players[-1]] + players[1:-1]
    return tuple(rounds)


@functools.lru_cache(maxsize=None)
def _rounds(n, device):
    """The schedule as device tensors, per round: ps, qs (the round's
    pairs), ``pair_of`` (n,) the pair each index belongs to (0 for the idle
    index of an odd n), ``sign`` (n,) -1 at the qs and 1 elsewhere,
    ``partner`` (n,) q for p, p for q and i for an idle i, ``paired`` (n,)
    True but at the idle index, and ``pair_mask`` (n, n) True at the
    round's (p, q) and (q, p) entries."""
    out = []
    for pairs in _round_robin_schedule(n):
        hit = {(p, q) for p, q in pairs} | {(q, p) for p, q in pairs}
        mask = tuple(tuple((i, j) in hit for j in range(n)) for i in range(n))
        pair_of, sign, partner = [0] * n, [1.0] * n, list(range(n))
        for k, (p, q) in enumerate(pairs):
            pair_of[p] = pair_of[q] = k
            sign[q] = -1.0
            partner[p], partner[q] = q, p
        out.append(tuple(device_constant(v, dt, device) for v, dt in (
            (tuple(p for p, _ in pairs), torch.long),
            (tuple(q for _, q in pairs), torch.long),
            (tuple(pair_of), torch.long), (tuple(sign), torch.float32),
            (tuple(partner), torch.long),
            (tuple(i != j for i, j in enumerate(partner)), torch.bool),
            (mask, torch.bool))))
    return out


def _rotate(X, c, s, partner, paired, dim):
    """The round's rotations applied along ``dim`` (-2: rows, -1: columns)
    of X, out of place: index i becomes ``c_i X_i + s_i X_partner(i)`` where
    it is paired, with (c_i, s_i) = (c, s) at a p and (c, -s) at a q, so p'
    = c X_p + s X_q and q' = -s X_p + c X_q; an idle index keeps X_i."""
    rot = c * X + s * X.index_select(dim, partner)
    return torch.where(paired[:, None] if dim == -2 else paired, rot, X)


def _round_step(A, V, ps, qs, pair_of, sign, partner, paired, pair_mask):
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

    # per index of the matrix: its pair's c, and s signed for a p or a q
    # (x -s is exact, so q' = -s X_p + c X_q as the reference rounds it)
    ci = c.index_select(-1, pair_of)
    si = s.index_select(-1, pair_of) * sign
    # the rows, then the columns of the rotated rows, every write out of
    # place: no tensor of the caller's is modified and none is cloned (a
    # clone is a device-to-device memcpy, a copy node in a CUDA graph)
    A = _rotate(A, ci[..., :, None], si[..., :, None], partner, paired, -2)
    A = _rotate(A, ci[..., None, :], si[..., None, :], partner, paired, -1)
    # zero the rotated pairs by a constant mask: assigning a host scalar
    # through advanced indexing would copy it to the device (a sync)
    A = torch.where(pair_mask, 0.0, A)
    V = _rotate(V, ci[..., None, :], si[..., None, :], partner, paired, -1)
    return A, V


@functools.lru_cache(maxsize=None)
def _partner_table(n):
    """The schedule as the kernel reads it: per round, each index's partner
    in its pair, or the index itself when it sits the round out."""
    rows = []
    for pairs in _round_robin_schedule(n):
        row = list(range(n))
        for p, q in pairs:
            row[p], row[q] = q, p
        rows.append(tuple(row))
    return tuple(rows)


@functools.lru_cache(maxsize=None)
def _table(n, device):
    return device_constant(_partner_table(n), torch.int8, device)


@functools.lru_cache(maxsize=1)
def _entry():
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return _build.declare("vslam_jacobi",
                          [p, ll, ll, ll, p, i, i, i, p, p, ll, p])


def jacobi_eigh_cuda(A, sweeps: int = 8):
    """``jacobi_eigh_plain`` on the card in one launch, bit for bit."""
    global launches
    n = A.shape[-1]
    if A.dim() < 2 or A.shape[-2] != n or not 2 <= n <= MAX_N:
        raise ValueError(f"A: want (..., n, n) with 2 <= n <= {MAX_N}, got "
                         f"{tuple(A.shape)}")
    if A.dtype != torch.float32:
        raise ValueError(f"A: want float32, got {A.dtype}")
    if A.device.type != "cuda":
        raise ValueError(f"unsupported device {A.device}")
    lead = A.shape[:-2]
    A3 = A.reshape(-1, n, n)            # a view wherever the strides allow
    evals = torch.empty(lead + (n,), dtype=A.dtype, device=A.device)
    vecs = torch.empty(A.shape, dtype=A.dtype, device=A.device)
    if A3.shape[0] == 0:
        return evals, vecs
    table = _table(n, A.device)
    stream = torch.cuda.current_stream(A.device).cuda_stream
    with torch.cuda.device(A.device):
        err = _entry()(A3.data_ptr(), *A3.stride(), table.data_ptr(), n,
                       table.shape[0], sweeps, evals.data_ptr(),
                       vecs.data_ptr(), A3.shape[0], stream)
    _build.check(err, "jacobi kernel")
    launches += 1
    return evals, vecs


def jacobi_eigh(A, sweeps: int = 8):
    """Symmetric eigendecomposition of (..., n, n), n small.

    Returns (eigvals (..., n) ascending, eigvecs (..., n, n) with columns as
    eigenvectors), like torch.linalg.eigh. The kernel on a CUDA tensor, the
    plain version on the CPU.
    """
    if A.device.type == "cpu":
        return jacobi_eigh_plain(A, sweeps)
    return jacobi_eigh_cuda(A, sweeps)


def jacobi_eigh_plain(A, sweeps: int = 8):
    """``jacobi_eigh`` as torch ops: every round of every sweep, then a
    stable argsort and the gathers it orders."""
    n = A.shape[-1]
    V = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape)
    rounds = _rounds(n, A.device)
    for _ in range(sweeps):
        for r in rounds:
            A, V = _round_step(A, V, *r)
    evals = torch.diagonal(A, dim1=-2, dim2=-1)
    order = torch.argsort(evals, dim=-1, stable=True)
    evals_sorted = torch.take_along_dim(evals, order, dim=-1)
    V_sorted = torch.take_along_dim(V, order[..., None, :], dim=-1)
    return evals_sorted, V_sorted


def smallest_eigvec(A, sweeps: int = 8):
    """Eigenvector of the smallest eigenvalue of symmetric (..., n, n)."""
    _, V = jacobi_eigh(A, sweeps=sweeps)
    return V[..., :, 0]


def null_vector(A, sweeps: int = 8):
    """Least-squares null vector of (..., M, n), with the reference's 2-dim
    Rayleigh-Ritz refinement against A itself (see vslam_tpu.ops.jacobi)."""
    AtA = torch.einsum("...ji,...jk->...ik", A, A)
    _, V = jacobi_eigh(AtA, sweeps=sweeps)
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


def rank2_project(F, sweeps: int = 8):
    """Nearest rank-2 matrix (Frobenius) to (..., 3, 3): F (I - v3 v3^T)."""
    FtF = torch.einsum("...ji,...jk->...ik", F, F)
    v3 = smallest_eigvec(FtF, sweeps=sweeps)
    eye = torch.eye(3, dtype=F.dtype, device=F.device)
    proj = eye - v3[..., :, None] * v3[..., None, :]
    return torch.einsum("...ij,...jk->...ik", F, proj)


def svd3(E, sweeps: int = 10):
    """Full SVD of (..., 3, 3) from one symmetric eigendecomposition
    (S descending; u3 by cross product when sigma3 ~ 0)."""
    EtE = torch.einsum("...ji,...jk->...ik", E, E)
    w, V = jacobi_eigh(EtE, sweeps=sweeps)
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
