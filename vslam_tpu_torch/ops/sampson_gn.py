"""RANSAC's Gauss-Newton polish: one LM iteration's linearisation and the
robust cost of a trial step, for every start at once.

``geometry.epipolar.refine_pose_gn`` polishes S starts (R, t) on
SO(3) x S^2 against the Cauchy-robust Sampson error of N matches. Each of
its iterations calls ``linearize`` (the normal equations H (S, 5, 5),
g (S, 5) and the cost (S,) at the current poses) and ``trial_cost`` (the
cost at the poses moved by the solved step); its final cost is
``trial_cost`` at a zero step. Everything the iteration decides (the damped
solve, lambda, the accept test, the retraction) stays with the caller.

``linearize_plain`` and ``trial_cost_plain`` are the loop body's torch ops
as the polish ran them inline: ``sampson_res``, ``sampson_jac`` (five
forward-mode JVPs), ``Jw^T J`` and the cost, ~1,200 kernels an iteration on
a card. On a CUDA tensor ``linearize`` and ``trial_cost`` launch
``csrc/sampson_gn.cu`` once each (f32, any S, N >= 1), which computes the
same mathematics by dual arithmetic and sums the matches in its own fixed
order, so its results agree with the plain versions to rounding; on the
CPU they are the plain versions. ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..core import lie
from . import _build

launches = 0

# (starts, matches, iterations, polishes a step) of the tracking step's
# polish at the default config: RANSAC's winner, its 8-direction fan and
# the LO's 4 decompositions, over every match slot, once a step
STEP_CALLS = ((13, 3072, 10, 1),)

# the kernel's launches in one tracking step of the default config: a
# polish launches a linearisation and a trial cost an iteration, and its
# final cost
STEP_LAUNCHES = sum(n * (2 * iters + 1) for _, _, iters, n in STEP_CALLS)


def t_basis(t):
    """(…, 3, 2) orthonormal basis of the plane orthogonal to unit t."""
    ax = torch.argmin(torch.abs(t), dim=-1)
    e = (torch.arange(3, device=t.device) == ax[..., None]).to(t.dtype)
    b1 = torch.linalg.cross(t, e, dim=-1)
    b1 = b1 / (torch.linalg.vector_norm(b1, dim=-1, keepdim=True) + 1e-12)
    b2 = torch.linalg.cross(t, b1, dim=-1)
    return torch.stack([b1, b2], dim=-1)


def sampson_res(params, R0, t0, x1, x2):
    """Signed normalized Sampson residuals (S, N) of S starts perturbed by
    params (S, 5) = (rotation tangent, translation-direction tangent)."""
    dw, dt = params[:, :3], params[:, 3:]
    Rn = R0 @ lie.so3_exp(dw)
    tn = t0 + (t_basis(t0) @ dt[:, :, None])[..., 0]
    tn = tn / (torch.linalg.vector_norm(tn, dim=-1, keepdim=True) + 1e-12)
    E = lie.hat(tn) @ Rn
    Ex1 = torch.einsum("sij,nj->sni", E, x1)
    Etx2 = torch.einsum("sji,nj->sni", E, x2)
    num = torch.einsum("ni,sni->sn", x2, Ex1)
    den = (Ex1[..., 0] * Ex1[..., 0] + Ex1[..., 1] * Ex1[..., 1]
           + Etx2[..., 0] * Etx2[..., 0] + Etx2[..., 1] * Etx2[..., 1])
    return num / torch.sqrt(torch.clamp(den, min=1e-18))


def sampson_jac(params, R0, t0, x1, x2):
    """(S, N, 5) Jacobian of ``sampson_res`` by forward-mode AD, one JVP
    per tangent parameter (the starts are independent, so a tangent that
    moves parameter k of every start gives column k for all of them)."""
    f = lambda p: sampson_res(p, R0, t0, x1, x2)
    eye = torch.eye(5, dtype=params.dtype, device=params.device)
    cols = [torch.func.jvp(f, (params,), (eye[k].expand_as(params),))[1]
            for k in range(5)]
    return torch.stack(cols, dim=-1)


def robust_cost(r, valid, c):
    """(S,) Cauchy cost of residuals r (S, N): sum of valid c^2/2
    log1p((r / c)^2)."""
    q = r / c
    return torch.sum(valid * 0.5 * (c * c) * torch.log1p(q * q), dim=-1)


def linearize_plain(R, t, x1, x2, valid, c):
    """(H (S, 5, 5), g (S, 5), cost (S,)) of the starts (R, t) at zero in
    their tangent parameters: the IRLS normal equations of the Cauchy
    weights valid / (1 + (r / c)^2), as torch ops."""
    z = torch.zeros((R.shape[0], 5), dtype=R.dtype, device=R.device)
    r = sampson_res(z, R, t, x1, x2)                      # (S, N)
    q = r / c
    rw = valid / (1.0 + q * q)
    J = sampson_jac(z, R, t, x1, x2)                      # (S, N, 5)
    Jw = J * rw[..., None]
    H = Jw.transpose(-1, -2) @ J                          # (S, 5, 5)
    g = torch.einsum("snk,sn->sk", Jw, r)
    return H, g, robust_cost(r, valid, c)


def trial_cost_plain(delta, R, t, x1, x2, valid, c):
    """(S,) cost of the starts moved by delta (S, 5), as torch ops."""
    return robust_cost(sampson_res(delta, R, t, x1, x2), valid, c)


def check(R, t, x1, x2, valid, c, delta=None):
    """Raise ValueError unless R (S, 3, 3), t (S, 3), x1, x2 (N, 3),
    valid (N,), c () and delta (S, 5) are contiguous f32 with S, N >= 1
    on one device: what the kernel takes."""
    S = R.shape[0] if R.dim() else 0
    N = x1.shape[0] if x1.dim() else 0
    want = {"R": (R, (S, 3, 3)), "t": (t, (S, 3)), "x1": (x1, (N, 3)),
            "x2": (x2, (N, 3)), "valid": (valid, (N,)), "c": (c, ())}
    if delta is not None:
        want["delta"] = (delta, (S, 5))
    for name, (x, shape) in want.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: want {shape}, got {tuple(x.shape)}")
        if x.dtype != torch.float32:
            raise ValueError(f"{name}: want float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: want a contiguous tensor")
        if x.device != R.device:
            raise ValueError(f"{name} on {x.device}, R on {R.device}")
    if S < 1 or N < 1:
        raise ValueError(f"want at least one start and one match, got "
                         f"S={S}, N={N}")


@functools.lru_cache(maxsize=None)
def _entry(name, n_args):
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.declare(name, [p] * n_args + [i, i, p])


def _launch(name, args, out, S, N, device):
    global launches
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    stream = torch.cuda.current_stream(device).cuda_stream
    ptrs = [x.data_ptr() for x in args + out]
    with torch.cuda.device(device):
        err = _entry(name, len(ptrs))(*ptrs, S, N, stream)
    _build.check(err, f"{name} kernel")
    launches += 1


def linearize_cuda(R, t, x1, x2, valid, c):
    """``linearize_plain`` on the card in one launch."""
    check(R, t, x1, x2, valid, c)
    S, N = R.shape[0], x1.shape[0]
    H = torch.empty((S, 5, 5), dtype=R.dtype, device=R.device)
    g = torch.empty((S, 5), dtype=R.dtype, device=R.device)
    cost = torch.empty((S,), dtype=R.dtype, device=R.device)
    _launch("vslam_sampson_linearize", [R, t, x1, x2, valid, c],
            [H, g, cost], S, N, R.device)
    return H, g, cost


def trial_cost_cuda(delta, R, t, x1, x2, valid, c):
    """``trial_cost_plain`` on the card in one launch."""
    check(R, t, x1, x2, valid, c, delta)
    S, N = R.shape[0], x1.shape[0]
    cost = torch.empty((S,), dtype=R.dtype, device=R.device)
    _launch("vslam_sampson_trial_cost", [delta, R, t, x1, x2, valid, c],
            [cost], S, N, R.device)
    return cost


def linearize(R, t, x1, x2, valid, c):
    """The kernel on a CUDA tensor, the plain version on the CPU (both
    after ``check``)."""
    if R.device.type == "cpu":
        check(R, t, x1, x2, valid, c)
        return linearize_plain(R, t, x1, x2, valid, c)
    return linearize_cuda(R, t, x1, x2, valid, c)


def trial_cost(delta, R, t, x1, x2, valid, c):
    """The kernel on a CUDA tensor, the plain version on the CPU (both
    after ``check``)."""
    if R.device.type == "cpu":
        check(R, t, x1, x2, valid, c, delta)
        return trial_cost_plain(delta, R, t, x1, x2, valid, c)
    return trial_cost_cuda(delta, R, t, x1, x2, valid, c)
