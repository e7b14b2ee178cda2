"""RANSAC's Gauss-Newton polish with its loop body in ``ops.sampson_gn``,
on the CPU.

On a CPU tensor ``sampson_gn.linearize`` and ``trial_cost`` are their
plain versions, the torch ops the loop ran inline, so the polish gives the
bits of the monolithic loop it came from (``torch_frozen.refine_pose_gn``).
The kernel behind them runs only on a card (tests/test_torch_polish_gpu.py);
its wrapper's checks run here. numpy, torch and the port only.
"""
import dataclasses

import pytest
import torch

import torch_frozen
from vslam_tpu_torch.config import VSLAMConfig
from vslam_tpu_torch.geometry import epipolar
from vslam_tpu_torch.ops import bench_kernels, sampson_gn
from vslam_tpu_torch.ops.bench_kernels import bits_equal

torch.set_num_threads(2)


def _assert_bits(got, want):
    for k, (x, y) in enumerate(zip(got, want)):
        assert bits_equal(x, y), k


@pytest.mark.parametrize("n", [1024, 3072])
def test_refine_pose_gn_is_the_frozen_loop(n):
    """13 starts, 10 iterations, invalid padding rows and a start whose
    residuals are NaN: R, t and the final costs bit for bit."""
    R, t, K, uv1, uv2, w = bench_kernels.polish_inputs("cpu", n)
    got = epipolar.refine_pose_gn(R, t, K, uv1, uv2, w, iters=10)
    want = torch_frozen.refine_pose_gn(R, t, K, uv1, uv2, w, iters=10)
    _assert_bits(got, want)
    cost = want[2]
    assert torch.isnan(cost[5]) and torch.isfinite(cost[:5]).all()  # premise
    assert not torch.equal(got[0][:5], R[:5])       # premise: steps taken


@pytest.mark.parametrize("n", [1024, 3072])
def test_refine_pose_gn_multistart_is_the_frozen_loop(n):
    """The multistart over the polish, 4 extra starts (one NaN), its fan
    around the first start: the chosen (R, t) bit for bit."""
    R, t, K, uv1, uv2, w = bench_kernels.polish_inputs("cpu", n)
    extra = (R[5:9], t[5:9])
    got = epipolar.refine_pose_gn_multistart(R[0], t[0], K, uv1, uv2, w,
                                             iters=10, extra_starts=extra)
    want = torch_frozen.refine_pose_gn_multistart(
        R[0], t[0], K, uv1, uv2, w, iters=10, extra_starts=extra)
    _assert_bits(got, want)
    assert torch.isfinite(want[0]).all()                # premise


@pytest.mark.parametrize("n", [256, 1024])
def test_plain_entries_are_the_inline_expressions(n):
    """``linearize_plain`` gives the loop's inline H, g and cost(r), and
    ``trial_cost_plain`` its cost(_sampson_res(delta)), bit for bit."""
    R, t, x1, x2, valid, c = bench_kernels.polish_rays("cpu", n)
    S = R.shape[0]
    z = torch.zeros((S, 5))
    r = torch_frozen._sampson_res(z, R, t, x1, x2)
    q = r / c
    rw = valid / (1.0 + q * q)
    J = torch_frozen._sampson_jac(z, R, t, x1, x2)
    Jw = J * rw[..., None]
    H = Jw.transpose(-1, -2) @ J
    g = torch.einsum("snk,sn->sk", Jw, r)
    cost = lambda r: torch.sum(valid * 0.5 * (c * c) * torch.log1p(
        (r / c) * (r / c)), dim=-1)
    _assert_bits(sampson_gn.linearize(R, t, x1, x2, valid, c),
                 (H, g, cost(r)))
    gen = torch.Generator().manual_seed(n)
    for scale in (0.0, 1e-5, 0.3):           # so3_exp's two branches
        delta = torch.randn((S, 5), generator=gen) * scale
        want = cost(torch_frozen._sampson_res(delta, R, t, x1, x2))
        assert bits_equal(sampson_gn.trial_cost(delta, R, t, x1, x2, valid,
                                                c), want)
    assert bits_equal(sampson_gn.t_basis(t), torch_frozen._t_basis(t))


BAD = {
    "f64": lambda a: dict(x1=a["x1"].double()),
    "R_rank": lambda a: dict(R=a["R"][0]),
    "t_shape": lambda a: dict(t=a["t"][:, :2].contiguous()),
    "valid_length": lambda a: dict(valid=a["valid"][1:]),
    "c_shape": lambda a: dict(c=a["c"][None]),
    "no_starts": lambda a: dict(R=a["R"][:0], t=a["t"][:0],
                                delta=a["delta"][:0]),
    "no_matches": lambda a: dict(x1=a["x1"][:0], x2=a["x2"][:0],
                                 valid=a["valid"][:0]),
    "x1_strided": lambda a: dict(x1=torch.cat([a["x1"]] * 2, 1)[:, ::2]),
    "R_expanded": lambda a: dict(R=a["R"][:1].expand(a["R"].shape)),
    "delta_shape": lambda a: dict(delta=a["delta"][:, :4].contiguous()),
    "cpu": lambda a: {},
}


@pytest.mark.parametrize("bad", list(BAD))
def test_kernel_wrappers_refuse_out_of_scope(bad):
    """``linearize_cuda`` and ``trial_cost_cuda`` raise, before any launch,
    on what the kernel does not take (the device is checked last, so this
    runs on the CPU), and the dispatchers' checks refuse the same inputs
    on the CPU."""
    R, t, x1, x2, valid, c = bench_kernels.polish_rays("cpu", 64)
    args = dict(R=R, t=t, x1=x1, x2=x2, valid=valid, c=c,
                delta=torch.zeros((R.shape[0], 5)))
    args.update(BAD[bad](args))
    delta = args.pop("delta")
    before = sampson_gn.launches
    with pytest.raises(ValueError):
        sampson_gn.trial_cost_cuda(delta, **args)
    if bad != "cpu":
        with pytest.raises(ValueError):
            sampson_gn.trial_cost(delta, **args)
    if bad != "delta_shape":
        with pytest.raises(ValueError):
            sampson_gn.linearize_cuda(**args)
    if bad not in ("cpu", "delta_shape"):
        with pytest.raises(ValueError):
            sampson_gn.linearize(**args)
    assert sampson_gn.launches == before


def test_step_calls_are_a_default_step():
    """``sampson_gn.STEP_CALLS``, the table the card's checks and races
    read, is the (starts, matches, iterations, polishes) of every call one
    default-config tracking step makes on the CPU (its map cut to 4096
    slots, which the polish never reads), and ``STEP_LAUNCHES`` its 21
    launches."""
    cfg = VSLAMConfig()
    cfg = cfg.replace(map=dataclasses.replace(cfg.map, capacity=4096))
    frames = torch.from_numpy(torch_frozen.frames(2, 2, cfg))
    calls = bench_kernels.step_polish_calls(frames, cfg, "cpu")
    assert bench_kernels.polish_shapes(calls) == sampson_gn.STEP_CALLS
    assert len(calls) == sampson_gn.STEP_LAUNCHES == 21
    assert all(x.dtype == torch.float32 and x.is_contiguous()
               for _, args in calls for x in args)


@pytest.mark.parametrize("names,want", [
    ("LTLTT", ((13, 64, 2, 1),)), ("T", ((13, 64, 0, 1),)),
    ("LTTLTT", ((13, 64, 1, 2),)), ("LTLTTLTT", ((13, 64, 2, 1),
                                                (13, 64, 1, 1)))])
def test_polish_shapes_reads_call_sequences(names, want):
    R, t, x1, x2, valid, c = bench_kernels.polish_rays("cpu", 64)
    lin = ("linearize", [R, t, x1, x2, valid, c])
    trial = ("trial_cost", [torch.zeros((13, 5)), R, t, x1, x2, valid, c])
    calls = [lin if ch == "L" else trial for ch in names]
    assert bench_kernels.polish_shapes(calls) == want
