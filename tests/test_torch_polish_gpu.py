"""The polish kernel (``csrc/sampson_gn.cu``) against the torch ops it
replaces (``ops.sampson_gn.linearize_plain``, ``trial_cost_plain``), on a
card.

Every test here is marked ``gpu`` and skips without a CUDA device (the
kernel has no CPU mode; tests/test_torch_polish.py holds the plain versions
to the polish's frozen loop on the CPU). The module imports no jax; run it
on the card with

    python -m pytest tests/test_torch_polish_gpu.py -m gpu --noconftest -q -s

  * every call real tracking steps of each configuration make
    (``kitti00_mono``, 3072 matches; ``tum_fr1_mono``, 1024), recorded
    while the kernel runs them;
  * edge cases: no valid match, NaN and inf residuals of masked matches,
    ``den`` at its clamp, N not a multiple of the block, one start;
  * two replays of a captured linearisation and trial cost give equal bits;
  * a default step graph captures 21 launches;
  * whole polishes over 300 frames of each configuration's cell traffic,
    the kernel path against the plain one (printed as one JSON line).

Tolerance (``bench_kernels.polish_gap``). The kernel sums the N matches
in its own fixed order and rounds each match's dual arithmetic in its own
order; the residual's and the Jacobian's dot products cancel in it as much
as in the plain version. Against the plain version evaluated in float64,
and over the sum of each entry's terms' magnitudes, the kernel's widest
error in each output may be twice the plain version's widest plus
(N + 64) 2^-24 (a recursive f32 sum of N terms is within N 2^-24 of their
magnitudes' sum in any order), and it is NaN exactly where the plain
version is.
"""
import importlib
import json
import os

import pytest
import torch

import torch_frozen
from vslam_tpu_torch.config import VSLAMConfig
from vslam_tpu_torch.geometry import epipolar
from vslam_tpu_torch.ops import bench_kernels, sampson_gn
from vslam_tpu_torch.ops.bench_kernels import bits_equal

pytestmark = pytest.mark.gpu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = ("kitti00_mono", "tum_fr1_mono")


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _load(*parts):
    with open(os.path.join(ROOT, "slambench", *parts)) as f:
        return json.load(f)


def _config(name):
    return VSLAMConfig.from_json(json.dumps(_load("configs",
                                                  f"{name}.json")["vslam"]))


def _check_call(name, args):
    """The kernel's launch against the plain version on ``args``
    (``bench_kernels.polish_gap``): the widest ratio of a gap to the
    tolerance above, which must be <= 1."""
    worst, got = bench_kernels.polish_gap(name, args)
    if name == "linearize":
        assert bits_equal(got[0], got[0].mT)           # symmetric
    return worst


@pytest.fixture(scope="module", params=CONFIGS)
def step_calls(request, cuda):
    """(config name, every ``sampson_gn`` call 3 eager steps of it make)."""
    cfg = _config(request.param)
    frames = torch.from_numpy(torch_frozen.frames(4, 2, cfg)).to(cuda)
    return request.param, bench_kernels.step_polish_calls(frames, cfg, cuda)


def test_kernel_matches_plain_on_step_calls(step_calls):
    name, calls = step_calls
    N = {"kitti00_mono": 3072, "tum_fr1_mono": 1024}[name]
    assert bench_kernels.polish_shapes(calls) == ((13, N, 10, 3),)
    worst = max(_check_call(entry, args) for entry, args in calls)
    print(f"\n{name}: {len(calls)} calls, widest gap {worst:.4g} of the "
          f"tolerance")
    assert worst <= 1.0


def _edge(name, cuda):
    R, t, x1, x2, valid, c = bench_kernels.polish_rays(cuda, 3072)
    if name == "no_valid":
        valid = torch.zeros_like(valid)
    elif name == "nan_masked":                 # NaN residuals, valid 0
        x1[7] = torch.nan
        valid[7] = 0.0
    elif name == "inf_masked":
        x2[100, 1] = torch.inf
        valid[100] = 0.0
    elif name == "den_clamp":                  # Ex1 = E^T x2 = 0, and tiny
        x1[:64] = 0.0
        x2[:64] = 0.0
        x1[64:128] *= 1e-10
        x2[64:128] *= 1e-10
    elif name == "finite_starts":
        R, t = R[:5], t[:5]
    return R, t, x1, x2, valid, c


EDGES = ("no_valid", "nan_masked", "inf_masked", "den_clamp",
         "finite_starts")


@pytest.mark.parametrize("name", EDGES)
def test_kernel_matches_plain_on_edge_cases(cuda, name):
    args = _edge(name, cuda)
    assert _check_call("linearize", list(args)) <= 1.0
    gen = torch.Generator(device="cpu").manual_seed(1)
    delta = (torch.randn((args[0].shape[0], 5), generator=gen) * 1e-3)
    assert _check_call("trial_cost", [delta.to(cuda), *args]) <= 1.0
    if name in ("nan_masked", "inf_masked"):   # the masking multiplies
        assert torch.isnan(sampson_gn.linearize(*args)[2]).all()


@pytest.mark.parametrize("S,N", [(13, 1), (13, 77), (13, 1000), (1, 3072),
                                 (13, 4097), (2, 129)])
def test_kernel_matches_plain_at_any_shape(cuda, S, N):
    R, t, x1, x2, valid, c = bench_kernels.polish_rays(cuda, N, seed=S + N)
    R, t = R[:S].contiguous(), t[:S].contiguous()
    if S > 5:
        R, t = R.clone(), t.clone()
        R[5] = torch.eye(3, device=cuda)               # every start finite
    assert _check_call("linearize", [R, t, x1, x2, valid, c]) <= 1.0
    delta = torch.full((S, 5), 1e-3, device=cuda)
    assert _check_call("trial_cost", [delta, R, t, x1, x2, valid, c]) <= 1.0


def test_kernel_replays_in_a_cuda_graph_to_the_bit(cuda):
    """Captured once, replayed on new data: each replay equals the eager
    launch on that data bit for bit, and a second replay on the same data
    equals the first."""
    static = list(bench_kernels.polish_rays(cuda, 3072))
    delta = torch.full((13, 5), 1e-3, device=cuda)
    sampson_gn.linearize(*static)                       # the library loaded
    graph = torch.cuda.CUDAGraph()
    before = sampson_gn.launches
    with torch.cuda.graph(graph):
        out = sampson_gn.linearize(*static) + (
            sampson_gn.trial_cost(delta, *static),)
    assert sampson_gn.launches == before + 2
    replays = []
    for seed in (5, 6, 6):
        for x, y in zip(static, bench_kernels.polish_rays(cuda, 3072, seed)):
            x.copy_(y)
        graph.replay()
        torch.cuda.synchronize()
        replays.append([x.clone() for x in out])
        eager = sampson_gn.linearize(*static) + (
            sampson_gn.trial_cost(delta, *static),)
        assert all(bits_equal(x, y) for x, y in zip(replays[-1], eager))
    assert all(bits_equal(x, y) for x, y in zip(replays[1], replays[2]))
    assert not torch.equal(replays[0][2][:5], replays[1][2][:5])  # premise


def test_kernel_refuses_inputs_outside_its_scope(cuda):
    R, t, x1, x2, valid, c = bench_kernels.polish_rays(cuda, 64)
    before = sampson_gn.launches
    for bad in (dict(x1=x1.double()), dict(R=R[:1].expand(R.shape)),
                dict(valid=valid[1:]), dict(c=c[None]),
                dict(x1=x1[:0], x2=x2[:0], valid=valid[:0]),
                dict(x2=x2.cpu())):
        args = dict(R=R, t=t, x1=x1, x2=x2, valid=valid, c=c)
        args.update(bad)
        with pytest.raises(ValueError):
            sampson_gn.linearize(**args)
    assert sampson_gn.launches == before


def test_default_step_graph_captures_21_launches(cuda):
    from vslam_tpu_torch.pipeline.slam import SLAMSystem
    cfg = VSLAMConfig()
    frames = torch.from_numpy(torch_frozen.frames(3, 2, cfg)).to(cuda)
    s = SLAMSystem(cfg, cuda)
    for f in frames:
        s.process(f)
    assert s.step_graph.replays == len(frames) - 1
    assert s.step_graph.captured_launches["sampson_gn"] \
        == sampson_gn.STEP_LAUNCHES == 21


# ---- whole polishes, kernel path against plain path -------------------------

PARITY_CELLS = (("kitti00_mono", "drive"), ("tum_fr1_mono", "xyz"))
PARITY_FRAMES = 301


def _traced(monkeypatch, run, entries, a, kw):
    """``run(*a, **kw)`` through the given ``sampson_gn`` entries, with its
    decisions (trial cost < cost, per iteration and start) and the
    multistart's chosen start."""
    costs, best = [], []
    linearize, trial_cost = entries
    pick = epipolar.pick

    def lin(*args):
        out = linearize(*args)
        costs.append(out[2])
        return out

    def trial(*args):
        out = trial_cost(*args)
        costs.append(out)
        return out

    def picked(x, i):
        best.append(int(i))
        return pick(x, i)

    with monkeypatch.context() as m:
        m.setattr(sampson_gn, "linearize", lin)
        m.setattr(sampson_gn, "trial_cost", trial)
        m.setattr(epipolar, "pick", picked)
        got = run(*a, **kw)
    decisions = torch.stack([costs[i + 1] < costs[i]
                             for i in range(0, len(costs) - 1, 2)])
    return got, decisions, best[0]


def _polish_parity(cuda, monkeypatch, cfg_name, traffic, n_frames, seed):
    """The cell's frames through an eager system with window BA off; at
    every polish, the kernel path (whose result the step keeps) and the
    plain path on the same inputs."""
    doc = _load("configs", f"{cfg_name}.json")
    cfg = VSLAMConfig.from_json(json.dumps(doc["vslam"]))
    tr = _load("traffic", f"{traffic}.json")
    gen = importlib.import_module(f"slambench.traffic.{tr['generator']}")
    render = importlib.import_module("slambench.traffic.render")
    _, frames = gen.make(tr, doc["vslam"]["camera"], n_frames, seed, cuda)
    run = epipolar.refine_pose_gn_multistart
    kernel = (sampson_gn.linearize, sampson_gn.trial_cost)
    plain = (sampson_gn.linearize_plain, sampson_gn.trial_cost_plain)
    rep = dict(config=cfg_name, traffic=traffic, seed=seed, polishes=0,
               rotation_gap=0.0, translation_gap=0.0, flips=0,
               decisions=0, chosen_differ=0, tracked=0)

    def both(*a, **kw):
        got, dk, bk = _traced(monkeypatch, run, kernel, a, kw)
        want, dp, bp = _traced(monkeypatch, run, plain, a, kw)
        rep["polishes"] += 1
        rep["decisions"] += dk.numel()
        rep["flips"] += int((dk != dp).sum())
        rep["chosen_differ"] += int(bk != bp)
        rep["rotation_gap"] = max(rep["rotation_gap"], float(
            (got[0] - want[0]).abs().max()))
        rep["translation_gap"] = max(rep["translation_gap"], float(
            (got[1] - want[1]).abs().max()))
        return got

    s = torch_frozen.EagerProcess(cfg, cuda, enable_ba=False)
    with monkeypatch.context() as m:
        m.setattr(epipolar, "refine_pose_gn_multistart", both)
        for f in frames:
            info = s.process(render.to_float(f))
            rep["tracked"] += int(info.get("success", False))
    return rep


@pytest.mark.parametrize("cfg_name,traffic", PARITY_CELLS)
def test_whole_polishes_kernel_against_plain(cuda, monkeypatch, cfg_name,
                                            traffic):
    rep = _polish_parity(cuda, monkeypatch, cfg_name, traffic,
                         PARITY_FRAMES, seed=2 ** 31 + 77)
    print("\npolish parity " + json.dumps(rep))
    assert rep["polishes"] == PARITY_FRAMES - 1
    assert rep["tracked"] >= 0.9 * (PARITY_FRAMES - 1)       # premise
