"""Direct calls of ``tracker.track_step``, ``ba.solve`` and
``ba.solve_robust`` on a card replay graphs cached by ``utils.jit``, bit
for bit equal to the same calls eager (``utils.jit.disable_jit``).

Every test here is marked ``gpu`` and skips without a CUDA device (CUDA
graphs and the hand kernels have no CPU mode; tests/test_torch_jit.py
holds the keys, the dispatch and the eager paths on the CPU). The module
imports no jax; run them on the card with

    python -m pytest tests/test_torch_jit_graph.py -m gpu --noconftest -q

  * ``track_step`` over several frames, the torch and the Threefry RANSAC
    streams, both front-end variants, ``small_config()`` and the default
    config: every output, the final state and the generator's state equal
    to the eager steps'; one graph captured (K1 and K2 once each), then
    one replay a call and no eager launch.
  * A state returned by call k is unchanged after call k + 1 (and the
    input state after call k).
  * Two states with generators of their own, interleaved, draw what each
    draws alone.
  * ``ba.solve`` / ``ba.solve_robust`` through the cache, both Schur
    assemblies: bit-equal to the eager solve where two eager solves are
    bit-equal (the scatter assembly's float atomics add in no fixed
    order), else within phase 9's bounds; a second call replays.
  * ``track_step(mesh=)`` on a one-rank NCCL mesh, in a spawned process
    (``torch_dist.run_on_card``): replays of the sharded step's graph
    bit-equal to the eager sharded steps, and ``multihost.shutdown``
    drops the cached graph.
"""
import dataclasses

import numpy as np
import pytest
import torch

import torch_dist
import torch_frozen
from vslam_tpu_torch import ops
from vslam_tpu_torch.config import BAConfig, VSLAMConfig, small_config
from vslam_tpu_torch.optimizer import ba
from vslam_tpu_torch.pipeline import tracker
from vslam_tpu_torch.utils import jit

pytestmark = pytest.mark.gpu

_SMALL = small_config()
CASES = {
    "torch": (_SMALL, "torch"),
    "threefry": (_SMALL, "threefry"),
    "variants": (_SMALL.replace(frontend=dataclasses.replace(
        _SMALL.frontend, oriented=True, track_carry=True)), "torch"),
    "default": (VSLAMConfig(), "torch"),
}
N_FRAMES = 5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs and the hand kernels "
                    "have no CPU mode)")
    jit.clear_cache()
    yield torch.device("cuda", 0)
    jit.clear_cache()


def _frames(cfg, dev, n=N_FRAMES, seed=2):
    return torch.from_numpy(torch_frozen.frames(n, seed, cfg)).to(dev)


def _steps(cfg, rng, frames, seed=0, eager=False):
    """bootstrap + ``track_step`` over ``frames``: (states, outputs), the
    steps eager under ``disable_jit`` or else direct."""
    st = tracker.bootstrap(frames[0], cfg, frames.device, seed=seed, rng=rng)
    states, outs = [st], []
    for f in frames[1:]:
        if eager:
            with jit.disable_jit():
                st, o = tracker.track_step(st, f, cfg)
        else:
            st, o = tracker.track_step(st, f, cfg)
        states.append(st)
        outs.append(o)
    return states, outs


def _differs(a, b):
    """Names of the tensors (and the generator's state) where two states
    differ."""
    out = [n for (n, x), (_, y) in zip(torch_frozen.tensors(a),
                                       torch_frozen.tensors(b))
           if not torch.equal(x, y)]
    if isinstance(a.key, torch.Generator) and not torch.equal(
            a.key.get_state(), b.key.get_state()):
        out.append("key")
    return out


def _outs_differ(oa, ob):
    return [(i, k) for i, (x, y) in enumerate(zip(oa, ob))
            for k, u, v in zip(x._fields, x, y) if not torch.equal(u, v)]


@pytest.mark.parametrize("case", list(CASES))
def test_track_step_replays_bit_equal_to_eager(cuda, case):
    cfg, rng = CASES[case]
    frames = _frames(cfg, cuda)
    want_states, want = _steps(cfg, rng, frames, eager=True)
    before = ops.launch_counts()
    got_states, got = _steps(cfg, rng, frames[:2])
    (g,) = jit.cache().values()
    assert g.captured_launches == {"hamming": 1, "associate": 1, "jacobi": 8,
                                  "sampson_gn": 21}
    assert ops.launches_since(before) == {          # warm-up + capture
        "hamming": 2, "associate": 2, "jacobi": 16, "sampson_gn": 42}
    launched = ops.launch_counts()
    st = got_states[-1]
    for f in frames[2:]:
        st, o = tracker.track_step(st, f, cfg)
        got_states.append(st)
        got.append(o)
    assert ops.launch_counts() == launched             # replays only
    assert g.replays == N_FRAMES - 1 and g.span_ms() > 0
    assert _outs_differ(got, want) == []
    assert _differs(got_states[-1], want_states[-1]) == []
    assert sum(bool(o.success) for o in got) >= N_FRAMES - 2   # premise


def test_returned_states_stay_as_they_were(cuda):
    cfg, rng = CASES["threefry"]
    frames = _frames(cfg, cuda)
    st0 = tracker.bootstrap(frames[0], cfg, cuda, rng=rng)
    kept0 = jit.tree_map(torch.clone, st0)
    st1, o1 = tracker.track_step(st0, frames[1], cfg)
    kept1 = jit.tree_map(torch.clone, (st1, o1))
    st2, o2 = tracker.track_step(st1, frames[2], cfg)
    tracker.track_step(st2, frames[3], cfg)
    assert _differs(st0, kept0) == []
    assert _differs(st1, kept1[0]) == []
    assert _outs_differ([o1], [kept1[1]]) == []
    assert _differs(st1, st2)                  # premise: the state moved


def test_states_with_own_generators_draw_independently(cuda):
    cfg = _SMALL
    fa, fb = _frames(cfg, cuda, 4, seed=2), _frames(cfg, cuda, 4, seed=3)
    want_a, oa = _steps(cfg, "torch", fa, seed=1, eager=True)
    want_b, ob = _steps(cfg, "torch", fb, seed=2, eager=True)
    a = tracker.bootstrap(fa[0], cfg, cuda, seed=1)
    b = tracker.bootstrap(fb[0], cfg, cuda, seed=2)
    ga, gb = [], []
    for x, y in zip(fa[1:], fb[1:]):
        a, o = tracker.track_step(a, x, cfg)
        ga.append(o)
        b, o = tracker.track_step(b, y, cfg)
        gb.append(o)
    (g,) = jit.cache().values()
    assert g.replays == 2 * 3
    assert _outs_differ(ga, oa) == [] and _outs_differ(gb, ob) == []
    assert _differs(a, want_a[-1]) == [] and _differs(b, want_b[-1]) == []


def _problem(dev):
    from vslam_tpu_torch.tools import bench_ba
    problem, K = bench_ba.make_problem(20, 1024, 16, device=dev)
    return problem, torch.from_numpy(K).to(dev)


def _solve(name, problem, K, cfg):
    if name == "solve":
        return ba.solve(problem, K, cfg)
    return ba.solve_robust(problem, K, cfg, reject_px=5.0, rounds=2)


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(
        jit.tensors(a), jit.tensors(b), strict=True))


@pytest.mark.parametrize("assembly", ["onehot", "scatter"])
@pytest.mark.parametrize("name", ["solve", "solve_robust"])
def test_solves_replay_bit_equal_to_eager(cuda, name, assembly):
    problem, K = _problem(cuda)
    cfg = BAConfig(iterations=6, schur_assembly=assembly)
    with jit.disable_jit():
        want = _solve(name, problem, K, cfg)
        again = _solve(name, problem, K, cfg)
    got = _solve(name, problem, K, cfg)
    (g,) = jit.cache().values()
    assert g.replays == 1 and g.capture_s > 0
    if _same(want, again):
        assert _same(got, want)
    else:                   # the scatter assembly's atomics: phase 9's bounds
        (gp, gs), (wp, ws) = got, want
        assert abs(float(gs.initial_cost) - float(ws.initial_cost)) \
            <= 1e-4 * float(ws.initial_cost)
        assert abs(float(gs.final_cost) - float(ws.final_cost)) \
            <= 1e-3 * float(ws.final_cost)
    kept = jit.tree_map(torch.clone, got)
    moved = problem.replace(points=problem.points + 0.01)
    _solve(name, moved, K, cfg)
    assert g.replays == 2 and _same(got, kept)
    assert float(got[1].final_cost) < float(got[1].initial_cost)


@pytest.mark.parametrize("rng", ["torch", "threefry"])
def test_meshed_track_step_replays_bit_equal(cuda, tmp_path, rng):
    payload = dict(cfg=_SMALL.to_json(), rng=rng,
                   frames=torch_frozen.frames(N_FRAMES, cfg=_SMALL))
    r = torch_dist.run_on_card(torch_dist.card_jit_step_case, payload,
                               str(tmp_path))
    assert r["backend"] == "nccl"
    assert r["has_mesh"] and r["replays"] == N_FRAMES - 1
    assert r["captured_launches"] == {"hamming": 1, "associate": 1,
                                      "jacobi": 8, "sampson_gn": 21}
    assert r["differs"] == []
    assert r["cached_after_shutdown"] == 0
    assert not np.array_equal(r["poses"][0], r["poses"][-1])    # premise
