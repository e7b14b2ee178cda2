"""``utils.jit``, the port's counterpart of ``jax.jit`` for
``tracker.track_step``, ``ba.solve`` and ``ba.solve_robust``, on the CPU.

  * The cache key changes with each static argument (the config,
    ``reject_px``, ``rounds``, the mesh, ``map_axis``), with a tensor
    argument's shape, dtype or device and with the RANSAC stream's kind,
    and with nothing else (tensor values, a generator's seed, an equal
    config made anew).
  * ``active``: a card only, outside ``disable_jit`` (nested, per
    thread) and outside a CUDA-graph capture.
  * On the CPU, under ``disable_jit`` and inside a capture the three
    entry points pass straight to their eager bodies (no cache is
    touched), and the results equal the reference's as
    tests/test_torch_tracker.py and tests/test_torch_ba.py hold them:
    the step on the reference's own RANSAC stream (``rng="threefry"``),
    the solves on tests/test_ba.py's problems.
  * The dispatch on a card, with the CPU standing in for it
    (``fake_card``: a capture runs the function once eagerly and a
    replay re-runs it on the graph's static inputs; the step graph runs
    its body eagerly): each entry point goes through the cache at its
    key, ``jit.Graph`` copies its inputs in and its outputs out (a result
    of call k is unchanged by call k + 1, the inputs are never written),
    and the eager loops of ``scan_driver`` stay eager.
  * ``clear_cache`` by key, and ``parallel.multihost.shutdown``, which
    drops the cached graphs that hold a mesh.

The real graphs are held bit-equal to the eager calls on the card by
tests/test_torch_jit_graph.py (``gpu``).
"""
import contextlib
import dataclasses
import threading
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_ba import K, _make_problem
from tests.test_torch_ba import _assert_solves_agree, _corrupted, _port
from vslam_tpu.config import BAConfig as JBAConfig
from vslam_tpu.config import small_config as jsmall_config
from vslam_tpu.datasets import synthetic as jsynthetic
from vslam_tpu.optimizer import ba as jba
from vslam_tpu.pipeline import tracker as jtracker
from vslam_tpu_torch.config import BAConfig, small_config
from vslam_tpu_torch.optimizer import ba
from vslam_tpu_torch.parallel import multihost
from vslam_tpu_torch.pipeline import scan_driver, tracker
from vslam_tpu_torch.utils import jit, profiling

torch.set_num_threads(2)

CFG = small_config()
KT = torch.from_numpy(K)
N_FRAMES = 3


# --- the key ------------------------------------------------------------

def _step_args(rng="torch", shape=None, dtype=torch.float32, device="cpu",
               seed=0, fill=0.0):
    st = tracker.init_state(CFG, "cpu", seed=seed, rng=rng)
    img = torch.full(shape or (CFG.camera.height, CFG.camera.width), fill,
                     dtype=dtype, device=device)
    return st, img


def _step_key(cfg=CFG, mesh=None, map_axis="map", **kw):
    st, img = _step_args(**kw)
    return jit.key(tracker.track_step,
                   dict(cfg=cfg, mesh=mesh, map_axis=map_axis), (st, img))


def _solve_key(cfg=BAConfig(), reject_px=5.0, rounds=2, points=None):
    p = _port(_make_problem()[0])
    if points is not None:
        p = p.replace(points=points(p.points))
    return jit.key(ba._robust_impl,
                   dict(cfg=cfg, reject_px=reject_px, rounds=rounds),
                   (p, KT))


KEY_CASES = {
    # (the changed key, whether it must equal the base key)
    "step: another config": (lambda: _step_key(cfg=CFG.replace(
        ransac=dataclasses.replace(CFG.ransac, num_hypotheses=64))), False),
    "step: a mesh": (lambda: _step_key(mesh=12345), False),
    "step: another map axis": (lambda: _step_key(map_axis="m"), False),
    "step: another image shape": (
        lambda: _step_key(shape=(CFG.camera.height, CFG.camera.width - 8)),
        False),
    "step: another image dtype": (lambda: _step_key(dtype=torch.float64),
                                  False),
    "step: another image device": (lambda: _step_key(device="meta"), False),
    "step: a Threefry stream": (lambda: _step_key(rng="threefry"), False),
    "step: another seed": (lambda: _step_key(seed=7), True),
    "step: other pixels": (lambda: _step_key(fill=0.5), True),
    "step: an equal config made anew": (lambda: _step_key(cfg=small_config()),
                                        True),
    "solve: another config": (lambda: _solve_key(cfg=BAConfig(iterations=3)),
                              False),
    "solve: another reject_px": (lambda: _solve_key(reject_px=3.0), False),
    "solve: another rounds": (lambda: _solve_key(rounds=3), False),
    "solve: another points shape": (
        lambda: _solve_key(points=lambda x: x[:-1]), False),
    "solve: another points dtype": (
        lambda: _solve_key(points=lambda x: x.double()), False),
    "solve: other point values": (lambda: _solve_key(points=lambda x: x + 1),
                                  True),
}


@pytest.mark.parametrize("case", list(KEY_CASES))
def test_key_changes_only_with_what_jit_keys_on(case):
    make, same = KEY_CASES[case]
    base = _step_key() if case.startswith("step") else _solve_key()
    hash(base)
    assert (make() == base) is same


def test_key_of_each_static_argument_in_place():
    """The key names the function and each static argument by name."""
    fn, statics, sig = _solve_key()
    assert fn is ba._robust_impl
    assert statics == (("cfg", BAConfig()), ("reject_px", 5.0),
                       ("rounds", 2))
    assert sig[-1] == ((3, 3), torch.float32, torch.device("cpu"))


# --- when a call replays ------------------------------------------------

@pytest.fixture
def capturing(monkeypatch):
    """``torch.cuda.is_current_stream_capturing`` under the test's control
    (this build has no CUDA; ``active`` asks it only for a card)."""
    flag = {"on": False}
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: flag["on"])
    return flag


def test_active_on_a_card_outside_disable_jit_and_captures(capturing):
    card = torch.device("cuda", 0)
    assert not jit.active("cpu")
    assert jit.active(card)
    with jit.disable_jit():
        assert not jit.active(card)
        with jit.disable_jit():
            assert not jit.active(card)
        assert not jit.active(card)
    assert jit.active(card)
    capturing["on"] = True
    assert not jit.active(card)


def test_disable_jit_is_per_thread(capturing):
    card = torch.device("cuda", 0)
    seen = []
    with jit.disable_jit():
        t = threading.Thread(target=lambda: seen.append(jit.active(card)))
        t.start()
        t.join(timeout=30)
    assert not t.is_alive() and seen == [True]


@pytest.fixture
def fake_card(monkeypatch, capturing):
    """The CPU standing in for a card: ``active`` treats a CPU device as a
    card (``disable_jit`` and the capture flag still apply), a capture
    runs its function once eagerly and a replay re-runs it, and the step
    graph runs its body eagerly. Returns the calls made into the cache
    and the capture flag."""
    real = jit.active
    monkeypatch.setattr(jit, "active", lambda dev: real(
        torch.device("cuda", 0) if torch.device(dev).type == "cpu" else dev))

    def capture(fn):
        with jit.disable_jit():
            fn()
        return types.SimpleNamespace(replay=fn)
    monkeypatch.setattr(profiling, "capture", capture)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())

    class StepGraph:
        def __init__(self, cfg, span=False, mesh=None, map_axis="map"):
            self.body = scan_driver._step_fn(cfg, mesh, map_axis)
            self.mesh, self.replays, self.frames = mesh, 0, []

        def run(self, state, store, frames):
            self.replays += 1
            self.frames.append(frames)
            return scan_driver._run(self.body, state, store, frames, None,
                                    eager=True)
    monkeypatch.setattr(scan_driver, "step_graph", StepGraph)
    calls = []
    real_lookup = jit.lookup
    monkeypatch.setattr(jit, "lookup", lambda k, build, graphs=None: (
        calls.append(k), real_lookup(k, build, graphs))[1])
    jit.clear_cache()
    yield types.SimpleNamespace(calls=calls, capturing=capturing)
    jit.clear_cache()


# --- eager paths against the reference ----------------------------------

@pytest.fixture(scope="module")
def sequence():
    jcfg = jsmall_config()
    Kc = jcfg.camera.K()
    scene = jsynthetic.make_scene(num_points=600, seed=0,
                                  extent=(14, 6, 40), z_min=6.0)
    poses = jsynthetic.make_trajectory(N_FRAMES, step=0.6, seed=0)
    frames = jsynthetic.render_sequence(Kc, poses, scene, jcfg.camera.width,
                                        jcfg.camera.height)
    sj = jtracker.bootstrap(jnp.asarray(frames[0]), jcfg)
    want = []
    for f in frames[1:]:
        sj, oj = jtracker.track_step(sj, jnp.asarray(f), jcfg)
        want.append(oj)
    return frames, want


def _port_steps(frames):
    st = tracker.bootstrap(frames[0], CFG, "cpu", rng="threefry")
    outs = []
    for f in frames[1:]:
        st, o = tracker.track_step(st, f, CFG)
        outs.append(o)
    return st, outs


def _assert_steps_agree(outs, want):
    """tests/test_torch_tracker.py's per-frame bounds."""
    for i, (o, oj) in enumerate(zip(outs, want), 1):
        assert bool(o.success) == bool(oj.success), i
        np.testing.assert_allclose(o.pose.numpy(), np.asarray(oj.pose),
                                   atol=1e-3, err_msg=f"frame {i}")
        assert abs(int(o.num_inliers) - int(oj.num_inliers)) <= 2, i
        assert abs(int(o.map_size) - int(oj.map_size)) <= 2, i


EAGER = {
    "cpu": lambda fc: contextlib.nullcontext(),
    "disable_jit": lambda fc: jit.disable_jit(),
    "capture": lambda fc: _flag(fc.capturing),
}


@contextlib.contextmanager
def _flag(capturing):
    capturing["on"] = True
    try:
        yield
    finally:
        capturing["on"] = False


def _eager_context(request, where):
    """The context of an eager call ``where`` names: the CPU as itself, or
    the stand-in card under ``disable_jit`` or inside a capture; and the
    list of cache lookups to check (None on the CPU)."""
    if where == "cpu":
        return contextlib.nullcontext(), None
    fc = request.getfixturevalue("fake_card")
    return EAGER[where](fc), fc.calls


@pytest.mark.parametrize("where", list(EAGER))
def test_track_step_eager_matches_reference(request, sequence, where):
    """``track_step`` on the reference's RANSAC stream, eager: no cache
    lookup, and every frame within test_torch_tracker.py's bounds of the
    reference's ``track_step``."""
    frames, want = sequence
    ctx, calls = _eager_context(request, where)
    with ctx:
        _, outs = _port_steps(frames)
    assert not calls and not jit.cache()
    _assert_steps_agree(outs, want)


@pytest.fixture(scope="module")
def reference_solves():
    problem, _, _, _ = _make_problem()
    kw = dict(iterations=12, schur_assembly="onehot")
    robust, _ = _corrupted()
    rkw = dict(iterations=8, schur_assembly="scatter")
    return {
        "solve": (problem, BAConfig(**kw), jba.solve(
            problem, jnp.asarray(K), JBAConfig(**kw))),
        "solve_robust": (robust, BAConfig(**rkw), jba.solve_robust(
            robust, jnp.asarray(K), JBAConfig(**rkw), reject_px=5.0,
            rounds=2)),
    }


def _solve(name, problem, cfg):
    if name == "solve":
        return ba.solve(problem, KT, cfg)
    return ba.solve_robust(problem, KT, cfg, reject_px=5.0, rounds=2)


@pytest.mark.parametrize("where", list(EAGER))
@pytest.mark.parametrize("name", ["solve", "solve_robust"])
def test_solves_eager_match_reference(request, reference_solves, name,
                                      where):
    """``ba.solve`` / ``ba.solve_robust`` eager: no cache lookup, and the
    result within test_torch_ba.py's bounds of the reference's."""
    problem, cfg, want = reference_solves[name]
    ctx, calls = _eager_context(request, where)
    with ctx:
        got = _solve(name, _port(problem), cfg)
    assert not calls and not jit.cache()
    _assert_solves_agree(got, want)


# --- the dispatch on a (stand-in) card ------------------------------------

def test_track_step_goes_through_the_cache(fake_card, sequence):
    """On a card ``track_step`` replays the step graph cached at its key,
    one per RANSAC stream kind; the image reaches it as a float32 frame
    batch of one, and the results are the graph's (here the eager body's,
    so within the reference's bounds)."""
    frames, want = sequence
    _, outs = _port_steps(frames)
    _assert_steps_agree(outs, want)
    (k,) = set(fake_card.calls)
    assert len(fake_card.calls) == N_FRAMES - 1
    assert k[0] is tracker.track_step
    assert dict(k[1]) == dict(cfg=CFG, mesh=None, map_axis="map")
    (g,) = jit.cache().values()
    assert g.replays == N_FRAMES - 1 and g.mesh is None
    assert all(f.shape == (1, CFG.camera.height, CFG.camera.width)
               and f.dtype == torch.float32 for f in g.frames)
    st = tracker.bootstrap(frames[0], CFG, "cpu")           # torch stream
    tracker.track_step(st, frames[1].astype(np.float64), CFG)
    assert len(jit.cache()) == 2


@pytest.mark.parametrize("name", ["solve", "solve_robust"])
def test_solves_go_through_the_cache(fake_card, reference_solves, name):
    """On a card a solve replays the ``jit.Graph`` cached at its key: the
    same results as the eager solve, bit for bit here (the stand-in
    replays the same eager body); a second call at the same key replays,
    another config captures anew; a result of call k is unchanged by call
    k + 1 and no input is written."""
    problem, cfg, _ = reference_solves[name]
    p1 = _port(problem)
    p2 = p1.replace(points=p1.points + 0.01)
    before = {n: x.clone() for n, x in jit.fields(p1)}
    with jit.disable_jit():
        want1, want2 = _solve(name, p1, cfg), _solve(name, p2, cfg)
    got1 = _solve(name, p1, cfg)
    kept = jit.tree_map(torch.clone, got1)
    got2 = _solve(name, p2, cfg)
    for got, want in ((got1, want1), (got2, want2)):
        for x, y in zip(jit.tensors(got), jit.tensors(want), strict=True):
            assert torch.equal(x, y)
    for x, y in zip(jit.tensors(got1), jit.tensors(kept), strict=True):
        assert torch.equal(x, y)
    assert all(torch.equal(x, before[n]) for n, x in jit.fields(p1))
    (g,) = jit.cache().values()
    assert isinstance(g, jit.Graph) and g.replays == 2
    assert not any(x is y for x in jit.tensors(got2)
                   for y in jit.tensors((g.args, g.out)))
    _solve(name, p1, dataclasses.replace(cfg, iterations=2))
    assert len(jit.cache()) == 2


def test_solve_with_a_numpy_K_keys_as_a_tensor(fake_card, reference_solves):
    problem, cfg, _ = reference_solves["solve"]
    ba.solve(_port(problem), K, cfg)
    ba.solve(_port(problem), KT, cfg)
    (k,) = set(fake_card.calls)
    assert k[2][-1] == ((3, 3), torch.float32, torch.device("cpu"))


def test_scan_driver_eager_loops_stay_eager(fake_card, sequence):
    """``scan_driver``'s eager loop (``track_frame`` without a graph, as
    ``SLAMSystem`` on a gloo mesh runs it) calls ``track_step`` under
    ``disable_jit``: no cache lookup on a card either."""
    frames, _ = sequence
    st = tracker.bootstrap(frames[0], CFG, "cpu")
    st, out, row = scan_driver.track_frame(st, torch.from_numpy(frames[1]),
                                           CFG)
    assert not fake_card.calls and not jit.cache()
    assert row.shape == (scan_driver.ROW,)


# --- freeing --------------------------------------------------------------

def test_clear_cache_and_free_captured():
    """``multihost.shutdown`` drops the cached graphs whose key holds a
    mesh (``jit.holds_mesh``), whose NCCL graphs ``free_captured`` then
    resets; the others stay until ``clear_cache``, which picks by key."""
    statics = dict(cfg=CFG, map_axis="map")
    meshed = jit.key(tracker.track_step, dict(statics, mesh=1), ())
    plain = jit.key(tracker.track_step, dict(statics, mesh=None), ())
    solve = jit.key(ba._solve_impl, dict(cfg=BAConfig()), ())
    assert [jit.holds_mesh(k) for k in (meshed, plain, solve)] == [
        True, False, False]
    jit.clear_cache()
    try:
        for k in (meshed, plain, solve):
            jit.lookup(k, object)
        g = jit.cache()[plain]
        assert jit.lookup(plain, lambda: None) is g      # cached
        multihost.shutdown()
        assert set(jit.cache()) == {plain, solve}
        jit.clear_cache(lambda k: k[0] is ba._solve_impl)
        assert set(jit.cache()) == {plain}
    finally:
        jit.clear_cache()
    assert not jit.cache()
