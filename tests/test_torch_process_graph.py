"""``SLAMSystem.process`` through ``scan_driver``'s step graph, and window
BA's ``solve_robust`` as a captured graph, against frozen copies of the
eager versions.

On the CPU ``process`` goes through the same plumbing as on a card
(``scan_driver.track_frame`` over ``step_body``, the packed row, the
``TrackOutput`` it returns) with the step run eagerly; here it is held to
``EagerProcess`` (tests/torch_frozen.py), a frozen copy of the driver as
it was before (eager ``tracker.track_step``, one ``torch.cat`` fetch): the
same info dicts (apart from ``wall_s``), metrics records, trajectory,
keyframe store, state and last output, exactly. The config adds structure refinement and
a map of 512 slots to the small config, so every case has a solved
window-BA event, a structure refinement and a maintenance pass.

The ``gpu`` cases hold, on the card, ``process`` replaying its captured
step to the same frames through the eager step, bit for bit, and the
captured ``solve_robust`` to the eager one. The module imports no jax;
run them there with

    python -m pytest tests/test_torch_process_graph.py -m gpu --noconftest -q
"""
import dataclasses

import numpy as np
import pytest
import torch

from torch_frozen import CASES, CFG, EagerProcess
from torch_frozen import assert_same_run as _assert_same_run
from torch_frozen import frames as _frames
from torch_frozen import premises as _premises
from torch_frozen import run as _run
from torch_frozen import strip as _strip
from torch_frozen import tensors as _tensors
from vslam_tpu_torch import ops
from vslam_tpu_torch.optimizer import ba
from vslam_tpu_torch.pipeline import keyframes, slam
from vslam_tpu_torch.utils import checkpoint, jit

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def frames():
    return _frames()


@pytest.mark.parametrize("case", list(CASES))
def test_process_matches_frozen_eager_process(frames, case):
    """The CPU: ``process`` through ``scan_driver.track_frame`` equals the
    frozen eager driver, with window BA, structure refinement and
    maintenance in the run."""
    cfg, rng = CASES[case]
    a, ia, oa = _run(slam.SLAMSystem, cfg, rng, frames, "cpu")
    b, ib, ob = _run(EagerProcess, cfg, rng, frames, "cpu")
    _premises(a, ia)
    assert a.step_graph is None and a.ba_graphs == {}
    assert not any("capture_s" in x for x in ia)
    _assert_same_run(a, ia, oa, b, ib, ob)


def test_solve_wrapper_on_cpu_is_solve_robust(frames):
    """``SLAMSystem._solve_robust`` on the CPU is ``ba.solve_robust``:
    every output equal, at both of the system's settings (window BA and
    structure refinement), and no graph is made."""
    s = _run(slam.SLAMSystem, CFG, "torch", frames[:10], "cpu")[0]
    wp = keyframes.build_window_problem(
        s.kf_store, s.state.map, CFG, free_tail=CFG.ba.free_cams,
        prov_min_obs=99)
    for cfg_ba, reject_px in ((CFG.ba, 5.0),
                              (dataclasses.replace(CFG.ba, iterations=6),
                               3.0)):
        got_p, got = s._solve_robust(wp.problem, cfg_ba, reject_px, 2)
        want_p, want = ba.solve_robust(wp.problem, s._K, cfg_ba,
                                       reject_px=reject_px, rounds=2)
        _assert_same_solve(got_p, got, want_p, want)
    assert int(wp.problem.point_mask.sum()) > 0      # premise: a problem
    assert s.ba_graphs == {}


def _assert_same_solve(got_p, got, want_p, want):
    for name, x in _tensors(got_p):
        assert torch.equal(x, getattr(want_p, name)), name
    for name, x, y in zip(ba.BAStats._fields, got, want):
        assert torch.equal(x, y), name


# --- on the card ---------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs and the hand kernels "
                    "have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
def test_process_graph_bit_equal_to_eager_step_on_cuda(cuda, frames, case):
    """On the card: ``process`` replaying its captured step equals the
    same frames through the eager ``track_step`` with the same host logic
    (``EagerProcess``), bit for bit. The step graph is captured at the
    bootstrap frame, once, and replayed once per tracked frame: the
    kernels' wrappers launch only in the bootstrap frame's warm-up and
    capture. Every window solve replays a graph cached by its key: one for
    window BA, one for structure refinement."""
    cfg, rng = CASES[case]
    b, ib, ob = _run(EagerProcess, cfg, rng, frames, cuda)
    s = slam.SLAMSystem(cfg, cuda, rng=rng)
    ia = [s.process(torch.from_numpy(frames[0]).to(cuda))]
    g = s.step_graph
    assert g.graph is not None and ia[0]["capture_s"] == g.capture_s > 0
    before = ops.launch_counts()
    oa = []
    for f in frames[1:]:
        ia.append(s.process(torch.from_numpy(f).to(cuda)))
        oa.append(s.last_output)
    assert ops.launch_counts() == before          # no eager step ran
    assert g.replays == len(frames) - 1
    assert g.captured_launches == {"hamming": 1, "associate": 1, "jacobi": 8,
                                  "sampson_gn": 21}
    assert not any("capture_s" in x for x in ia[1:])
    _assert_same_run(s, ia, oa, b, ib, ob)
    solved = _premises(s, ia)
    n_struct = sum(r["kind"] == "structure_refine"
                   for r in s.metrics.records)
    assert len(s.ba_graphs) == 2
    assert sum(x.replays for x in s.ba_graphs.values()) \
        == len(solved) + n_struct


def _window_problem(dev, frames):
    s = _run(slam.SLAMSystem, CFG, "torch", frames[:10], dev)[0]
    wp = keyframes.build_window_problem(
        s.kf_store, s.state.map, CFG, free_tail=CFG.ba.free_cams,
        prov_min_obs=99)
    assert int(wp.problem.point_mask.sum()) > 0      # premise: a problem
    return s, wp.problem


@pytest.mark.gpu
def test_solve_graph_bit_equal_to_eager_on_cuda(cuda, frames):
    """Two eager ``solve_robust``s on the card are bit-equal to each
    other, and the captured solve is bit-equal to them: the solved poses
    and points, both masks and every ``BAStats`` field. A second call at
    the same key replays the cached graph and captures none; another
    ``reject_px`` is another key."""
    s, p = _window_problem(cuda, frames)
    s.ba_graphs.clear()
    with jit.disable_jit():
        want_p, want = ba.solve_robust(p, s._K, CFG.ba, reject_px=5.0,
                                       rounds=2)
        again_p, again = ba.solve_robust(p, s._K, CFG.ba, reject_px=5.0,
                                         rounds=2)
    _assert_same_solve(again_p, again, want_p, want)
    got_p, got = s._solve_robust(p, CFG.ba, 5.0, 2)
    _assert_same_solve(got_p, got, want_p, want)
    (g,) = s.ba_graphs.values()
    assert g.replays == 1 and g.capture_s > 0
    got_p, got = s._solve_robust(p, CFG.ba, 5.0, 2)
    _assert_same_solve(got_p, got, want_p, want)
    assert list(s.ba_graphs.values()) == [g] and g.replays == 2
    s._solve_robust(p, CFG.ba, 3.0, 2)
    assert len(s.ba_graphs) == 2


@pytest.mark.gpu
def test_restored_system_captures_on_first_tracked_frame(cuda, frames,
                                                          tmp_path):
    """A system restored by ``load_state`` has no step graph until its
    first tracked frame, which captures it (``capture_s`` in that frame's
    info) and replays it; from there it tracks as the system it was saved
    from, bit for bit."""
    cut = 6
    a = slam.SLAMSystem(CFG, cuda, rng="threefry")
    for f in frames[:cut]:
        a.process(torch.from_numpy(f).to(cuda))
    path = str(tmp_path / "ckpt")
    checkpoint.save_state(path, a)
    b = slam.SLAMSystem(CFG, cuda, rng="threefry")
    checkpoint.load_state(path, b)
    assert b.step_graph.graph is None
    ia, ib = [], []
    for f in frames[cut:]:
        x = torch.from_numpy(f).to(cuda)
        ia.append(a.process(x))
        ib.append(b.process(x))
    assert ib[0]["capture_s"] == b.step_graph.capture_s > 0
    assert b.step_graph.replays == len(frames) - cut
    assert _strip(ia) == _strip(ib)
    for x, y in zip(a.trajectory[cut:], b.trajectory[cut:]):
        assert np.array_equal(x, y)
    for (name, x), (_, y) in zip(_tensors(a.state), _tensors(b.state)):
        assert torch.equal(x, y), name
