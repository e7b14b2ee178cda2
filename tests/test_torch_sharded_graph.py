"""The port's parallel modes on a card replay captured steps, with their
NCCL collectives in the graph: the sharded ``process`` (BASELINE config 4)
and multi-sequence tracking (config 5), each on a one-rank NCCL mesh.

Every test here is marked ``gpu`` and skips without a CUDA device (CUDA
graphs, NCCL and the hand kernels have no CPU mode; the CPU runs the same
plumbing eagerly, held to the frozen eager paths by
tests/test_torch_sharded_tracking.py and tests/test_torch_multi_sequence.py).
Each test runs its one-rank NCCL group in a spawned process
(``torch_dist.run_on_card``), so no other test inherits its backend. NCCL
refuses two ranks of one group on one card, so graphs of more ranks are
not checked here. The module imports no jax; run them on the card with

    python -m pytest tests/test_torch_sharded_graph.py -m gpu --noconftest -q

  * ``process`` on the mesh, replaying its step graph (captured at the
    bootstrap frame, K1 and K2 once each, one replay a tracked frame), is
    bit-equal frame by frame to the frozen eager mesh path
    (``torch_frozen.EagerProcess``) and to the single-device system
    replaying its own graph: infos, records, trajectory, state, keyframe
    store, RANSAC stream and every frame's ``last_output``; torch and
    threefry RNGs and both front-end variants on the small config with
    window BA, structure refinement and maintenance, and the default
    config.
  * A meshed system restored by ``load_state`` captures at its first
    tracked frame and goes on as the system it was saved from.
  * ``multi_sequence.batched_track_step`` with 2 sequences replays one
    graph a step, bit-equal to the same step eager and to the frozen
    eager loop, and refuses images of another shape than the graph's.
  * ``cli run --mesh 1`` that raises after its step graph was captured
    still leaves the NCCL group (``multihost.shutdown`` frees the graph
    the exception's traceback still holds) and raises its own error.
"""
import numpy as np
import pytest
import torch

import torch_dist
import torch_frozen
from vslam_tpu_torch.config import VSLAMConfig

pytestmark = pytest.mark.gpu

CASES = dict(torch_frozen.CASES, default=(VSLAMConfig(), "torch"))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs, NCCL and the hand "
                    "kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_process_graph_bit_equal(cuda, tmp_path, case):
    cfg, rng = CASES[case]
    payload = dict(cfg=cfg.to_json(), rng=rng, premises=case != "default",
                   frames=torch_frozen.frames(cfg=cfg))
    r = torch_dist.run_on_card(torch_dist.card_process_case, payload,
                               str(tmp_path))
    print(f"{case}: graph nodes {r['nodes']}, capture {r['capture_s']:.2f} s")
    assert r["backend"] == "nccl"
    assert r["capture_s"] == r["graph_capture_s"] > 0   # at the bootstrap
    assert not r["later_capture"]
    assert r["replays"] == torch_frozen.N_FRAMES - 1
    assert r["captured_launches"] == {"hamming": 1, "associate": 1,
                                      "jacobi": 8, "sampson_gn": 21}
    assert not r["launched_outside"]                     # no eager step
    assert r["premises"] is None, r["premises"]
    assert r["vs_eager"] is None, r["vs_eager"]
    assert r["vs_single"] is None, r["vs_single"]


def test_restored_meshed_system_captures_on_first_tracked_frame(cuda,
                                                                 tmp_path):
    cut = 6
    payload = dict(frames=torch_frozen.frames(), cut=cut,
                   ckpt=str(tmp_path / "ckpt"))
    r = torch_dist.run_on_card(torch_dist.card_restore_case, payload,
                               str(tmp_path))
    assert not r["graph_before"]
    assert r["first_capture_s"] == r["graph_capture_s"] > 0
    assert r["replays"] == torch_frozen.N_FRAMES - cut
    assert r["same_infos"] and r["same_trajectory"]
    assert r["state_differs"] == []


def test_batched_graph_bit_equal_to_eager(cuda, tmp_path):
    n_frames = 4
    seqs = np.stack([torch_frozen.frames(n_frames, seed=s) for s in (5, 6)])
    payload = dict(cfg=torch_frozen.CFG.to_json(), seqs=seqs, seeds=[5, 6])
    r = torch_dist.run_on_card(torch_dist.card_batched_case, payload,
                               str(tmp_path))
    print(f"batched graph nodes {r['nodes']}, capture {r['capture_s']:.2f} s")
    assert r["eager_graph"] is None
    assert r["replays"] == n_frames - 1
    # the first step captures (2 sequences: K1 and K2 twice each in the
    # warm-up and twice in the capture); the replays launch nothing eagerly
    assert r["launched"][0] == (4, 4)
    assert r["launched"][1:] == [(0, 0)] * (n_frames - 2)
    assert r["differs"] == []
    assert r["shape_refused"]
    # premise: the two sequences differ, so a mix-up would show
    assert not np.array_equal(r["poses"][0], r["poses"][1])


def test_raising_meshed_run_still_leaves_the_group(cuda, tmp_path):
    n_frames = 4
    payload = dict(frames=n_frames, out=str(tmp_path / "out"))
    r = torch_dist.run_on_card(torch_dist.card_teardown_case, payload,
                               str(tmp_path))
    assert r["raised"] == "planted after the capture"
    assert r["replays"] == n_frames - 1          # premise: it replayed
    assert r["freed"]
    assert r["left"]
