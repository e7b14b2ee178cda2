"""The port's multi-sequence tracking (vslam_tpu_torch.parallel.
multi_sequence, BASELINE config 5) on 2 CPU ranks: tests/
test_multi_sequence.py's four sequences of four frames, each with its own
generator seed, two sequences a rank, the outputs gathered. Every rank's
(S, ...) outputs equal the port's individual runs of the sequences exactly
(tests/test_torch_tracker.py holds those runs to the reference tracker),
and equal, field by field, the frozen eager loop that
``batched_track_step`` was before it could replay a graph
(``torch_frozen.eager_batched_track_step``); on gloo the batched state
holds no graph. tests/sharded_cases.py runs the group.
"""
import numpy as np
import pytest

from tests import sharded_cases


@pytest.fixture(scope="module")
def res(tmp_path_factory):
    return sharded_cases.results(tmp_path_factory)


def test_batched_matches_individual(res):
    want = res["port"]["multiseq"]
    for rank in res["d2"]:
        got = rank["multiseq"]
        assert got["owned"] == 2
        assert got["poses"].shape == (4, 3, 4, 4)
        for s, (poses, inliers) in enumerate(want):
            np.testing.assert_array_equal(got["poses"][s], poses)
            np.testing.assert_array_equal(got["inliers"][s], inliers)
    # premise: the sequences differ, so a mix-up would show
    assert not np.allclose(want[0][0], want[1][0])


def test_batched_matches_frozen_eager_loop(res):
    for rank in res["d2"]:
        got = rank["multiseq"]
        assert got["graph"] is None                  # gloo: eager
        assert got["frozen_differs"] == []
