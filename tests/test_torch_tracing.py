"""The port's tracing: ``MetricsLogger``'s host spans and sync counter,
``utils.profiling.mark``'s stage events inside a step graph, and the
fields they give ``SLAMSystem``'s records.

On the CPU: a span shares ``torch.profiler``'s clock (it lies inside the
``record_function`` range it was taken in); spans nest in start order;
``fetch`` counts one sync a call and returns what ``slam._np`` returns;
``mark`` does nothing off a capture; a ``SLAMSystem`` run through window
BA, structure refinement and maintenance (``torch_frozen``'s config and
frames) logs ``spans`` and ``syncs`` on every frame, one sync on an
ordinary frame, and its poses, state and records (the tracing's fields
apart) equal the frozen driver that predates the tracing; the chunked
driver and global BA log a root span each.

The ``gpu`` cases (skipped without a card; the module imports no jax):
a ``span=True`` step graph's ``stage_ms`` has every stage and its
undotted stages sum to ``span_ms`` within 2%; a graph without ``span``
holds no event-record node, one with it one a mark plus its first and
last events; and each tracked frame's ``syncs`` equals the host syncs
``torch.cuda.set_sync_debug_mode("warn")`` reports for it. Run them with

    python -m pytest tests/test_torch_tracing.py -m gpu --noconftest -q
"""
import json
import warnings

import numpy as np
import pytest
import torch

from torch_frozen import CFG, EagerProcess, assert_same_run, premises, run
from torch_frozen import frames as _frames
from vslam_tpu_torch.pipeline import scan_driver, slam
from vslam_tpu_torch.utils import profiling
from vslam_tpu_torch.utils.metrics import MetricsLogger

torch.set_num_threads(2)

STAGES = ("features", "match", "ransac", "triangulate", "observe",
          "associate", "pnp", "insert")
RANSAC = ("ransac.fit", "ransac.stage1", "ransac.stage2", "ransac.refine")
BA_SPANS = ("ba.build", "ba.gates", "ba.solve", "ba.guards")


def _names(rec):
    return [s[0] for s in rec["spans"]]


def test_span_shares_the_profiler_clock():
    m = MetricsLogger()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("tracing.outer"):
            with m.span("inner"):
                torch.randn(64, 64) @ torch.randn(64, 64)
    ev = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "tracing.outer"]
    assert len(ev) == 1
    lo = ev[0].start_ns()
    hi = lo + ev[0].duration_ns()
    (name, start, end), = m.traced()["spans"]
    assert name == "inner" and lo <= start <= end <= hi, (lo, start, end, hi)


def test_spans_nest_in_start_order():
    m = MetricsLogger()
    m.log(kind="before")
    m.begin()
    with m.span("a"):
        with m.span("b"):
            pass
    with m.span("c"):
        pass
    spans = m.traced()["spans"]
    assert [s[0] for s in spans] == ["a", "b", "c"]
    (_, a0, a1), (_, b0, b1), (_, c0, c1) = spans
    assert a0 <= b0 <= b1 <= a1 <= c0 <= c1
    m.begin()
    assert m.traced() == {"spans": [], "syncs": 0}


def test_fetch_counts_one_sync_a_call():
    m = MetricsLogger()
    x = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    y = torch.tensor([True, False])
    z = torch.linspace(0, 1, 5, dtype=torch.float64)
    got = m.fetch(x)
    want = slam._np(x)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    gy, gz = m.fetch(y, z)
    for g, t in ((gy, y), (gz, z)):
        assert g.dtype == slam._np(t).dtype
        assert np.array_equal(g, slam._np(t))
    tr = m.traced()
    assert tr["syncs"] == 2 and [s[0] for s in tr["spans"]] == ["fetch"] * 2


def test_mark_is_a_no_op_off_a_capture():
    profiling.mark("features")
    with profiling.recording_marks(False) as marks:
        profiling.mark("match")
    assert marks == []


@pytest.fixture(scope="module")
def frames():
    return _frames()


@pytest.fixture(scope="module")
def runs(frames):
    a, ia, oa = run(slam.SLAMSystem, CFG, "torch", frames, "cpu")
    b, ib, ob = run(EagerProcess, CFG, "torch", frames, "cpu")
    return (a, ia, oa), (b, ib, ob)


def test_process_logs_spans_and_syncs(runs):
    (s, infos, _), _ = runs
    premises(s, infos)
    recs = [r for r in s.metrics.records if r["kind"] == "frame"]
    assert len(recs) == len(infos)
    ba = {r["frame"]: r for r in s.metrics.records if r["kind"] == "ba"}
    solved = 0
    for rec, info in zip(recs, infos):
        assert {k: v for k, v in rec.items() if k != "t"} == info
        json.dumps(rec)
        names = _names(rec)
        starts = [x[1] for x in rec["spans"]]
        assert starts == sorted(starts)
        assert all(x[1] <= x[2] for x in rec["spans"])
        assert rec["syncs"] == names.count("fetch")
        assert "device_ms" not in rec          # the CPU has no step graph
        if rec.get("bootstrap"):
            assert names == ["upload"] and rec["syncs"] == 0
            continue
        assert names[:3] == ["upload", "step", "fetch"]
        if not (rec["keyframe"] or rec["ran_ba"]
                or rec["ran_maintenance"]):
            assert names == ["upload", "step", "fetch"]
            assert rec["syncs"] == 1
        if rec["keyframe"] and rec["success"]:
            assert "keyframe" in names
        assert ("maintenance" in names) == rec["ran_maintenance"]
        if rec["ran_ba"]:
            ev = ba[rec["frame"]]
            assert names[names.index("ba.build"):][:2] == list(BA_SPANS[:2])
            if "skipped" not in ev:
                solved += 1
                assert all(n in names for n in BA_SPANS)
                assert ("ba.apply" in names) == ev["ba_result_accepted"]
                assert rec["syncs"] > 1
            assert "solve_device_ms" not in ev     # CUDA events only
    assert solved >= 1
    assert any("structure" in _names(r) for r in recs)


def test_process_unchanged_by_tracing(runs):
    """Poses, counters, state and records (the tracing's fields apart)
    equal the frozen driver's, which predates the tracing."""
    (a, ia, oa), (b, ib, ob) = runs
    assert_same_run(a, ia, oa, b, ib, ob)


def test_chunk_and_global_ba_log_root_spans(frames):
    s = slam.SLAMSystem(CFG, "cpu")
    s.process(frames[0])
    info = s.process_chunk(frames[1:6])
    chunk = s.metrics.records[-1]
    assert chunk == dict(info, kind="chunk", t=chunk["t"])
    assert _names(chunk)[0] == "process_chunk"
    assert chunk["syncs"] == _names(chunk).count("fetch") >= 1
    s.run_global_ba()
    gba = s.metrics.records[-1]
    assert gba["kind"] == "global_ba" and _names(gba)[0] == "global_ba"
    assert gba["syncs"] == _names(gba).count("fetch") >= 1
    root = gba["spans"][0]
    assert all(root[1] <= x[1] <= x[2] <= root[2] for x in gba["spans"])


# --- on the card ---------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs and the hand kernels "
                    "have no CPU mode)")
    return torch.device("cuda", 0)


def _system(dev, span):
    s = slam.SLAMSystem(CFG, dev)
    if span:
        s.step_graph = scan_driver.step_graph(CFG, span=True)
    return s


@pytest.mark.gpu
def test_stage_ms_covers_the_replay_on_cuda(cuda, frames):
    s = _system(cuda, True)
    for f in frames[:8]:
        info = s.process(torch.from_numpy(f).to(cuda))
        if info.get("bootstrap"):
            continue
        span = s.step_graph.span_ms()
        stages = info["device_ms"]
        assert set(stages) == set(STAGES) | set(RANSAC), stages
        assert all(v >= 0 for v in stages.values())
        total = sum(stages[k] for k in STAGES)
        assert abs(total - span) <= 0.02 * span, (total, span)
        parts = sum(stages[k] for k in RANSAC)
        assert parts <= stages["ransac"] + 1e-3


@pytest.mark.gpu
def test_event_nodes_only_with_span_on_cuda(cuda, frames):
    nodes = {}
    for span in (False, True):
        s = _system(cuda, span)
        s.process(torch.from_numpy(frames[0]).to(cuda))
        g = s.step_graph
        nodes[span] = (dict(g.nodes), len(g.marks))
    plain, _ = nodes[False]
    spanned, n_marks = nodes[True]
    assert "event_record" not in plain, plain
    assert n_marks == len(STAGES) + len(RANSAC)
    assert spanned["event_record"] == n_marks + 2, spanned
    assert spanned["kernel"] == plain["kernel"]


@pytest.mark.gpu
def test_syncs_equal_the_host_syncs_on_cuda(cuda, frames):
    """Every tracked frame, a solved window-BA frame among them: the
    record's ``syncs`` equals the synchronizing operations the sync debug
    mode warns of."""
    s = _system(cuda, False)
    s.process(torch.from_numpy(frames[0]).to(cuda))
    imgs = [torch.from_numpy(f).to(cuda) for f in frames[1:]]
    torch.cuda.synchronize()
    bad = []
    for img in imgs:
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                info = s.process(img)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        syncs = [f"{w.filename}:{w.lineno}" for w in caught
                 if "synchroniz" in str(w.message)]
        if len(syncs) != info["syncs"]:
            bad.append((info["frame"], info["syncs"], syncs))
    solved = [r for r in s.metrics.records
              if r["kind"] == "ba" and "skipped" not in r]
    assert solved, "premise: a solved window-BA event"
    assert all(r["solve_device_ms"] > 0 for r in solved)
    assert not bad, bad
