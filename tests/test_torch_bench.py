"""The port's steady-state tracking benchmark and step profiler
(``vslam_tpu_torch.tools.bench``, ``vslam_tpu_torch.ops.profile_step``) on
the CPU, against the repository's ``bench.py`` and
``vslam_tpu/ops/profile_step.py``:

  * ``utils.threefry.uniform`` equal to ``jax.random.uniform`` bit for bit
    (XLA contracts its scale and shift into one fused multiply-add, which
    ``threefry.fma`` rounds as it does);
  * the distractor fill on the reference's stream equal to bench.py's
    ``_distractors``, and the map after ``prepopulate`` equal to the
    reference's ``insert_points`` of the same draws;
  * the carried loop at ``small_config()`` over 6 frames on a map holding
    2048 distractors, on the reference's RANSAC stream, against bench.py's
    scan of ``tracker.track_step``: ``success`` equal per frame, inlier
    counts within 2 (tests/test_torch_scan_driver.py's tolerance for the
    chunk against the reference), the final map size equal;
  * ``check`` on bench.py's own saved line (BENCH_r05.json), and against a
    report breaking each assert; the JSON line's keys;
  * both tools exit 2 without a card;
  * ``classify`` on real CUDA kernel names and ``aggregate_device_ops`` on
    a hand-written Chrome trace; a profile's trace goes into a new
    directory and leaves what the trace directory held.
"""
import copy
import functools
import importlib.util
import json
import pathlib
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vslam_tpu.config import small_config as jsmall_config
from vslam_tpu.mapping import point_map as jpoint_map
from vslam_tpu.pipeline import tracker as jtracker
from vslam_tpu_torch.config import small_config
from vslam_tpu_torch.datasets import synthetic
from vslam_tpu_torch.ops import profile_step
from vslam_tpu_torch.pipeline import scan_driver, tracker
from vslam_tpu_torch.tools import bench
from vslam_tpu_torch.utils import threefry

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
CFG = small_config()
SEED = 5


def _reference_bench():
    """The repository's bench.py (it imports jax only inside functions)."""
    spec = importlib.util.spec_from_file_location("reference_bench",
                                                  REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bits(x):
    return np.asarray(x).view(np.int32)


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (2.0, 180.0), (-3.5, 2.25),
                                   (1e-3, 1e6), (-50.0, -49.9)])
def test_uniform_matches_jax(lo, hi):
    for seed in (0, 7, 12345, 2 ** 32 - 1):
        for shape in ((1000, 3), (17,), (4, 5, 6)):
            want = jax.random.uniform(jax.random.PRNGKey(seed), shape,
                                      jnp.float32, lo, hi)
            got = threefry.uniform(threefry.key(seed), shape, lo, hi)
            assert got.dtype == torch.float32 and got.shape == shape
            np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_fma_rounds_as_xla_contracts():
    rng = np.random.RandomState(0)
    fused = jax.jit(lambda a, b, c: a * b + c)
    for scale in (1.0, 1e-3, 1e4):
        a, b, c = (rng.randn(20000).astype(np.float32) * s
                   for s in (1.0, scale, scale))
        got = threefry.fma(*(torch.from_numpy(x) for x in (a, b, c)))
        np.testing.assert_array_equal(_bits(got.numpy()),
                                      _bits(fused(a, b, c)))


@pytest.mark.parametrize("n", [1, 2048, 5000])
def test_distractors_match_reference(n):
    ref = _reference_bench()
    want_xyz, want_desc = ref._distractors(
        jax.random.PRNGKey(SEED + n), n, extent=bench.DISTRACTOR_EXTENT,
        z_range=bench.DISTRACTOR_Z)
    xyz, desc = bench.distractors(n, key=threefry.key(SEED + n),
                                  device="cpu")
    np.testing.assert_array_equal(_bits(xyz.numpy()), _bits(want_xyz))
    np.testing.assert_array_equal(desc.numpy(), _bits(want_desc))


def _frames(n, seed=2):
    """tests/test_torch_scan_driver.py's small scene."""
    K = CFG.camera.K()
    scene = synthetic.make_scene(num_points=700, seed=seed,
                                 extent=(14, 6, 45), z_min=6.0)
    poses = synthetic.make_trajectory(n, step=0.6, yaw_rate=0.01, seed=seed)
    return np.stack(synthetic.render_sequence(
        K, poses, scene, CFG.camera.width, CFG.camera.height))


def _reference_state(frame0, n):
    """bench.py's ``prepopulate`` on the reference's bootstrap."""
    cfg = jsmall_config()
    st = jtracker.bootstrap(jnp.asarray(frame0), cfg)
    xyz, desc = _reference_bench()._distractors(
        jax.random.PRNGKey(SEED + n), n, extent=bench.DISTRACTOR_EXTENT,
        z_range=bench.DISTRACTOR_Z)
    m = jpoint_map.insert_points(
        st.map, xyz, jnp.zeros((n, 3), jnp.float32), desc,
        jnp.ones((n,), bool), frame_idx=bench.FAR_FUTURE)
    return cfg, st.replace(map=m)


@pytest.mark.parametrize("n", [2048, 5000])
def test_prepopulate_matches_reference_insert(n):
    """Size, last_seen, descriptors and xyz equal; at 5000 the rows past
    the capacity of 4096 are dropped in both."""
    frame0 = _frames(1)[0]
    _, want = _reference_state(frame0, n)
    st = tracker.bootstrap(frame0, CFG, "cpu", rng="threefry")
    got = bench.prepopulate(st, n, SEED, "threefry").map
    want = want.map
    assert int(got.size) == int(want.size) == min(n, CFG.map.capacity)
    np.testing.assert_array_equal(got.last_seen.numpy(),
                                  np.asarray(want.last_seen))
    np.testing.assert_array_equal(got.desc.numpy(), _bits(want.desc))
    np.testing.assert_array_equal(_bits(got.pt[:, :3].numpy()),
                                  _bits(np.asarray(want.pt)[:, :3]))


def test_carried_loop_matches_reference_scan():
    """6 frames over 2048 distractors on the reference's RANSAC stream:
    success equal per frame, inliers within 2, the final map size
    equal."""
    n_pre, n = 2048, 6
    frames = _frames(n + 1)
    jcfg, jst = _reference_state(frames[0], n_pre)

    @functools.partial(jax.jit, static_argnames=("n",))
    def run_n(state, stacked, n):                 # bench.py's run_n
        def body(s, i):
            s2, out = jtracker.track_step(s, stacked[i], jcfg)
            return s2, (out.num_inliers, out.success)
        return jax.lax.scan(body, state, jnp.arange(n))

    jst, (inl, ok) = run_n(jst, jnp.asarray(frames[1:]), n)
    st = bench.prepopulate(
        tracker.bootstrap(frames[0], CFG, "cpu", rng="threefry"), n_pre,
        SEED, "threefry")
    st, rows = scan_driver.carried(st, torch.from_numpy(frames[1:]), CFG)
    got = scan_driver.ChunkScalars.unpack(rows.numpy())
    assert rows.shape == (n, scan_driver.ROW)
    np.testing.assert_array_equal(got.success, np.asarray(ok))
    assert np.asarray(ok).all()
    assert np.abs(got.num_inliers - np.asarray(inl)).max() <= 2, (
        got.num_inliers, np.asarray(inl))
    assert int(st.map.size) == int(jst.map.size) == got.map_size[-1]
    assert not got.is_keyframe.any() and not got.ran_maintenance.any()


_LINE = re.compile(r"^(\w+): fps=([\d.]+) success=(\d+)/(\d+) "
                   r"median_inliers=(\d+) final_map=(\d+)$")


def _segments(text):
    """bench.py's (and ``bench.segment_line``'s) per-segment lines in
    ``text`` -> {label: segment}."""
    segs = {}
    for line in text.splitlines():
        m = _LINE.match(line.strip())
        if m:
            segs[m[1]] = dict(fps=float(m[2]), success=int(m[3]),
                              frames=int(m[4]), median_inliers=int(m[5]),
                              final_map=int(m[6]))
    return segs


def _r05():
    """BENCH_r05.json's line and its segments from bench.py's stderr."""
    rec = json.loads((REPO / "BENCH_r05.json").read_text())
    return rec["parsed"], _segments(rec["tail"])


def test_check_accepts_bench_r05():
    report, segments = _r05()
    assert set(segments) == set(bench.FILLS)
    assert segments["map51k"] == dict(fps=89.4, success=40, frames=40,
                                      median_inliers=1209, final_map=54109)
    bench.check(report, segments)
    seg = dict(segments["map0"], fps=115.8)
    assert _segments(bench.segment_line("map0", seg)) == {"map0": seg}


BREAKS = {
    "success": lambda r, s: s["map120k"].update(success=32),
    "median_inliers": lambda r, s: s["map0"].update(median_inliers=50),
    "final_map": lambda r, s: r.update(final_map=49999),
}


@pytest.mark.parametrize("what", list(BREAKS))
def test_check_rejects_each_broken_assert(what):
    report, segments = copy.deepcopy(_r05())
    BREAKS[what](report, segments)
    with pytest.raises(AssertionError, match=what.split("_")[0]):
        bench.check(report, segments)


def test_report_keys_are_bench_py_keys_plus_device(monkeypatch):
    """A tiny CPU run (small config, 2 timed frames, small fills) of the
    whole tool: the JSON line's keys and the segments' fields. The host
    clock bench reads is a fake that advances 0.1 s per tracked frame (a
    loaded CPU's clock would make the differencing noise), so the rate is
    exactly (n/2) / (t(n) - t(n/2)) = 10 frames/s."""
    clock = [0.0]
    carried = scan_driver.carried

    def timed_carried(state, frames, cfg, graph=None):
        clock[0] += 0.1 * frames.shape[0]
        return carried(state, frames, cfg, graph)

    monkeypatch.setattr(scan_driver, "carried", timed_carried)
    monkeypatch.setattr(bench, "time",
                        types.SimpleNamespace(perf_counter=lambda: clock[0]))
    fills = {"map0": 0, "map51k": 1024, "map120k": 2048}
    report, segments, graph = bench.run("cpu", SEED, "threefry", n_timed=2,
                                        cfg=CFG, fills=fills)
    assert graph is None
    assert set(report) == set(_r05()[0]) | {"device"}
    assert report["device"] == {"type": "cpu", "name": "cpu"}
    assert report["metric"] == "frames_per_sec_per_chip"
    assert report["value"] == report["fps_from_scratch"] == 10.0
    assert report["vs_baseline"] == round(10.0 / 30.0, 3)
    assert (report["raw_t_half_s"], report["raw_t_full_s"]) == (0.1, 0.2)
    assert report["final_map"] == segments["map51k"]["final_map"] > 1024
    assert report["final_map_120k"] == segments["map120k"]["final_map"]
    for s in segments.values():
        assert s["frames"] == 2 and s["replay_ms"] is None
        assert s["success"] == 2 and s["clocks_before"] == {}
    json.dumps(report)


@pytest.mark.parametrize("main", [bench.main, profile_step.main],
                         ids=["bench", "profile_step"])
def test_tools_exit_2_without_a_card(main, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main([]) == 2


KERNEL_NAMES = {
    "(anonymous namespace)::hamming_kernel(unsigned int const*, unsigned "
    "int const*, int*, int, int)": "K1 hamming",
    "(anonymous namespace)::associate_kernel(float2 const*, unsigned char "
    "const*, int const*, int const*, int const*, int const*, int, float2 "
    "const*, int const*, unsigned char const*, int, float, float, int, "
    "unsigned long long*)": "K2 associate",
    "void (anonymous namespace)::jacobi_kernel<9>(float const*, long long, "
    "long long, long long, signed char const*, int, int, float*, float*, "
    "long long)": "J jacobi",
    "void (anonymous namespace)::sampson_kernel<true>(float const*, float "
    "const*, float const*, float const*, float const*, float const*, float "
    "const*, float*, float*, float*, int)": "G sampson_gn",
    "void cutlass::Kernel2<cutlass_80_simt_sgemm_128x64_8x5_nn_align1>("
    "cutlass_80_simt_sgemm_128x64_8x5_nn_align1::Params)": "gemm",
    "sm90_xmma_gemm_f32f32_tf32f32_f32_nn_n_tilesize128x128x32_warpgroup"
    "size1x1x1_execute_segment_k_off_kernel__5x_cublas": "gemm",
    "void at::native::vectorized_elementwise_kernel<4, "
    "at::native::CUDAFunctor_add<float>, at::detail::Array<char*, 3> >(int, "
    "at::native::CUDAFunctor_add<float>, at::detail::Array<char*, 3>)":
        "elementwise",
    "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
    "at::native::func_wrapper_t<float, at::native::sum_functor<float, "
    "float, float>::operator()(at::TensorIterator&)::{lambda(float, float)"
    "#1}>, unsigned int, float, 4> >(at::native::ReduceOp<float, "
    "at::native::func_wrapper_t<float, at::native::sum_functor<float, "
    "float, float>::operator()(at::TensorIterator&)::{lambda(float, float)"
    "#1}>, unsigned int, float, 4>)": "reduce/scan",
    "void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<"
    "at_cuda_detail::cub::DeviceRadixSortPolicy<long, long, int>::"
    "Policy800, false, long, long, int, int>(int*, int*, long*, long "
    "const*, long*, long const*, int, int, int)": "sort",
    "void at::native::index_elementwise_kernel<128, 4, "
    "at::native::gpu_index_kernel<...>(at::TensorIteratorBase&)>(long, "
    "...)": "index/scatter/gather",
    "void at::native::_scatter_gather_elementwise_kernel<128, 4, ...>(int, "
    "...)": "index/scatter/gather",
    "void at::native::(anonymous namespace)::CatArrayBatchedCopy<float, "
    "unsigned int, 2, 128, 1>(...)": "cat/copy",
    "void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_"
    "impl_nocast<at::native::direct_copy_kernel_cuda(at::TensorIterator"
    "Base&)::{lambda()#3}::operator()() const::{lambda(float)#1}>(...)>("
    "int, ...)": "cat/copy",
    "Memcpy DtoD (Device -> Device)": "memcpy",
    "memcpy32_post": "cat/copy",
    "Memset (Device)": "memset",
    "void at::native::(anonymous namespace)::elementwise_kernel_with_index"
    "<int, at::native::arange_cuda_out(...)>(...)": "elementwise",
    "some_hand_written_kernel": "other",
}


@pytest.mark.parametrize("name", list(KERNEL_NAMES))
def test_classify_cuda_kernel_names(name):
    assert profile_step.classify(name) == KERNEL_NAMES[name]


def test_launch_counts_read_every_wrapper(monkeypatch):
    """``ops.launch_counts`` holds each hand kernel's wrapper counter by
    name, ``launches_since`` the difference, ``reset_launches`` zeroes
    them all."""
    from vslam_tpu_torch import ops
    from vslam_tpu_torch.ops import associate, hamming, jacobi, sampson_gn
    for m, n in ((hamming, 3), (associate, 5), (jacobi, 7), (sampson_gn, 2)):
        monkeypatch.setattr(m, "launches", n)
    before = ops.launch_counts()
    assert before == {"hamming": 3, "associate": 5, "jacobi": 7,
                      "sampson_gn": 2}
    jacobi.launches += 8
    sampson_gn.launches += 21
    assert ops.launches_since(before) == {"hamming": 0, "associate": 0,
                                          "jacobi": 8, "sampson_gn": 21}
    ops.reset_launches()
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


def test_aggregate_device_ops(tmp_path):
    """Device events (kernel, memcpy, memset) summed by name, in ms; host
    events and GPU annotations ignored."""
    k1 = next(iter(KERNEL_NAMES))
    ev = lambda cat, name, dur, ph="X": dict(ph=ph, cat=cat, name=name,
                                             dur=dur, ts=0, pid=0, tid=0)
    trace = {"traceEvents": [
        ev("kernel", k1, 17.5), ev("kernel", k1, 18.5),
        ev("kernel", "gemm_kernel", 1000.0),
        ev("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 4.0),
        ev("gpu_memset", "Memset (Device)", 1.0),
        ev("cpu_op", "aten::add", 5000.0),
        ev("cuda_runtime", "cudaGraphLaunch", 30.0),
        ev("gpu_user_annotation", "stage", 2000.0),
        ev("kernel", k1, 0.0, ph="i"),
        {"ph": "M", "name": "process_name", "pid": 0},
    ]}
    sub = tmp_path / "a"
    sub.mkdir()
    (sub / f"1_2{profile_step.TRACE_SUFFIX}").write_text(json.dumps(trace))
    (tmp_path / "notes.json").write_text(json.dumps(trace))
    ms, cnt, by_cat = profile_step.aggregate_device_ops(str(tmp_path))
    assert dict(ms) == pytest.approx({
        k1: 0.036, "gemm_kernel": 1.0,
        "Memcpy DtoD (Device -> Device)": 0.004, "Memset (Device)": 0.001})
    assert dict(cnt) == {k1: 2, "gemm_kernel": 1,
                         "Memcpy DtoD (Device -> Device)": 1,
                         "Memset (Device)": 1}
    assert dict(by_cat) == pytest.approx({"kernel": 1.036,
                                          "gpu_memcpy": 0.004,
                                          "gpu_memset": 0.001})
    assert profile_step.n_kernels(cnt) == 3
    with pytest.raises(FileNotFoundError):
        profile_step.aggregate_device_ops(str(tmp_path / "empty"))


def test_trace_goes_to_a_new_directory(tmp_path):
    """A traced run (on the CPU) writes its trace into a new directory
    under the one it is given, reads only that one, and leaves every file
    already there, a trace among them, as it was."""
    keep = tmp_path / "report.json"
    keep.write_text("{}")
    old = tmp_path / f"old{profile_step.TRACE_SUFFIX}"
    old.write_text(json.dumps({"traceEvents": [dict(
        ph="X", cat="kernel", name="gemm_kernel", dur=1000.0, ts=0, pid=0,
        tid=0)]}))
    x = torch.arange(8.0)
    for _ in range(2):
        event_ms, (ms, cnt, by_cat) = profile_step._traced(
            "cpu", str(tmp_path), lambda: (x * 2).sum())
        assert event_ms is None and "gemm_kernel" not in ms
        assert by_cat["kernel"] == 0
    assert keep.read_text() == "{}"
    assert old.exists()
    made = [d for d in tmp_path.iterdir() if d.is_dir()]
    assert len(made) == 2
    for d in made:
        assert len(list(d.glob("*" + profile_step.TRACE_SUFFIX))) == 1
