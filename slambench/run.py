"""One run of one cell of the benchmark of ``vslam_tpu_torch``.

    python3 -m slambench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. ``BENCHMARK.json`` names the cell's configuration and traffic; both
are data files found by name (``configs/<config>.json``,
``traffic/<traffic>.json``, whose ``generator`` names a module of
``traffic/``), and each metric is read by ``metrics/<metric>.py``.

A run: builds the system (``SLAMSystem``, whose CUDA kernels load from
their build directory inside the checkout), makes the scene and every
frame on the card from ``--seed`` (uint8, as a camera gives them), warms
up through the first window-BA event (the step graph's capture and the
event's first use fall in set-up; a generator that gives
``prepare(system, traffic, seed, device)``, as ``traffic/fullmap.py`` does,
has it run once after the warm-up's frame 1), then hands frames to
``SLAMSystem.process`` one at a time, each when the previous call has
returned, for ``--seconds``, and closes the window with a synchronize.
With ``--trace 1`` torch.profiler covers a stretch of the window that
holds a window-BA event, and the per-layer metrics are reported instead
of the end-to-end ones. Then the reference (``reference/``) checks frames
and a BA solve sampled from the window (``reference/check.py``).

The last line of standard output is the result: ``correct``,
``attempted`` (frames in the window), ``failed`` (frames not tracked),
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and last
``compared``: each number that decides ``correct`` with its limit, which
also close standard error. Exits 2 without a result where the cell's
cards are not there, 3 where a JAX module was loaded, 1 on any other
failure (out of frames included).
"""
import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

from slambench.metrics._frames import kind_of  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "vslam_tpu")


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT, "BENCHMARK.json")


def cell_of(man: dict, name: str) -> dict:
    for c in man["workloads"]:
        if c["name"] == name:
            return c
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def reports(metric: dict, cell: str) -> bool:
    """Whether a metric is reported in a cell: listed there, or everywhere
    when it lists no cells."""
    return "workloads" not in metric or cell in metric["workloads"]


def metrics_for(man: dict, cell: str, trace: bool) -> List[dict]:
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in man[kind] if reports(m, cell)]


def reader(name: str):
    """``read`` of ``metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"slambench.metrics._{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


class RunError(RuntimeError):
    pass


@dataclass
class Run:
    """What the metric readers read."""
    cfg: object                      # the program's VSLAMConfig
    setup_s: float = 0.0
    window_s: float = 0.0
    first: int = 0                   # the window's first frame
    latencies: List[float] = field(default_factory=list)   # s a frame
    records: List[dict] = field(default_factory=list)      # the window's
    trace: object = None             # lib.trace.Trace of the traced stretch
    # s of the step graph's replay on the device (CUDA events inside the
    # graph) by frame, for the frames of a --trace 1 run outside the
    # traced stretch
    replay_s: Dict[int, float] = field(default_factory=dict)
    power: str = ""

    @property
    def frames(self) -> List[dict]:
        """The window's frame records."""
        return [r for r in self.records
                if r.get("kind") == "frame" and "success" in r]

    def frame_record(self, index: int) -> Optional[dict]:
        for r in self.records:
            if r.get("kind") == "frame" and r.get("frame") == index:
                return r
        return None


def solved(rec: dict) -> bool:
    return rec.get("kind") == "ba" and "skipped" not in rec


class BAProbe:
    """Once armed, copies the first window-BA event that solves: what the
    system built the window problem from (the keyframe ring and the map,
    copied before the build), the problem it built, and what its solve
    returned. ``close`` puts the system's own functions back."""

    def __init__(self, system, check, keyframes):
        self.check = check
        self.armed = False
        self.record = None
        self._built = None
        self._keyframes = keyframes
        self._build = keyframes.build_window_problem
        keyframes.build_window_problem = self.build
        self.system = system
        self._solve = system._solve_robust
        system._solve_robust = self.solve

    def close(self):
        self._keyframes.build_window_problem = self._build
        if self.system is not None:
            self.system._solve_robust = self._solve
            self.system = None

    def build(self, store, m, cfg, window=None, max_points=None,
              free_tail=None, prov_min_obs=3):
        pre = None
        if self.armed:
            if window is not None or max_points is not None \
                    or free_tail is None:
                raise RunError("the window problem was built with settings "
                               "the reference does not take")
            pre = dict(store=self.check.snapshot(store),
                       map=self.check.snapshot(m), free_tail=free_tail,
                       prov_min_obs=prov_min_obs)
        wp = self._build(store, m, cfg, window=window, max_points=max_points,
                         free_tail=free_tail, prov_min_obs=prov_min_obs)
        if pre is not None:
            pre["fields"] = self.check.window_fields(wp)
            self._built = (wp.problem, pre)
        return wp

    def solve(self, problem, ba_cfg, reject_px, rounds):
        solved_problem, stats = self._solve(problem, ba_cfg,
                                            reject_px=reject_px,
                                            rounds=rounds)
        if self.armed and self._built is not None \
                and problem is self._built[0]:
            self.armed = False
            self.record = dict(
                self._built[1], cfg=ba_cfg, reject_px=reject_px,
                rounds=rounds,
                solved=(solved_problem.T_cw.detach().double().cpu(),
                        float(stats.initial_cost), float(stats.final_cost)))
            self._built = None
        return solved_problem, stats


def _sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(man: dict, cell: dict, seed: int, seconds: float, trace: bool,
             device="cuda", controls=(), cfg_doc=None, tr=None):
    """Run ``cell`` once. Returns (result dict without ``compared``,
    compared rows [(name, number, limit)], what the log prints, {variant:
    widest readings} of the reference's ``controls`` (``compare``)).
    ``cfg_doc`` and ``tr`` stand in for the cell's configuration and
    traffic files (the tests' small runs)."""
    import torch

    from vslam_tpu_torch.config import VSLAMConfig
    from vslam_tpu_torch.pipeline import keyframes, scan_driver
    from vslam_tpu_torch.pipeline.slam import SLAMSystem

    from .reference import check

    marks = {"imports": time.perf_counter() - _T0}
    cfg_doc = cfg_doc or load_json(HERE, "configs", f"{cell['config']}.json")
    tr = tr or load_json(HERE, "traffic", f"{cell['traffic']}.json")
    cfg = VSLAMConfig.from_json(json.dumps(cfg_doc["vslam"]))
    run = Run(cfg)
    system = SLAMSystem(cfg, device, seed=seed, enable_ba=tr["enable_ba"])
    # a traced run's step graph records CUDA events first and last, so the
    # frames outside the traced stretch give the replay's device time
    spans = trace and system.step_graph is not None
    if spans:
        system.step_graph = scan_driver.step_graph(cfg, span=True)
    # the probe holds the system from here, until ``close`` lets it go
    probe = BAProbe(system, check, keyframes)
    del system
    try:
        return _drive(man, cell, seed, seconds, trace, device, controls,
                      cfg_doc, tr, run, probe, spans, marks)
    finally:
        probe.close()


def _drive(man, cell, seed, seconds, trace, device, controls, cfg_doc, tr,
           run, probe, spans, marks):
    """``run_cell`` from the system's construction on."""
    import torch

    from .lib import device as devrec
    from .lib import trace as libtrace
    from .reference import check
    from .traffic import render

    cfg, system = run.cfg, probe.system
    marks["system"] = time.perf_counter() - _T0
    gen = importlib.import_module(f"slambench.traffic.{tr['generator']}")
    n_frames = tr["warmup_max_frames"] + math.ceil(
        seconds * tr["ceiling_frames_per_s"])
    poses, frames = gen.make(tr, cfg_doc["vslam"]["camera"], n_frames, seed,
                             device)
    _sync(torch, device)
    marks["frames"] = time.perf_counter() - _T0

    # warm-up: the bootstrap and the step graph's capture, then through the
    # first window-BA event that solves (its graph's capture and first use);
    # a generator's ``prepare`` runs once after frame 1, whose outcome the
    # start's check holds
    prepare = getattr(gen, "prepare", None)
    start_post = None
    i = 0
    while i < tr["warmup_frames"] or (
            tr["enable_ba"] and i < tr["warmup_max_frames"]
            and not any(solved(r) for r in system.metrics.records)):
        info = system.process(render.to_float(frames[i]))
        if i == 1:
            start_post = (check.snapshot(system.state), info)
            if prepare is not None:
                prepare(system, tr, seed, device)
        i += 1
    _sync(torch, device)
    marks["warmup"] = time.perf_counter() - _T0
    marks["step_capture_s"] = system.metrics.records[0].get("capture_s")
    first = run.first = i
    n_rec = len(system.metrics.records)
    warm_ba = [[r["frame"], solved(r)] for r in system.metrics.records
               if r.get("kind") == "ba"]
    run.setup_s = time.perf_counter() - _T0

    # the frames checked, and the BA event armed, drawn from the seed
    rng = random.Random(seed)
    reach = max(int(seconds * tr["check_within_frames_per_s"]), 2)
    pending = sorted(rng.sample(range(1, reach), min(tr["check_frames"],
                                                     reach - 1)))
    arm_at = rng.randrange(0, max(reach // 2, 1))
    period = cfg.pipeline.keyframe_every * cfg.pipeline.local_ba_every
    last_ba = max([r["frame"] for r in system.metrics.records
                   if r.get("kind") == "ba"] or [first - 1])
    prof = stopped = None
    traced, ba_traced = 0, False
    trace_start = int(seconds * tr["trace_after_frames_per_s"])
    samples = []
    pre = None
    t_start = time.perf_counter()
    while time.perf_counter() - t_start < seconds:
        if i >= n_frames:
            raise RunError(f"out of frames: {n_frames} made, the window "
                           f"reached frame {i}")
        k = i - first
        if k == arm_at:
            probe.armed = True
        if pending and k >= pending[0] and pre is None:
            pre = check.snapshot(system.state)
        if trace and prof is None and traced == 0 and k >= trace_start and (
                not tr["enable_ba"]
                or (i - last_ba) % period == period - tr["trace_lead"]):
            prof = libtrace.Profiler(torch)
            prof.start()
        img = render.to_float(frames[i])
        t = time.perf_counter()
        if prof is not None:
            with prof.frame(i):
                info = system.process(img)
        else:
            info = system.process(img)
            if spans:
                run.replay_s[i] = 1e-3 * system.step_graph.span_ms()
        run.latencies.append(time.perf_counter() - t)
        if info["ran_ba"]:
            last_ba = i
        if prof is not None:
            traced += 1
            ba_traced = ba_traced or info["ran_ba"]
            done = traced >= tr["trace_frames"] and (
                not tr["enable_ba"]
                or (ba_traced and i - last_ba >= tr["trace_tail"]))
            if done or traced >= tr["trace_max_frames"]:
                t = time.perf_counter()
                prof.stop()
                marks["trace_stop_s"] = time.perf_counter() - t
                stopped, prof = prof, None
        if pre is not None:
            if not (info["ran_ba"] or info["ran_maintenance"]):
                samples.append((i, pre, check.snapshot(system.state), info))
                pending.pop(0)
            pre = None
        i += 1
    _sync(torch, device)
    run.window_s = time.perf_counter() - t_start
    if prof is not None:
        prof.stop()
        stopped = prof
    if stopped is not None:
        t = time.perf_counter()
        run.trace = stopped.reduce()
        marks["trace_reduce_s"] = time.perf_counter() - t
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    run.records = system.metrics.records[n_rec:]
    run.power = devrec.power_limit() if cuda else "cpu"

    # the ATE of the whole run so far, for the log
    from .lib import ate
    est = system.poses()
    ate_m = ate.ate_rmse(est.astype("float64"),
                         poses[:len(est)].astype("float64"))[0]

    sizes = [r["map_size"] for r in run.frames if "map_size" in r]
    result = {"attempted": len(run.frames),
              "failed": sum(1 for r in run.frames if not r["success"])}
    metrics = {}
    for m in metrics_for(man, cell["name"], trace):
        v = reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result["metrics"] = metrics
    if cuda:
        result["device"] = devrec.record(torch, cell["chips"], peak)
    else:
        result["device"] = {"platform": "cpu", "kind": "cpu", "count": 1,
                            "memory_peak_bytes": 0}
    if run.trace is not None:
        result["device"]["busy_s"] = run.trace.busy_ns() * 1e-9
        result["device"]["window_s"] = run.trace.window_ns * 1e-9
        result["breakdown"] = breakdown(run, libtrace)

    # the program's state goes; the reference runs on what was copied
    ba_rec = probe.record
    keep = {0, 1} | {s[0] for s in samples}
    imgs = {j: render.to_float(frames[j]) for j in keep}
    probe.close()
    del system, probe, frames
    if cuda:
        torch.cuda.empty_cache()
    numbers, control = compare(check, cfg_doc["vslam"], seed, device, imgs,
                               start_post, samples, ba_rec, controls)
    lim = check.limits()
    # every step number, and in a cell with window BA every BA number: a
    # run whose window checked no frame, or no solved event, proves nothing
    required = [k for k in lim
                if k.startswith("step.") or
                (tr["enable_ba"] and k.startswith("ba."))]
    ok, rows = check.judge(numbers, lim, required)
    ok = ok and len(samples) > 0
    result["correct"] = bool(ok)
    info = {"frames_checked": len(samples), "ba_checked": int(ba_rec
                                                              is not None),
            "unjudged": {k: v for k, v in numbers.items() if k not in lim},
            "ate_m": ate_m, "power": run.power, "setup_s": run.setup_s,
            "window_s": run.window_s, "warmup_frames": first,
            "slowest": slowest(run, first),
            "setup_marks": marks, "warmup_ba": warm_ba,
            "map_size": [min(sizes, default=None), max(sizes, default=None)],
            "window_maintenance": [[r["frame"], r["size_before"],
                                    r["size_after"]] for r in run.records
                                   if r.get("kind") == "map_maintenance"],
            "window_ba": [[r["frame"], solved(r)] for r in run.records
                          if r.get("kind") == "ba"]}
    return result, rows, info, control


def compare(check, vslam: dict, seed: int, device, imgs, start_post, samples,
            ba_rec, controls=()):
    """The reference's widest gaps to the program over the start, the
    sampled frames and the BA event; and for each name in ``controls`` (a
    ``check.VARIANTS`` key) the widest gaps of that variant of the
    reference to the float32 one ({} without any)."""
    import torch

    rcfg = check.config(vslam)
    readings = []
    other = {name: [] for name in controls}
    ref, pre_pose = check.reference_start(imgs[0], imgs[1], rcfg, seed,
                                          device)
    empty = torch.zeros((0, 3), dtype=torch.float64)
    readings.append(check.gaps(check.outcome(*start_post), ref, pre_pose,
                               empty))
    steps = [n for n in controls if n not in check.BA_ONLY]
    for name in steps:
        low, _ = check.reference_start(imgs[0], imgs[1], rcfg, seed, device,
                                       **check.VARIANTS[name])
        other[name].append(check.gaps(low, ref, pre_pose, empty))
    for j, pre_s, post_s, info in samples:
        ref = check.reference_step(pre_s, imgs[j], rcfg)
        pre_pose = pre_s[1]["pose"].double().cpu()
        pre_xyz = check.pre_map(pre_s)
        readings.append(check.gaps(check.outcome(post_s, info), ref,
                                   pre_pose, pre_xyz))
        for name in steps:
            low = check.reference_step(pre_s, imgs[j], rcfg,
                                       **check.VARIANTS[name])
            other[name].append(check.gaps(low, ref, pre_pose, pre_xyz))
    numbers = check.widest(readings)
    if ba_rec is not None:
        want = check.reference_ba(ba_rec, rcfg, device)
        numbers.update(check.ba_gaps(ba_rec, want))
        for name in controls:
            other[name].append(check.ba_gaps(
                check.reference_ba(ba_rec, rcfg, device,
                                   **check.VARIANTS[name]), want))
    return numbers, {name: check.widest(r) for name, r in other.items()}


def slowest(run: Run, first: int, n: int = 6):
    """The window's n slowest frames: [frame, ms, kind]."""
    order = sorted(range(len(run.latencies)), key=lambda j: -run.latencies[j])
    out = []
    for j in order[:n]:
        out.append([first + j, 1e3 * run.latencies[j],
                    kind_of(run.frame_record(first + j) or {})])
    return out


def breakdown(run: Run, libtrace) -> dict:
    """The traced stretch's device operations that took most time (five
    classes, five names) and its idle time by what the host was doing (the
    kind of frame being processed, or the benchmark's own loop between
    calls): each label's total and longest gap."""
    secs = run.trace.op_seconds()
    by_class: Dict[str, float] = {}
    for name, s in secs.items():
        c = libtrace.classify(name)
        by_class[c] = by_class.get(c, 0.0) + s
    ops = sorted(by_class.items(), key=lambda kv: -kv[1])[:5]
    ops = [[f"class:{k}", v] for k, v in ops]
    ops += [[k[:160], v] for k, v in
            sorted(secs.items(), key=lambda kv: -kv[1])[:5]]
    total: Dict[str, float] = {}
    longest: Dict[str, float] = {}
    for s, e in run.trace.idle_gaps():
        f = run.trace.frame_of((s + e) // 2)
        label = "loop" if f is None else \
            kind_of(run.frame_record(f.index) or {})
        total[label] = total.get(label, 0.0) + (e - s) * 1e-9
        longest[label] = max(longest.get(label, 0.0), (e - s) * 1e-9)
    gaps = sorted(total.items(), key=lambda kv: -kv[1])
    idle = [[f"{k}.total", v] for k, v in gaps[:5]]
    idle += [[f"{k}.longest", longest[k]] for k, _ in gaps[:5]]
    return {"device_ops": ops, "idle_gaps": idle}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the program's build and kernel caches stay at fixed paths inside the
    # checkout (the CUDA kernels' directory is fixed by the program there)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(ROOT, "build", sub)
    # one host thread for the host's numpy and torch work (the window-BA
    # guards, the fetch): a one-card machine shares its cores, and a
    # thread pool's wake-ups spread the frames' times
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    man = manifest()
    cell = cell_of(man, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"slambench: the cell needs {cell['chips']} CUDA card(s); "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        result, rows, info, _ = run_cell(man, cell, args.seed, args.seconds,
                                         bool(args.trace))
    except RunError as e:
        print(f"slambench: {e}", file=sys.stderr)
        return 1
    bad = forbidden_modules()
    if bad:
        print(f"slambench: JAX modules loaded: {bad}", file=sys.stderr)
        return 3
    print(f"slambench: {json.dumps(info)}", file=sys.stderr)
    # a number that was not read, or not finite, is printed as null
    rows = [(name, v if v is not None and math.isfinite(v) else None, lim)
            for name, v, lim in rows]
    for name, v, lim in rows:
        print(f"{name} {v!r} limit {lim!r}", file=sys.stderr)
    result["compared"] = {name: {"value": v, "limit": lim}
                          for name, v, lim in rows}
    out = {k: result[k] for k in ("correct", "attempted", "failed", "metrics",
                                  "device")}
    for k in ("breakdown", "compared"):
        if k in result:
            out[k] = result[k]
    sys.stdout.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
