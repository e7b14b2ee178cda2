"""Typed configuration — a copy of ``vslam_tpu/config.py``.

The port keeps its own copy because importing ``vslam_tpu`` loads jax
(``vslam_tpu/__init__.py``), and a GPU host that runs the port need not
have jax. ``tests/test_torch_interop.py`` holds the two copies equal
(``dataclasses.asdict`` of the default and the small config). The comments
below are the reference's; the timings they quote were taken on a TPU.

Replaces the reference's single env var + scattered hard-coded constants
(reference: src/vslam.cpp:19,29-33,39,50,149; src/Frame.cpp:61,66,91) with one
frozen, hashable dataclass tree that can be passed as a static argument to
``jax.jit``.

All capacities are static: TPU/XLA compiles one program per shape, so every
variable-length quantity in the SLAM state (keypoints, matches, map points,
observations) lives in a fixed-capacity padded array with a validity mask.
Capacities default to multiples of 128 to align with MXU/VPU lanes.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class CameraConfig:
    """Pinhole intrinsics. Reference builds K = [f,0,W/2; 0,f,H/2; 0,0,1]
    from env var ``F`` (src/vslam.cpp:29-33); here it is explicit config."""
    width: int = 1248
    height: int = 384
    fx: float = 718.856   # KITTI 00 default; reference default was f=525
    fy: float = 718.856
    cx: float = 607.1928
    cy: float = 185.2157

    def K(self):
        import numpy as np
        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=np.float32,
        )


@dataclass(frozen=True)
class FrontendConfig:
    """Feature detection + description.

    Mirrors the capability of the reference's two extraction strategies
    (src/Frame.cpp:16-51 grid ORB; src/Frame.cpp:53-80 Shi-Tomasi+ORB) as
    batched convolution / top-k kernels.
    """
    max_keypoints: int = 3072        # reference caps at 3000 (src/Frame.cpp:61)
    nms_radius: int = 3              # reference min distance 3 px (src/Frame.cpp:61)
    quality_level: float = 0.01      # relative response threshold (src/Frame.cpp:61)
    score: str = "shi_tomasi"        # "shi_tomasi" | "harris"
    harris_k: float = 0.04
    # Grid-distributed detection (idiomatic form of the reference's 5x5 grid
    # cap, src/Frame.cpp:19-23): top-k per tile. 0 disables tiling.
    grid_rows: int = 8
    grid_cols: int = 16
    # BRIEF descriptor
    patch_radius: int = 15           # ORB uses radius-15 intensity centroid
    descriptor_bits: int = 256       # 256-bit binary descriptor = 8 x uint32
    blur_sigma: float = 2.0          # pre-descriptor smoothing
    border: int = 19                 # keypoints this close to border are culled
    # oriented=False (default): upright BRIEF. True: ORB-style
    # rotation-steered BRIEF on the dense intensity-centroid orientation map
    # — rotation-invariant, at N x 512 gathers. On one H100 (700 W) at
    # 1248x384 / 3072 keypoints the step's features.orient (the blur and
    # the orientation map) takes 1.47 ms a frame and features.describe (the
    # steered gathers) 0.14 ms, against 1.05 ms for the whole upright
    # features stage. Use for rotation-heavy sequences (handheld video);
    # forward-motion odometry (KITTI/TUM) does not need it.
    oriented: bool = False
    # Track carry (features.detect_with_carry): every tracked keypoint is
    # re-localized at the response maximum near its predicted position
    # (flow-extrapolated; landmark projection for mapped keypoints) with
    # budget priority over fresh detections — attacking the dominant
    # track-death mode (per-tile top-k detection is not repeatable for
    # marginal corners; measured 33%/frame mapped-track match loss, 77%
    # of it detector misses). Default OFF: on the 150-frame synthetic
    # corridor it raises PnP anchoring (tracked-map keypoints 4.5 -> 6.3
    # per frame) but the marginal corners it keeps alive localize noisily
    # and the odometry ATE worsens 0.045 -> 0.080 — persistence of weak
    # corners is not free. Kept as a capability for low-texture regimes
    # where anchor DENSITY is the binding constraint.
    track_carry: bool = False


@dataclass(frozen=True)
class MatchingConfig:
    max_matches: int = 3072
    lowe_ratio: float = 0.7          # reference src/Frame.cpp:91
    cross_check: bool = True         # reference TODO at src/Frame.cpp:103
    hamming_max: int = 64            # association gate (src/vslam.cpp:39)
    search_radius: float = 12.0      # projection search radius in px (the
                                     # candidate pose seeds the search; a
                                     # tight radius starves re-acquisition
                                     # and with it the PnP anchor density)
    # Guided frame-to-frame matching (matcher.match with keypoint pixels):
    # candidates restricted to a spatial window; the descriptor gate can be
    # generous inside it. Keeps feature tracks alive on low-texture frames
    # — measured +47% matches on the synthetic corridor. 0 disables.
    guided_radius: float = 48.0      # px; covers inter-frame flow
    guided_hamming_max: int = 80     # absolute gate within the window
                                     # (reference uses 2 px, src/vslam.cpp:149;
                                     # wider is more robust with correct poses)
    # RE-ACQUISITION tier of search-by-projection (round-5 map-reuse work):
    # a broken mapped track's corner usually re-enters as a fresh detection
    # 1-2 frames later, but its descriptor vs the stored archive sits in
    # the Hamming 64-96 band (KERNELS_r04.md §5) — above hamming_max, so
    # the landmark dies. Raising the GLOBAL gate to 96 was measured to
    # worsen corridor ATE ~2x through false associations; instead, only
    # landmarks seen within the last ``reacq_max_age`` frames accept the
    # looser ``reacq_hamming_max`` gate, and only inside the TIGHTER
    # ``reacq_radius`` pixel window (the candidate pose is good frame to
    # frame, so a true re-observation projects within a few px; a false
    # candidate must land in a far smaller disc AND be recent).
    # reacq_max_age=0 disables the tier.
    reacq_radius: float = 6.0    # widening to 8 px raised anchor density
                                 # ~15% but worsened 600-frame corridor
                                 # ATE 0.46 -> 0.79 (false re-binds)
    reacq_hamming_max: int = 96
    reacq_max_age: int = 8       # 4 -> 8 measured ATE-neutral with
                                 # slightly longer track persistence
                                 # (600f corridor 0.465 vs 0.472)
    # Which Hamming-distance kernel computes the (N1, N2) matrix:
    #   "matmul"   — int8 bit-plane matmul on the MXU (matching/hamming.py)
    #   "pallas"   — fused XOR+popcount VPU kernel (ops/pallas_hamming.py);
    #                requires N1, N2 multiples of 256
    #   "popcount" — naive lax.population_count over the packed words
    # Default set by the on-chip race in ops/bench_kernels.py (KERNELS_r03.md:
    # matmul 0.031 ms (40.2% of int8 peak) vs pallas 0.198 ms vs popcount
    # 0.141 ms at 3072x3072; all three agree bit-exactly).
    kernel: str = "matmul"


@dataclass(frozen=True)
class RansacConfig:
    """Massively parallel hypothesize-and-verify — the completed form of the
    reference's CUDA sketch (src/ransac.cu:8-26) and its 100-iteration serial
    loop (src/RansacFilter.cpp:49-66)."""
    # Batch dim; the reference used 100 serial iters. 2048 was the r02-r03
    # default; with the two-stage verify + LO-seeded multistart refine the
    # winner is recovered from a much rougher consensus, and 1024 measures
    # statistically identical forward-motion accuracy (12-seed race,
    # 15% outliers, 0.5 px noise: median 2.1 deg vs 2.4 at 2048, max 4.6
    # vs 5.0) while halving the stage-1 fit+score cost; 512 starts to
    # degrade (p90 5.7 deg, max 6.9). KERNELS_r04.md §1.
    num_hypotheses: int = 1024
    sample_size: int = 8             # 8-point algorithm (src/RansacFilter.cpp)
    inlier_threshold: float = 2.0    # Sampson error in px (reference: 10 on an
                                     # unnormalized, buggy residual,
                                     # src/RansacFilter.cpp:126)
    min_inliers: int = 15


@dataclass(frozen=True)
class TriangulationConfig:
    reproj_threshold_sq: float = 4.0  # reference src/vslam.cpp:50
    # Delayed-triangulation maturity threshold (tracker step 8). Measured:
    # at 0.5-1 deg nearly every 1-frame-baseline candidate passes and the
    # inserted depths carry a ~1% low bias that COMPOUNDS through the map
    # (insert -> PnP conforms -> next insert); at ~2 deg the bias is gone.
    # Guided frame-to-frame matching (MatchingConfig.guided_radius) keeps
    # feature tracks alive long enough to mature to 2 deg, so the anchor
    # density cost of waiting is small; one-shot widest-baseline refinement
    # (step 8b) further debiases tracks that survive to 2x this threshold.
    min_parallax_deg: float = 2.0
    # PROVISIONAL insertion tier (tracker step 8, MapState.prov): tracks
    # whose accumulated parallax clears this (much lower) bar insert as
    # provisional landmarks — association-eligible (their identity then
    # persists in the map across the detector misses that kill ~33% of
    # mapped-keypoint matches per frame, KERNELS_r04.md §5) but excluded
    # from PnP anchoring and the scale-ratio estimate until the track
    # matures to the supply-adaptive promotion bar below, at which point
    # the landmark is re-triangulated at that baseline and promoted
    # (tracker 8b; cross-break maturity via MapState.first_*). This
    # thickens the
    # anchor supply (the r04 corridor had ~14 alive landmarks in view per
    # frame — the hard cap on PnP anchoring) without the depth-bias
    # compounding that globally lowering min_parallax_deg was measured to
    # reintroduce. 0 disables the tier (inserts only at min_parallax_deg).
    prov_parallax_deg: float = 0.5
    # SUPPLY-ADAPTIVE promotion (tracker 8b): a provisional landmark
    # promotes at promote_parallax_deg; while the frame's live FULL-anchor
    # count sits below anchor_target, the bar relaxes to
    # promote_parallax_lo_deg. The two regimes genuinely want opposite
    # bars (measured, no-BA): the exploration corridor (landmarks stream
    # past, anchors scarce) wants ~5 deg — 12 anchors @ ATE 0.46 vs
    # 8 @ 0.53 at 6 deg and ~5 @ 0.6 map-free; the dense revisit box
    # (landmarks abundant and far) wants 8 deg — 16 anchors @ 0.151 vs
    # 43 @ 0.71 when the 5-deg bar floods it with weak anchors. Keying
    # the bar to the supply gives each regime its own operating point
    # with one config.
    # Measured on the flagship 600-frame corridor draw (the CLI scene,
    # endurance artifact): target 12 / lo 5 deg -> ATE 0.34 at 10
    # anchors/32 associations per frame median — r04-parity ATE (0.35)
    # at 3x its anchor density and 32x its association rate; target 20
    # (always-low-bar on this regime) -> 1.4. On the dense revisit box
    # the target is reached instantly, the high bar governs, and window
    # BA stays strictly net-positive (0.146 vs 0.223 no-BA, 6 events).
    promote_parallax_deg: float = 8.0
    promote_parallax_lo_deg: float = 5.0
    anchor_target: int = 12
    min_depth: float = 0.1
    max_depth: float = 500.0
    # Track-identity gate (tracker step 8): max Hamming distance between a
    # track's first-observation descriptor and its current one. Rejects
    # chained-match identity drift (hops to nearby corners), which is
    # epipolar-consistent under forward motion and poisons triangulated
    # depths (measured: map depth scale 0.93x truth by frame 10 without
    # the gate, 1.00 +- 0.02 with it, oracle poses).
    track_id_hamming_max: int = 56


@dataclass(frozen=True)
class MapConfig:
    """Fixed-capacity functional map (replaces the growable cv::Mat map,
    reference src/PointMap.cpp:5-15)."""
    capacity: int = 1 << 17          # 131072 map points
    obs_per_point: int = 4           # descriptor archive slots per point
                                     # (reference keeps every observation,
                                     # src/PointMap.h:15-16; we keep a rolling K)
    block_size: int = 4096           # shard/scan granularity for association
    # Search-by-projection kernel:
    #   "xla"    — blocked lax.scan of int8 MXU matmuls (point_map.associate).
    #              Default per the on-chip race in KERNELS_r03.md: 0.38 ms vs
    #              pallas 2.55 ms at map=4096, 3.73 vs 4.76 at 51200; at full
    #              capacity 131072 they tie (9.12 vs 8.94, ~23% of int8
    #              peak) — XLA's fused matmul pipeline matches or beats the
    #              hand-tiled kernel at every measured size, and wins big at
    #              small maps (lower fixed overhead).
    #   "pallas" — fused VMEM-resident kernel (ops/pallas_associate.py): the
    #              (block, keypoints) tile never exists in HBM.
    kernel: str = "xla"


@dataclass(frozen=True)
class BAConfig:
    """Gauss-Newton / LM bundle adjustment with Schur complement — the
    component the reference stubbed out (src/optimzer.cpp:1-9)."""
    window: int = 20                 # sliding-window keyframes
    free_cams: int = 8               # newest cams free in window BA; older
                                     # window cams anchor the gauge (see
                                     # keyframes.build_window_problem)
    max_points: int = 8192           # landmarks per BA problem
    max_obs_per_point: int = 16      # point-major observation slots
    iterations: int = 10
    init_damping: float = 1e-3
    damping_up: float = 4.0
    damping_down: float = 0.5
    huber_delta: float = 2.0         # robust loss on reprojection residual (px)
    # How the reduced camera system is assembled (optimizer/ba.py):
    #   "auto"    — one-hot matmul assembly (no scatters, MXU-only) up to
    #               onehot_max_cams, blocked scatter-add beyond. The r04
    #               race (BENCH_BA_r04.json) shows one-hot winning at EVERY
    #               measured size — 8.6x at 20 cams (window BA) and still
    #               4.0x at 256 cams x 64k landmarks x 508k obs (KITTI-00
    #               scale): the Schur product is one (6C, 3P)x(3P, 6C)
    #               matmul, and XLA lowers colliding scatter-adds to a
    #               serial loop. The threshold is now a MEMORY bound, not a
    #               speed crossover: the (P, C, 6, 3) aggregated factors
    #               reach ~2.4 GB at C=256/P=64k and scale as C*P.
    #   "onehot" | "scatter" — force one
    schur_assembly: str = "auto"
    onehot_max_cams: int = 256
    # STRUCTURE-ONLY refinement cadence (pipeline/slam.py
    # _refine_structure), in keyframes; 0 disables. Window BA with every
    # camera fixed = batched multi-view triangulation of the window's
    # landmarks over the keyframe baseline: no gauge freedom, no pose
    # write-back, cannot move the trajectory. It replaces provisional
    # landmarks' biased low-parallax inits with multi-view estimates and
    # PROMOTES the well-spanned ones into PnP anchors. Default OFF: the
    # geometric promotion path (tracker 8b, with the cross-break
    # founding-record restore) reaches the same anchor density from
    # two-view wide-baseline triangulations, and on observation-dense
    # scenes the structure pass floods PnP with many small-span anchors
    # whose aggregate weight outvotes the strong ones (measured dense-box
    # revisit: ATE 0.17 -> 0.42 from this pass alone even at the raised
    # span bars; corridor: no benefit over geometric at equal promote
    # bars). Kept as a capability for detector-starved regimes where
    # keyframe observations are the only usable baseline.
    structure_every: int = 0
    # Propagate an accepted window-BA event's scale correction of the
    # newest keyframe gap into the tracker's motion model (state.vel /
    # state.scale). Requires a solid (non-provisional) gauge bridge; see
    # pipeline/slam.py _run_window_ba. Default OFF: measured on the
    # 150-frame corridor (kf3/lba5) the re-gauge WORSENS ATE 0.70 -> 1.30
    # — in exploration the window's scale direction is noise-dominated
    # and feeding its correction back into the motion model injects that
    # noise into every subsequent frame. Kept as a capability for
    # revisit-dominated regimes.
    rescale_motion_model: bool = False


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh layout for pjit/shard_map execution."""
    axis_hyp: str = "hyp"            # RANSAC hypotheses axis
    axis_map: str = "map"            # map-point / landmark blocks axis
    # data-parallel axis name used when running multiple sequences
    axis_data: str = "data"
    # In sharded-map tracking mode, also split the RANSAC hypothesis batch
    # over the map axis (per-device fits + subset scores, all_gather'd
    # top-k, replicated full-N selection — parallel/sharded_tracker.py).
    # This makes a mesh run FASTER, not just bigger: RANSAC is the
    # dominant tracking stage (KERNELS_r04.md) and its stage-1 cost then
    # scales ~1/D. Off: every device fits the full batch redundantly
    # (the r03 capacity-only behavior, bit-identical across mesh sizes).
    shard_hypotheses: bool = True


@dataclass(frozen=True)
class PipelineConfig:
    keyframe_every: int = 5
    keyframe_min_inlier_ratio: float = 0.35
    max_keyframes: int = 512
    local_ba_every: int = 5          # run window BA every N keyframes
    image_dtype: str = "float32"
    # Rotation low-pass (tracker, end of step): blend the committed
    # rotation this fraction toward the constant-velocity prediction.
    # Motivation: per-frame rotation noise random-walks to +-3 deg of yaw
    # over 600 corridor frames and dominates long-run ATE (scale stays
    # flat to 0.1%). Default OFF (0): measured on that exact scenario the
    # blend WORSENS ATE (1.0 -> 2.2 at 0.3, 1.1 at 0.5) — the scenario's
    # turn rate itself wanders per frame, so the prediction lags reality
    # and the lag error is persistent (the map bakes it in) while the
    # noise it removes was zero-mean. Only worth enabling on platforms
    # with genuinely smooth rotation dynamics.
    rot_smooth: float = 0.0
    # PnP-correction low-pass: commit only this fraction of the (already
    # magnitude-re-gauged) PnP correction relative to the essential-chain
    # candidate each frame. Default 1.0 (full correction): measured at
    # 0.4 on the 600-frame corridor the partial correction DIVERGES (ATE
    # 11-14) — the un-applied remainder of each correction re-appears
    # grown the next frame (the candidate chain drifts away from the map
    # faster than the integrator closes), so the blend must stay 1.0
    # unless the candidate chain itself is near-unbiased.
    pnp_blend: float = 1.0


@dataclass(frozen=True)
class VSLAMConfig:
    camera: CameraConfig = field(default_factory=CameraConfig)
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    matching: MatchingConfig = field(default_factory=MatchingConfig)
    ransac: RansacConfig = field(default_factory=RansacConfig)
    triangulation: TriangulationConfig = field(default_factory=TriangulationConfig)
    map: MapConfig = field(default_factory=MapConfig)
    ba: BAConfig = field(default_factory=BAConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    pipeline: PipelineConfig = field(default_factory=PipelineConfig)

    # ---- (de)serialization ------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(text: str) -> "VSLAMConfig":
        raw = json.loads(text)
        return VSLAMConfig(
            camera=CameraConfig(**raw.get("camera", {})),
            frontend=FrontendConfig(**raw.get("frontend", {})),
            matching=MatchingConfig(**raw.get("matching", {})),
            ransac=RansacConfig(**raw.get("ransac", {})),
            triangulation=TriangulationConfig(**raw.get("triangulation", {})),
            map=MapConfig(**raw.get("map", {})),
            ba=BAConfig(**raw.get("ba", {})),
            mesh=MeshConfig(**raw.get("mesh", {})),
            pipeline=PipelineConfig(**raw.get("pipeline", {})),
        )

    def replace(self, **kw) -> "VSLAMConfig":
        return dataclasses.replace(self, **kw)


def small_config() -> VSLAMConfig:
    """A tiny config for CPU tests and multi-chip dry runs."""
    return VSLAMConfig(
        camera=CameraConfig(width=256, height=192, fx=200.0, fy=200.0,
                            cx=128.0, cy=96.0),
        frontend=FrontendConfig(max_keypoints=256, grid_rows=4, grid_cols=4,
                                border=17),
        # guided window scaled to the 256-px frame (default 48 fits KITTI
        # width); a loose window on a small frame lets chained matches hop
        # between lookalike corners (track identity drift, tracker step 8)
        matching=MatchingConfig(max_matches=256, guided_radius=20.0),
        ransac=RansacConfig(num_hypotheses=128),
        map=MapConfig(capacity=4096, block_size=512),
        ba=BAConfig(window=6, free_cams=3, max_points=512,
                    max_obs_per_point=8, iterations=8, huber_delta=2.5),
        pipeline=PipelineConfig(keyframe_every=2, max_keyframes=32,
                                local_ba_every=2),
    )
