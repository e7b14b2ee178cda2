"""Synthetic scene + sequence generator with exact ground truth.

A numpy-only copy of ``vslam_tpu/datasets/synthetic.py`` (the port cannot
import the reference package without jax); ``tests/test_torch_interop.py``
holds both copies to identical outputs.

The reference ships no data (test_videos/ is gitignored, reference
.gitignore:7) and relies on human inspection of a live viewer. The rebuild's
test strategy (SURVEY.md §4) instead validates every stage against synthetic
scenes with known geometry:

  * ``make_scene``        — random textured 3D landmarks.
  * ``make_trajectory``   — smooth camera path (T_wc per frame).
  * ``correspondences``   — exact 2D-2D / 2D-3D ground truth for geometry tests.
  * ``render_sequence``   — images where each landmark is drawn as a fixed
    random patch, so corner detection *and* descriptor matching work on the
    rendered frames end-to-end.

All generation is host-side numpy (deterministic via seed); outputs feed the
jitted TPU pipeline as device arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Scene:
    xyz: np.ndarray        # (P, 3) world points
    patches: np.ndarray    # (P, ps, ps) per-landmark texture in [0,1]
    color: np.ndarray      # (P, 3) RGB in [0,1]


def _box3(p: np.ndarray) -> np.ndarray:
    """3x3 box filter over the last two axes, edge-padded (numpy-only)."""
    pp = np.pad(p, ((0, 0), (1, 1), (1, 1)), mode="edge")
    out = np.zeros_like(p)
    for dy in range(3):
        for dx in range(3):
            out += pp[:, dy:dy + p.shape[1], dx:dx + p.shape[2]]
    return out / 9.0


def _make_patches(rng, num_points: int, patch_size: int) -> np.ndarray:
    # Patch design: HIGH-contrast random binary texture (distinctive BRIEF
    # bits per landmark that survive blur + depth downsampling — real-world
    # corners differ in their surroundings, and a low-contrast surround made
    # every distant landmark look like its identical center junction, which
    # defeated descriptor identity entirely), SMOOTHED by a 3x3 box so the
    # surround's gradient energy stays well below the center junction's:
    # the raw binary texture put Shi-Tomasi corners at its own junctions —
    # several near-identical detections per patch, which the Lowe ratio
    # test then rejected (~20% fewer matches) and which restarted feature
    # tracks before they could mature past the parallax gate (measured:
    # map 32 vs 48 points after 6 frames; 250-frame corridor ATE 1.01
    # sharp-binary vs 0.11 smoothed-binary vs 0.22 old-low-contrast).
    # A high-contrast checkerboard X-corner at the patch center makes the
    # Shi-Tomasi maximum localize at the landmark's projection.
    patches = np.where(rng.uniform(size=(num_points, patch_size, patch_size))
                       > 0.5, 0.85, 0.15).astype(np.float32)
    patches = _box3(patches)
    c = patch_size // 2
    hi = rng.uniform(0.9, 1.0, (num_points, 1, 1)).astype(np.float32)
    lo = rng.uniform(0.0, 0.1, (num_points, 1, 1)).astype(np.float32)
    q = 2  # quadrant half-size; X-junction at (c-0.5, c-0.5)
    patches[:, c - q : c, c - q : c] = hi
    patches[:, c : c + q, c : c + q] = hi
    patches[:, c - q : c, c : c + q] = lo
    patches[:, c : c + q, c - q : c] = lo
    return patches


def make_scene(
    num_points: int = 4000,
    seed: int = 0,
    extent=(40.0, 12.0, 60.0),
    z_min: float = 4.0,
    patch_size: int = 9,
) -> Scene:
    rng = np.random.RandomState(seed)
    xyz = np.stack(
        [
            rng.uniform(-extent[0], extent[0], num_points),
            rng.uniform(-extent[1], extent[1], num_points),
            rng.uniform(z_min, extent[2], num_points),
        ],
        axis=1,
    ).astype(np.float32)
    patches = _make_patches(rng, num_points, patch_size)
    color = rng.uniform(0.2, 1.0, (num_points, 3)).astype(np.float32)
    return Scene(xyz=xyz, patches=patches, color=color)


def make_corridor_scene(
    poses: np.ndarray,
    num_points: int = 20000,
    seed: int = 0,
    lateral: float = 14.0,
    vertical: float = 5.0,
    ahead: Tuple[float, float] = (4.0, 45.0),
    patch_size: int = 9,
) -> Scene:
    """Landmarks distributed along a (long) camera trajectory.

    ``make_scene`` fills a fixed box, which a 500+-frame endurance path
    walks straight out of; here each landmark anchors to a random pose of
    the path and is offset ahead of it in the camera frame, so features are
    available for the whole run — the synthetic analogue of driving a long
    KITTI sequence.
    """
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, len(poses), num_points)
    T = np.asarray(poses, np.float32)[idx]               # (P, 4, 4)
    right, up, fwd = T[:, :3, 0], T[:, :3, 1], T[:, :3, 2]
    pos = T[:, :3, 3]
    xyz = (
        pos
        + fwd * rng.uniform(ahead[0], ahead[1], num_points)[:, None]
        + right * (rng.randn(num_points) * lateral)[:, None]
        + up * (rng.randn(num_points) * vertical)[:, None]
    ).astype(np.float32)
    patches = _make_patches(rng, num_points, patch_size)
    color = rng.uniform(0.2, 1.0, (num_points, 3)).astype(np.float32)
    return Scene(xyz=xyz, patches=patches, color=color)


def make_trajectory(
    num_frames: int,
    step: float = 0.4,
    yaw_rate: float = 0.004,
    sway: float = 0.05,
    seed: int = 1,
) -> np.ndarray:
    """Forward-dominant smooth path. Returns (F, 4, 4) T_wc poses."""
    rng = np.random.RandomState(seed)
    poses = np.zeros((num_frames, 4, 4), np.float32)
    T = np.eye(4, dtype=np.float32)
    yaw = 0.0
    for i in range(num_frames):
        poses[i] = T
        yaw += yaw_rate * (1.0 + 0.3 * rng.randn())
        cy, sy = np.cos(yaw), np.sin(yaw)
        R = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float32)
        d = np.array(
            [sway * rng.randn(), 0.3 * sway * rng.randn(), step], np.float32
        )
        delta = np.eye(4, dtype=np.float32)
        delta[:3, :3] = R @ np.linalg.inv(T[:3, :3] @ R) @ (T[:3, :3] @ R)
        # local step: rotate then translate in the camera frame
        delta[:3, :3] = _yaw_matrix(yaw_rate)
        delta[:3, 3] = d
        T = (T @ delta).astype(np.float32)
    return poses


def _yaw_matrix(a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


def project_w(K: np.ndarray, T_wc: np.ndarray, xyz: np.ndarray):
    """Project world points into a camera. Returns uv (P,2), depth (P,)."""
    T_cw = np.linalg.inv(T_wc)
    Xc = xyz @ T_cw[:3, :3].T + T_cw[:3, 3]
    z = Xc[:, 2]
    safe = np.where(np.abs(z) < 1e-9, 1e-9, z)
    uvw = Xc @ K.T
    return uvw[:, :2] / safe[:, None], z


def correspondences(
    K: np.ndarray,
    T_wc_1: np.ndarray,
    T_wc_2: np.ndarray,
    xyz: np.ndarray,
    width: int,
    height: int,
    noise_px: float = 0.0,
    seed: int = 0,
):
    """Exact two-view ground truth: returns uv1, uv2, visible mask, xyz."""
    rng = np.random.RandomState(seed)
    uv1, z1 = project_w(K, T_wc_1, xyz)
    uv2, z2 = project_w(K, T_wc_2, xyz)
    vis = (
        (z1 > 0.1) & (z2 > 0.1)
        & (uv1[:, 0] >= 0) & (uv1[:, 0] < width)
        & (uv1[:, 1] >= 0) & (uv1[:, 1] < height)
        & (uv2[:, 0] >= 0) & (uv2[:, 0] < width)
        & (uv2[:, 1] >= 0) & (uv2[:, 1] < height)
    )
    if noise_px > 0:
        uv1 = uv1 + rng.randn(*uv1.shape) * noise_px
        uv2 = uv2 + rng.randn(*uv2.shape) * noise_px
    return uv1.astype(np.float32), uv2.astype(np.float32), vis, xyz


def render_frame(
    K: np.ndarray,
    T_wc: np.ndarray,
    scene: Scene,
    width: int,
    height: int,
    background: float = 0.35,
) -> np.ndarray:
    """Render one grayscale frame: splat each visible landmark's patch at its
    projection (far-to-near painter's order). Returns (H, W) float32 in [0,1]."""
    uv, z = project_w(K, T_wc, scene.xyz)
    ps = scene.patches.shape[1]
    r = ps // 2
    img = np.full((height, width), background, np.float32)
    vis = (
        (z > 0.2)
        & (uv[:, 0] >= r + 1) & (uv[:, 0] < width - r - 1)
        & (uv[:, 1] >= r + 1) & (uv[:, 1] < height - r - 1)
    )
    order = np.argsort(-z)  # far first; near landmarks overwrite
    order = order[vis[order]]
    for i in order:
        x, y = uv[i]
        xi, yi = int(np.floor(x)), int(np.floor(y))
        fx, fy = x - xi, y - yi
        # sub-pixel placement: resample the patch by the fractional offset
        # (bilinear) so detector localization ground truth is exact, then
        # paint at the integer position.
        p = scene.patches[i]
        pp = np.pad(p, 1, mode="edge")
        # value at output pixel (r+dy, c+dx) = patch sampled at (r-fy, c-fx)
        w00 = (1 - fy) * (1 - fx)
        w01 = (1 - fy) * fx
        w10 = fy * (1 - fx)
        w11 = fy * fx
        shifted = (
            w00 * pp[1:-1, 1:-1]
            + w01 * pp[1:-1, :-2]
            + w10 * pp[:-2, 1:-1]
            + w11 * pp[:-2, :-2]
        )
        img[yi - r : yi + r + 1, xi - r : xi + r + 1] = shifted
    return img


def render_sequence(
    K: np.ndarray,
    poses: np.ndarray,
    scene: Scene,
    width: int,
    height: int,
) -> np.ndarray:
    """(F, H, W) float32 grayscale sequence."""
    return np.stack(
        [render_frame(K, poses[i], scene, width, height) for i in range(len(poses))]
    )
