"""Real-data loaders: KITTI odometry, TUM RGB-D (mono), and raw video.

The reference ingests one video via cv::VideoCapture (reference
src/vslam.cpp:24) and crashes at end-of-stream (Frame.cpp:56 on an empty
frame — SURVEY.md §5). These loaders yield fixed-size grayscale float32
frames with clean termination, plus calibration, and ground-truth poses
where the dataset provides them.

All loaders are generators of (frame_index, image) and expose `.camera`
(a CameraConfig) so the pipeline is calibration-correct per dataset.
"""
from __future__ import annotations

import os
from typing import Iterator, Optional, Tuple

import numpy as np

from ..config import CameraConfig


def _to_gray_f32(img: np.ndarray) -> np.ndarray:
    if img.ndim == 3:
        img = img[..., :3].astype(np.float32) @ np.array(
            [0.114, 0.587, 0.299], np.float32
        )  # BGR weights (cv2 order)
        return img / 255.0
    img = img.astype(np.float32)
    return img / 255.0 if img.max() > 1.5 else img


def _resize_pad(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """Scale to fit then zero-pad to exactly (height, width)."""
    import cv2
    h, w = img.shape[:2]
    s = min(width / w, height / h)
    nw, nh = int(round(w * s)), int(round(h * s))
    r = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_AREA)
    out = np.zeros((height, width), np.float32)
    out[:nh, :nw] = r
    return out


class KittiOdometry:
    """KITTI odometry grayscale sequence (image_0) + calib + GT poses."""

    def __init__(self, root: str, sequence: str = "00",
                 target: Optional[Tuple[int, int]] = None):
        self.seq_dir = os.path.join(root, "sequences", sequence)
        self.img_dir = os.path.join(self.seq_dir, "image_0")
        if not os.path.isdir(self.img_dir):
            raise FileNotFoundError(self.img_dir)
        self.files = sorted(
            f for f in os.listdir(self.img_dir) if f.endswith(".png")
        )
        P0 = self._load_calib()
        self.target = target
        fx, fy, cx, cy = P0[0, 0], P0[1, 1], P0[0, 2], P0[1, 2]
        import cv2
        first = cv2.imread(os.path.join(self.img_dir, self.files[0]),
                           cv2.IMREAD_GRAYSCALE)
        h, w = first.shape
        if target is not None:
            tw, th = target
            s = min(tw / w, th / h)
            fx, fy, cx, cy = fx * s, fy * s, cx * s, cy * s
            w, h = tw, th
        self.camera = CameraConfig(width=w, height=h, fx=float(fx),
                                   fy=float(fy), cx=float(cx), cy=float(cy))
        pose_file = os.path.join(root, "poses", sequence + ".txt")
        self.gt_poses = None
        if os.path.exists(pose_file):
            from ..utils.trajectory import load_kitti
            self.gt_poses = load_kitti(pose_file)

    def _load_calib(self) -> np.ndarray:
        calib = os.path.join(self.seq_dir, "calib.txt")
        with open(calib) as f:
            for line in f:
                if line.startswith("P0:"):
                    vals = np.array([float(v) for v in line.split()[1:]])
                    return vals.reshape(3, 4)
        raise ValueError(f"no P0 in {calib}")

    def __len__(self):
        return len(self.files)

    def __iter__(self) -> Iterator[Tuple[int, np.ndarray]]:
        # Preferred path: the native threaded prefetcher (C++ PNG decode
        # overlapping the device compute of the previous frame); falls back
        # to synchronous cv2 when the native lib is unavailable.
        paths = [os.path.join(self.img_dir, f) for f in self.files]
        try:
            from ..utils.native import ImagePrefetcher
            import cv2
            first = cv2.imread(paths[0], cv2.IMREAD_GRAYSCALE)
            h, w = first.shape
            pf = ImagePrefetcher(paths, w, h, workers=3, lookahead=8)
            try:
                for i, g in pf:
                    if self.target is not None:
                        g = _resize_pad(g, *self.target)
                    yield i, g
            finally:
                pf.close()
            return
        except Exception:
            pass
        import cv2
        for i, p in enumerate(paths):
            img = cv2.imread(p, cv2.IMREAD_GRAYSCALE)
            if img is None:
                return
            g = _to_gray_f32(img)
            if self.target is not None:
                g = _resize_pad(g, *self.target)
            yield i, g


class TumRgbdMono:
    """TUM RGB-D sequence, RGB stream only (monocular).

    Calibration is selected PER VARIANT from the sequence path — the three
    Freiburg Kinects have different intrinsics and distortion (fr1 strongly
    radial; fr3's released images are pre-rectified), so applying fr1
    calibration to an fr2/fr3 sequence silently degrades ATE. Explicit
    ``intrinsics``/``distortion`` arguments override detection.
    Values from the TUM RGB-D benchmark camera-calibration page
    (ROS default / OpenCV model, (fx, fy, cx, cy) + (k1, k2, p1, p2, k3)).
    """

    CALIBRATIONS = {
        "fr1": ((517.3, 516.5, 318.6, 255.3),
                (0.2624, -0.9531, -0.0054, 0.0026, 1.1633)),
        "fr2": ((520.9, 521.0, 325.1, 249.7),
                (0.2312, -0.7849, -0.0033, -0.0001, 0.9172)),
        "fr3": ((535.4, 539.2, 320.1, 247.6), None),  # released rectified
    }
    # kept for backward compatibility: the fr1 values
    DEFAULT_INTRINSICS = CALIBRATIONS["fr1"][0]
    DEFAULT_DISTORTION = CALIBRATIONS["fr1"][1]

    @classmethod
    def detect_variant(cls, root: str) -> str:
        """fr1/fr2/fr3 from the sequence directory name (TUM names sequences
        ``rgbd_dataset_freiburg<N>_<motion>``); fr1 when unrecognizable."""
        name = os.path.basename(os.path.normpath(root)).lower()
        for variant, tag in (("fr1", "freiburg1"), ("fr2", "freiburg2"),
                             ("fr3", "freiburg3")):
            if tag in name or f"fr{variant[-1]}_" in name \
                    or name.startswith(variant):
                return variant
        return "fr1"

    def __init__(self, root: str, target: Optional[Tuple[int, int]] = None,
                 intrinsics: Optional[Tuple[float, float, float, float]] = None,
                 distortion: Optional[Tuple[float, ...]] = "default"):
        self.root = root
        self.variant = self.detect_variant(root)
        cal_K, cal_dist = self.CALIBRATIONS[self.variant]
        if distortion == "default":
            # default coefficients belong to the detected variant's
            # intrinsics; explicit intrinsics invalidate them
            distortion = cal_dist if intrinsics is None else None
        self.distortion = distortion
        if intrinsics is None:
            intrinsics = cal_K
        rgb_txt = os.path.join(root, "rgb.txt")
        if not os.path.exists(rgb_txt):
            raise FileNotFoundError(rgb_txt)
        self.entries = []
        with open(rgb_txt) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                ts, rel = line.split()[:2]
                self.entries.append((float(ts), rel))
        fx, fy, cx, cy = intrinsics
        w, h = 640, 480
        # undistortion happens at native resolution with the native K
        self._native_K = (fx, fy, cx, cy)
        self.target = target
        if target is not None:
            tw, th = target
            s = min(tw / w, th / h)
            fx, fy, cx, cy = fx * s, fy * s, cx * s, cy * s
            w, h = tw, th
        self.camera = CameraConfig(width=w, height=h, fx=fx, fy=fy,
                                   cx=cx, cy=cy)
        gt_file = os.path.join(root, "groundtruth.txt")
        self.gt = None
        if os.path.exists(gt_file):
            from ..utils.trajectory import load_tum
            self.gt = load_tum(gt_file)

    def __len__(self):
        return len(self.entries)

    def _undistort_maps(self):
        """Precompute the pixel remap once (numpy; no cv2 dependency for the
        math — cv2.initUndistortRectifyMap would be equivalent)."""
        import numpy as np
        fx, fy, cx, cy = self._native_K
        k1, k2, p1, p2, k3 = (tuple(self.distortion) + (0.0,) * 5)[:5]
        w, h = 640, 480
        u, v = np.meshgrid(np.arange(w, dtype=np.float32),
                           np.arange(h, dtype=np.float32))
        x = (u - cx) / fx
        y = (v - cy) / fy
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        return (xd * fx + cx).astype(np.float32), \
            (yd * fy + cy).astype(np.float32)

    def __iter__(self):
        import cv2
        maps = self._undistort_maps() if self.distortion is not None else None
        for i, (ts, rel) in enumerate(self.entries):
            img = cv2.imread(os.path.join(self.root, rel))
            if img is None:
                return
            g = _to_gray_f32(img)
            if maps is not None:
                g = cv2.remap(g, maps[0], maps[1], cv2.INTER_LINEAR)
            if self.target is not None:
                g = _resize_pad(g, *self.target)
            yield i, g


class VideoFile:
    """Raw video via OpenCV — the reference's input path (src/vslam.cpp:24),
    with the focal length supplied by config instead of env var F."""

    def __init__(self, path: str, focal: float = 525.0,
                 target: Optional[Tuple[int, int]] = None):
        import cv2
        self.path = path
        cap = cv2.VideoCapture(path)
        if not cap.isOpened():
            raise FileNotFoundError(path)
        w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        self.n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        cap.release()
        fx = fy = focal
        cx, cy = w / 2.0, h / 2.0  # reference K build (src/vslam.cpp:32-33)
        self.target = target
        if target is not None:
            tw, th = target
            s = min(tw / w, th / h)
            fx, fy, cx, cy = fx * s, fy * s, cx * s, cy * s
            w, h = tw, th
        self.camera = CameraConfig(width=w, height=h, fx=fx, fy=fy,
                                   cx=cx, cy=cy)

    def __len__(self):
        return max(self.n, 0)

    def __iter__(self):
        import cv2
        cap = cv2.VideoCapture(self.path)
        i = 0
        while True:
            ok, img = cap.read()
            if not ok or img is None:   # clean end-of-stream
                break
            g = _to_gray_f32(img)
            if self.target is not None:
                g = _resize_pad(g, *self.target)
            yield i, g
            i += 1
        cap.release()
