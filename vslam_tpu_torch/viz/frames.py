"""Per-frame annotation rendering.

Offline equivalent of the reference's live cv::imshow window
(reference src/vslam.cpp:286): keypoints as circles (``draw``,
src/Frame.cpp:8-13), match lines between consecutive frames
(src/vslam.cpp:121), and reprojected map points (src/vslam.cpp:227-230) —
drawn with PIL onto PNG frames, headless-friendly.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def annotate_frame(
    img: np.ndarray,
    kp_uv: Optional[np.ndarray] = None,
    kp_mask: Optional[np.ndarray] = None,
    match_uv1: Optional[np.ndarray] = None,
    match_uv2: Optional[np.ndarray] = None,
    match_mask: Optional[np.ndarray] = None,
    path: Optional[str] = None,
):
    """img: (H, W) float32 in [0,1]. Returns a PIL Image (saves if path)."""
    from PIL import Image, ImageDraw

    rgb = np.stack([np.clip(img * 255, 0, 255).astype(np.uint8)] * 3, -1)
    im = Image.fromarray(rgb)
    d = ImageDraw.Draw(im)

    if match_uv1 is not None and match_uv2 is not None:
        mm = (match_mask if match_mask is not None
              else np.ones(len(match_uv1), bool))
        for (x1, y1), (x2, y2) in zip(match_uv1[mm], match_uv2[mm]):
            d.line([(float(x1), float(y1)), (float(x2), float(y2))],
                   fill=(255, 64, 64), width=1)

    if kp_uv is not None:
        km = kp_mask if kp_mask is not None else np.ones(len(kp_uv), bool)
        for x, y in kp_uv[km]:
            d.ellipse([float(x) - 2, float(y) - 2, float(x) + 2, float(y) + 2],
                      outline=(64, 255, 64))

    if path:
        im.save(path)
    return im
