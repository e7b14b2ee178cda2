"""Per-frame feature extraction (port of ``vslam_tpu/frontend/frame.py``,
plain detector + upright BRIEF — the default config)."""
from __future__ import annotations

import torch

from ..config import FrontendConfig
from ..core.types import FrameFeatures
from . import descriptors, features


def extract_features(img, cfg: FrontendConfig, height: int,
                     width: int) -> FrameFeatures:
    """img: (height, width) float32 grayscale in [0, 1] -> FrameFeatures.

    Only the reference's defaults are ported: the plain detector (no track
    carry) and upright BRIEF (``oriented=False``).
    """
    if cfg.track_carry or cfg.oriented:
        raise NotImplementedError(
            "track_carry / oriented descriptors are not ported yet")
    uv, score, mask = features.detect(img, cfg, height, width)
    blurred = features.gaussian_blur(img, cfg.blur_sigma)
    desc = descriptors.describe_dense_upright(blurred, uv, cfg)
    # zero the descriptors of invalid slots so padded rows can't match
    desc = torch.where(mask[:, None], desc, 0)
    return FrameFeatures(uv=uv, desc=desc, score=score, mask=mask,
                         angle=torch.zeros_like(score))
