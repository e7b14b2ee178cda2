"""Per-frame feature extraction (port of ``vslam_tpu/frontend/frame.py``,
the upright front end): detect -> describe into one fixed-capacity
FrameFeatures."""
from __future__ import annotations

import torch

from ..config import FrontendConfig
from ..core.types import FrameFeatures
from . import descriptors, features


def extract_features(img, cfg: FrontendConfig, height: int,
                     width: int) -> FrameFeatures:
    """img: (height, width) float32 grayscale in [0, 1] -> FrameFeatures,
    upright BRIEF with zero angles."""
    if cfg.oriented or cfg.track_carry:
        raise ValueError("the reference has the upright front end only")
    uv, score, mask = features.detect(img, cfg, height, width)
    blurred = features.gaussian_blur(img, cfg.blur_sigma)
    angle = torch.zeros_like(score)
    desc = descriptors.describe_dense_upright(blurred, uv, cfg)
    # zero the descriptors of invalid slots so padded rows can't match
    desc = torch.where(mask[:, None], desc, 0)
    return FrameFeatures(uv=uv, desc=desc, score=score, mask=mask,
                         angle=angle)
