"""Per-frame feature extraction (port of ``vslam_tpu/frontend/frame.py``):
detect -> orient -> describe into one fixed-capacity FrameFeatures."""
from __future__ import annotations

import torch

from ..config import FrontendConfig
from ..core.types import FrameFeatures
from . import descriptors, features


def extract_features(img, cfg: FrontendConfig, height: int, width: int,
                     carry_uv=None, carry_mask=None) -> FrameFeatures:
    """img: (height, width) float32 grayscale in [0, 1] -> FrameFeatures.

    ``carry_uv`` / ``carry_mask``: optional predicted positions of carried
    keypoints (mapped-track survival, ``features.detect_with_carry``);
    None selects the plain detector. ``cfg.oriented`` selects steered BRIEF
    on the dense orientation map; otherwise upright BRIEF with zero angles.
    """
    if carry_uv is not None:
        uv, score, mask = features.detect_with_carry(
            img, cfg, height, width, carry_uv, carry_mask)
    else:
        uv, score, mask = features.detect(img, cfg, height, width)
    blurred = features.gaussian_blur(img, cfg.blur_sigma)
    if cfg.oriented:
        angle = descriptors.orientations_at(blurred, uv, cfg.patch_radius)
        desc = descriptors.describe(blurred, uv, angle, cfg)
    else:
        angle = torch.zeros_like(score)
        desc = descriptors.describe_dense_upright(blurred, uv, cfg)
    # zero the descriptors of invalid slots so padded rows can't match
    desc = torch.where(mask[:, None], desc, 0)
    return FrameFeatures(uv=uv, desc=desc, score=score, mask=mask,
                         angle=angle)
