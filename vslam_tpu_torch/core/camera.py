"""Pinhole camera projection on torch tensors.

Port of the part of ``vslam_tpu/core/camera.py`` the tracking step uses
(same conventions: ``T_wc`` is the camera-to-world pose,
``P = K · T_cw[:3, :]``).
"""
from __future__ import annotations

import torch

from . import lie


def projection_matrix(K, T_wc):
    """P = K [R_cw | t_cw] : (…,3,4)."""
    T_cw = lie.inv_T(T_wc)
    return torch.einsum("ij,...jk->...ik", K, T_cw[..., :3, :])
