"""Corner detection: separable shift-MAC filters + tiled top-k.

Port of ``vslam_tpu/frontend/features.py``: ``detect`` and, for mapped-track
carry, ``refine_tracked`` and ``detect_with_carry``. The filters stay as
shift-MACs in the reference's order of operations, not ``F.conv2d``: cuDNN
runs f32 convolutions in TF32 by default and would reorder the sums. Top-k
and the carry's budget order are stable sorts, so ties (``-inf`` padding
in sparse tiles, the carried keypoints' collapsed priority) keep the lower
index first, as ``jax.lax.top_k`` and ``jnp.argsort`` do.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import FrontendConfig


def _clamped_index(n: int, offset: int, device):
    return torch.clamp(torch.arange(n, device=device) + offset, 0, n - 1)


def _shift(img, dy: int, dx: int):
    """img shifted so out[y,x] = img[y+dy, x+dx], edge-padded."""
    H, W = img.shape
    if dy:
        img = img.index_select(0, _clamped_index(H, dy, img.device))
    if dx:
        img = img.index_select(1, _clamped_index(W, dx, img.device))
    return img


def _sep_filter(img, k, radius: int, axis: int):
    """1D correlation along axis via shifts + multiply-adds (reference
    order: out = 0; out = out + k[i] * shift_i)."""
    out = torch.zeros_like(img)
    for i in range(2 * radius + 1):
        o = i - radius
        s = _shift(img, o, 0) if axis == 0 else _shift(img, 0, o)
        out = out + float(k[i]) * s
    return out


def sobel_gradients(img):
    """Ix, Iy via separable Sobel ([1,2,1] smooth ⊗ [-1,0,1] diff)."""
    smooth = np.array([1.0, 2.0, 1.0]) / 4.0
    diff = np.array([-1.0, 0.0, 1.0]) / 2.0
    ix = _sep_filter(_sep_filter(img, smooth, 1, axis=0), diff, 1, axis=1)
    iy = _sep_filter(_sep_filter(img, smooth, 1, axis=1), diff, 1, axis=0)
    return ix, iy


def _box_filter(img, radius: int):
    k = np.ones(2 * radius + 1) / float(2 * radius + 1)
    return _sep_filter(_sep_filter(img, k, radius, axis=0), k, radius, axis=1)


def gaussian_kernel_1d(sigma: float, radius: int):
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def gaussian_blur(img, sigma: float, radius: int | None = None):
    """Separable Gaussian blur (shift-add stencil)."""
    if radius is None:
        radius = max(1, int(3.0 * sigma + 0.5))
    k = gaussian_kernel_1d(sigma, radius)
    img = _sep_filter(img, k, radius, axis=1)
    return _sep_filter(img, k, radius, axis=0)


def corner_response(img, score: str = "shi_tomasi", harris_k: float = 0.04,
                    window_radius: int = 2):
    """Structure-tensor corner response map (Shi-Tomasi min eigenvalue, or
    Harris det - k tr^2)."""
    ix, iy = sobel_gradients(img)
    sxx = _box_filter(ix * ix, window_radius)
    syy = _box_filter(iy * iy, window_radius)
    sxy = _box_filter(ix * iy, window_radius)
    if score == "harris":
        det = sxx * syy - sxy * sxy
        tr = sxx + syy
        return det - harris_k * tr * tr
    half_tr = 0.5 * (sxx + syy)
    d = sxx - syy
    disc = torch.sqrt(torch.clamp(0.25 * (d * d) + sxy * sxy, min=0.0))
    return half_tr - disc


def nms(response, radius: int):
    """Keep pixels equal to their (2r+1)^2 window max (separable shift-max)."""
    pooled = response
    for axis in (0, 1):
        acc = pooled
        for o in range(1, radius + 1):
            if axis == 0:
                acc = torch.maximum(acc, _shift(pooled, o, 0))
                acc = torch.maximum(acc, _shift(pooled, -o, 0))
            else:
                acc = torch.maximum(acc, _shift(pooled, 0, o))
                acc = torch.maximum(acc, _shift(pooled, 0, -o))
        pooled = acc
    return response >= pooled


def _subpixel_offsets(response, ys, xs):
    """Quadratic 3-point sub-pixel refinement along each axis."""
    H, W = response.shape

    def sample(dy, dx):
        yy = torch.clamp(ys + dy, 0, H - 1)
        xx = torch.clamp(xs + dx, 0, W - 1)
        return response[yy, xx]

    c = sample(0, 0)

    def axis_offset(m, p):
        denom = m - 2.0 * c + p
        safe = torch.where(torch.abs(denom) < 1e-9, 1e-9, denom)
        return torch.clamp(0.5 * (m - p) / safe, -0.5, 0.5)

    dx = axis_offset(sample(0, -1), sample(0, 1))
    dy = axis_offset(sample(-1, 0), sample(1, 0))
    return dy, dx


def _pixel(coord, size: int):
    """round(coord) clipped to [0, size): the reference's
    ``clip(round(c).astype(int32), 0, size - 1)``, in int64 so a far-off
    prediction saturates instead of wrapping."""
    return torch.clamp(torch.round(coord).long(), 0, size - 1)


def refine_tracked(resp, prev_uv, prev_mask, border: int,
                   height: int, width: int, radius: int = 3):
    """Re-localize carried keypoints at the response maximum of the
    (2r+1)^2 window around their predicted positions (see the reference
    docstring): one (N, (2r+1)^2) gather, the first-index argmax, then the
    sub-pixel offsets. Returns (uv (N, 2), score (N,), ok (N,))."""
    n = prev_uv.shape[0]
    xi = _pixel(prev_uv[:, 0], width)
    yi = _pixel(prev_uv[:, 1], height)
    d = torch.arange(-radius, radius + 1, device=resp.device)
    wy = torch.clamp(yi[:, None, None] + d[None, :, None], 0, height - 1)
    wx = torch.clamp(xi[:, None, None] + d[None, None, :], 0, width - 1)
    win = resp[wy, wx].reshape(n, -1)                   # (N, (2r+1)^2)
    score = win.amax(dim=1)
    flat = torch.argmax(win, dim=1)      # the first index of the max
    w = 2 * radius + 1
    ys = torch.clamp(yi + flat // w - radius, 0, height - 1)
    xs = torch.clamp(xi + flat % w - radius, 0, width - 1)
    dy, dx = _subpixel_offsets(resp, ys, xs)
    uv = torch.stack([xs.float() + dx, ys.float() + dy], dim=1)
    ok = (prev_mask & (xs >= border) & (xs < width - border)
          & (ys >= border) & (ys < height - border) & (score > 0.0))
    return uv, score, ok


def _chebyshev_within(a, b, r: float):
    """(Na, Nb) bool: max(|du|, |dv|) <= r, one (Na, Nb) f32 plane at a
    time instead of an (Na, Nb, 2) difference tensor."""
    du = torch.abs(a[:, None, 0] - b[None, :, 0])
    dv = torch.abs(a[:, None, 1] - b[None, :, 1])
    return torch.maximum(du, dv) <= r


def detect(img, cfg: FrontendConfig, height: int, width: int):
    """Detect corners on a (height, width) grayscale image.

    Returns (uv (N,2) f32, score (N,) f32, mask (N,) bool),
    N = cfg.max_keypoints (see vslam_tpu.frontend.features.detect).
    """
    resp = corner_response(img, cfg.score, cfg.harris_k)
    return _select(resp, cfg, height, width)


def detect_with_carry(img, cfg: FrontendConfig, height: int, width: int,
                      carry_uv, carry_mask):
    """``detect`` plus carried-keypoint survival (``refine_tracked``).

    Carried keypoints that pass the detector's quality gate outrank fresh
    detections in the budget. Dedupes use the Chebyshev metric of the
    detector's square NMS window and one pass of index priority: a carried
    keypoint yields to any lower-index surviving carry within
    ``nms_radius``, and a fresh detection yields to any surviving carry
    within it (the reference explains why the one pass is accepted).
    """
    n = cfg.max_keypoints
    resp = corner_response(img, cfg.score, cfg.harris_k)
    uv_f, sc_f, ok_f = _select(resp, cfg, height, width)
    uv_t, sc_t, ok_t = refine_tracked(resp, carry_uv, carry_mask,
                                      cfg.border, height, width)
    ok_t = ok_t & (sc_t > cfg.quality_level * torch.max(resp))
    r_cheb = float(cfg.nms_radius)
    i = torch.arange(uv_t.shape[0], device=resp.device)
    clash = (_chebyshev_within(uv_t, uv_t, r_cheb) & ok_t[None, :]
             & (i[None, :] < i[:, None]))
    ok_t = ok_t & ~clash.any(dim=1)
    ok_f = ok_f & ~(_chebyshev_within(uv_f, uv_t, r_cheb)
                    & ok_t[None, :]).any(dim=1)

    uv = torch.cat([uv_t, uv_f], dim=0)
    sc = torch.cat([sc_t, sc_f], dim=0)
    ok = torch.cat([ok_t, ok_f], dim=0)
    # f32, as the reference: sc_t + 1e9 rounds every carried score to one
    # value, so carried keypoints rank by index (the stable sort keeps it)
    pri = torch.cat([sc_t + 1e9, sc_f], dim=0)
    order = torch.sort(torch.where(ok, -pri, torch.inf),
                       stable=True).indices[:n]
    return uv[order], torch.where(ok, sc, 0.0)[order], ok[order]


def _topk_stable(x, k: int):
    """Largest k along the last axis, lower index first among ties."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _select(resp, cfg: FrontendConfig, height: int, width: int):
    keep = nms(resp, cfg.nms_radius)
    H, W = height, width
    dev = resp.device
    yy = torch.arange(H, device=dev)[:, None]
    xx = torch.arange(W, device=dev)[None, :]
    b = cfg.border
    in_border = (yy >= b) & (yy < H - b) & (xx >= b) & (xx < W - b)
    masked = torch.where(keep & in_border, resp, -torch.inf)

    n = cfg.max_keypoints
    gr, gc = cfg.grid_rows, cfg.grid_cols
    if gr > 0 and gc > 0 and H % gr == 0 and W % gc == 0 and n % (gr * gc) == 0:
        th, tw = H // gr, W // gc
        k_tile = n // (gr * gc)
        tiles = masked.reshape(gr, th, gc, tw).permute(0, 2, 1, 3).reshape(
            gr * gc, th * tw)
        vals, idx = _topk_stable(tiles, k_tile)          # (T, k)
        ty = idx // tw
        tx = idx % tw
        tile = torch.arange(gr * gc, device=dev)[:, None]
        ys = ((tile // gc) * th + ty).reshape(-1)
        xs = ((tile % gc) * tw + tx).reshape(-1)
        scores = vals.reshape(-1)
    else:
        scores, idx = _topk_stable(masked.reshape(-1), n)
        ys = idx // W
        xs = idx % W

    max_resp = torch.max(resp)
    valid = (scores > cfg.quality_level * max_resp) & torch.isfinite(scores)
    dy, dx = _subpixel_offsets(resp, ys, xs)
    uv = torch.stack([xs.float() + dx, ys.float() + dy], dim=1)
    # global re-sort by score; padded/invalid entries sink to the end
    order = torch.argsort(torch.where(valid, -scores, torch.inf),
                          stable=True)[:n]
    return uv[order], torch.where(valid, scores, 0.0)[order], valid[order]
