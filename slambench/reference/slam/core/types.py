"""State containers: dataclasses of tensors.

Port of ``vslam_tpu/core/types.py`` with the same field names and the same
packed map layout: one ``(C, PT_COLS)`` f32 payload in the ``PT_*`` column
layout and a flat point-major ``(C*K, 8)`` descriptor archive (row
``p*K + k`` is slot k of point p). Descriptors are int32 bit-views of the
reference's uint32 words.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

# Column layout of MapState.pt (identical to vslam_tpu.core.types)
PT_XYZ = slice(0, 3)         # world position
PT_CONF = 3                  # maturity confidence (ray-span parallax, rad)
PT_COLOR = slice(4, 7)       # RGB in [0, 1]
PT_FIRST_UV = slice(7, 9)    # founding-observation pixel
PT_FIRST_C = slice(9, 12)    # founding camera center (world)
PT_FIRST_P = slice(12, 24)   # founding projection matrix, row-major (3, 4)
PT_COLS = 24


class Replace:
    """``state.replace(field=...)``, as flax struct dataclasses have."""

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class FrameFeatures(Replace):
    """Per-frame detection output (fixed capacity N)."""
    uv: torch.Tensor          # (N, 2) f32 pixel coords
    desc: torch.Tensor        # (N, 8) i32 bit-view of the packed descriptor
    score: torch.Tensor       # (N,) f32 detector response
    mask: torch.Tensor        # (N,) bool — valid keypoint
    angle: torch.Tensor       # (N,) f32 orientation (radians)

    @property
    def capacity(self) -> int:
        return self.uv.shape[-2]


@dataclasses.dataclass
class TwoViewResult(Replace):
    """Output of the two-view tracker (match → RANSAC → E → R,t)."""
    matches: torch.Tensor     # (M, 2) i32 indices (in frame1, in frame2)
    match_mask: torch.Tensor  # (M,) bool — survived ratio test + RANSAC
    F: torch.Tensor           # (3, 3) fundamental matrix
    E: torch.Tensor           # (3, 3) essential matrix
    R: torch.Tensor           # (3, 3) relative rotation (cam1 -> cam2)
    t: torch.Tensor           # (3,) unit-norm relative translation
    num_inliers: torch.Tensor  # () i32
    success: torch.Tensor     # () bool


@dataclasses.dataclass
class MapState(Replace):
    """Persistent world map (see vslam_tpu.core.types.MapState)."""
    pt: torch.Tensor          # (C, PT_COLS) f32 packed payload
    desc: torch.Tensor        # (C * K, 8) i32 observation descriptor archive
    desc_count: torch.Tensor  # (C,) i32 observations recorded (may exceed K)
    alive: torch.Tensor       # (C,) bool
    last_seen: torch.Tensor   # (C,) i32 frame index of latest observation
    prov: torch.Tensor        # (C,) bool — provisional landmark
    size: torch.Tensor        # () i32 insert cursor

    @property
    def capacity(self) -> int:
        return self.pt.shape[-2]

    @property
    def obs_slots(self) -> int:
        return self.desc.shape[-2] // self.pt.shape[-2]

    # packed-column views (writers scatter packed rows into pt)
    @property
    def xyz(self) -> torch.Tensor:
        return self.pt[..., PT_XYZ]

    @property
    def color(self) -> torch.Tensor:
        return self.pt[..., PT_COLOR]

    @property
    def conf(self) -> torch.Tensor:
        return self.pt[..., PT_CONF]

    @property
    def first_uv(self) -> torch.Tensor:
        return self.pt[..., PT_FIRST_UV]

    @property
    def first_C(self) -> torch.Tensor:
        return self.pt[..., PT_FIRST_C]

    @property
    def first_P(self) -> torch.Tensor:
        return self.pt[..., PT_FIRST_P].reshape(self.pt.shape[:-1] + (3, 4))


def pack_pt_rows(xyz, conf, color, first_uv, first_C, first_P):
    """Assemble (B, PT_COLS) packed payload rows from per-field arrays.
    first_P may be (B, 3, 4) or (B, 12)."""
    B = xyz.shape[0]
    return torch.cat([xyz, conf.reshape(B, 1), color, first_uv, first_C,
                      first_P.reshape(B, 12)], dim=1)


def empty_map(capacity: int, obs_slots: int, device) -> MapState:
    z = dict(device=device)
    return MapState(
        pt=torch.zeros((capacity, PT_COLS), dtype=torch.float32, **z),
        desc=torch.zeros((capacity * obs_slots, 8), dtype=torch.int32, **z),
        desc_count=torch.zeros((capacity,), dtype=torch.int32, **z),
        alive=torch.zeros((capacity,), dtype=torch.bool, **z),
        last_seen=torch.zeros((capacity,), dtype=torch.int32, **z),
        prov=torch.zeros((capacity,), dtype=torch.bool, **z),
        size=torch.zeros((), dtype=torch.int32, **z),
    )


def empty_features(capacity: int, device) -> FrameFeatures:
    z = dict(device=device)
    return FrameFeatures(
        uv=torch.zeros((capacity, 2), dtype=torch.float32, **z),
        desc=torch.zeros((capacity, 8), dtype=torch.int32, **z),
        score=torch.zeros((capacity,), dtype=torch.float32, **z),
        mask=torch.zeros((capacity,), dtype=torch.bool, **z),
        angle=torch.zeros((capacity,), dtype=torch.float32, **z),
    )


@functools.lru_cache(maxsize=None)
def device_constant(values, dtype, device):
    """A constant tensor built from nested tuples, uploaded once per device
    (a fresh host-to-device copy would synchronize the stream every step).
    Callers must not modify it in place."""
    return torch.tensor(values, dtype=dtype, device=device)


def pick(x, i):
    """``x[i]`` for a 0-d index tensor, as a gather: indexing with the
    tensor itself would read the index on the host (a sync on CUDA)."""
    return x.index_select(0, i.reshape(1))[0]


def scatter_drop(base, idx, values, accumulate: bool = False):
    """``base.at[idx].set(values, mode="drop")`` without a host sync.

    Indices equal to ``base.shape[0]`` are dropped: the write goes to a
    dump row that is sliced off again, rather than through a boolean filter
    (which would sync on CUDA). Returns a new tensor; ``base`` is untouched.
    """
    # a cat, not a slice assignment: copying base into a slice of an empty
    # buffer would be a device-to-device memcpy (a copy node in a graph);
    # the dump row is left unset (its value is never read)
    buf = torch.cat([base, base.new_empty((1,) + tuple(base.shape[1:]))])
    buf.index_put_((idx,), values.to(base.dtype).expand(
        (idx.shape[0],) + tuple(base.shape[1:])), accumulate=accumulate)
    return buf[:-1]


def last_writes(idx, dump: int):
    """``idx`` with every write but the last to each target sent to
    ``dump``. Of colliding writes, ``index_put_`` keeps an unspecified one
    on CUDA (and on the CPU once it runs in parallel); the reference's
    scatter keeps the last, and so does ``scatter_drop`` of the result."""
    order = torch.sort(idx, stable=True).indices
    s = idx[order]
    last = torch.cat([s[1:] != s[:-1],
                      torch.ones((1,), dtype=torch.bool, device=s.device)])
    keep = torch.empty_like(last).scatter_(0, order, last)
    return torch.where(keep, idx, dump)
