"""ctypes bindings for the native C++ runtime (native/).

Components (pybind11 is not available in this image; plain C ABI instead):

  * SpatialIndex — k-d tree + uniform grid over 2D points; host-side parity
    with the reference's KDTree (reference src/KDTree.cpp) including the
    k-nearest query it declared but never implemented (KDTree.h:74-77).
  * ImagePrefetcher — multi-threaded native PNG/PGM decode ring; overlaps
    host IO/decode with device compute.

The shared library is built lazily with ``make`` on first use; everything
degrades gracefully (raises NativeUnavailable) if no toolchain exists.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libvslam_native.so")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class NativeUnavailable(RuntimeError):
    pass


def _build():
    subprocess.run(
        ["make", "-C", _NATIVE_DIR, "-j4"],
        check=True, capture_output=True, text=True,
    )


def load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_LIB_PATH):
            try:
                _build()
            except Exception as e:  # no toolchain / build failure
                raise NativeUnavailable(f"native build failed: {e}") from e
        lib = ctypes.CDLL(_LIB_PATH)
        # signatures
        lib.kdtree_build.restype = ctypes.c_void_p
        lib.kdtree_build.argtypes = [ctypes.POINTER(ctypes.c_float),
                                     ctypes.c_int32]
        lib.kdtree_free.argtypes = [ctypes.c_void_p]
        lib.kdtree_nearest.restype = ctypes.c_int32
        lib.kdtree_nearest.argtypes = [ctypes.c_void_p, ctypes.c_float,
                                       ctypes.c_float,
                                       ctypes.POINTER(ctypes.c_float)]
        lib.kdtree_radius.restype = ctypes.c_int32
        lib.kdtree_radius.argtypes = [ctypes.c_void_p, ctypes.c_float,
                                      ctypes.c_float, ctypes.c_float,
                                      ctypes.POINTER(ctypes.c_int32),
                                      ctypes.c_int32]
        lib.kdtree_knearest.restype = ctypes.c_int32
        lib.kdtree_knearest.argtypes = [ctypes.c_void_p, ctypes.c_float,
                                        ctypes.c_float, ctypes.c_int32,
                                        ctypes.POINTER(ctypes.c_int32),
                                        ctypes.POINTER(ctypes.c_float)]
        lib.grid_build.restype = ctypes.c_void_p
        lib.grid_build.argtypes = [ctypes.POINTER(ctypes.c_float),
                                   ctypes.c_int32, ctypes.c_float]
        lib.grid_free.argtypes = [ctypes.c_void_p]
        lib.grid_radius.restype = ctypes.c_int32
        lib.grid_radius.argtypes = [ctypes.c_void_p, ctypes.c_float,
                                    ctypes.c_float, ctypes.c_float,
                                    ctypes.POINTER(ctypes.c_int32),
                                    ctypes.c_int32]
        lib.prefetcher_create.restype = ctypes.c_void_p
        lib.prefetcher_create.argtypes = [ctypes.c_char_p, ctypes.c_int32,
                                          ctypes.c_int32, ctypes.c_int32,
                                          ctypes.c_int32]
        lib.prefetcher_count.restype = ctypes.c_int64
        lib.prefetcher_count.argtypes = [ctypes.c_void_p]
        lib.prefetcher_get.restype = ctypes.c_int32
        lib.prefetcher_get.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                       ctypes.POINTER(ctypes.c_float)]
        lib.prefetcher_destroy.argtypes = [ctypes.c_void_p]
        lib.png_decode_gray_f32.restype = ctypes.c_int32
        lib.png_decode_gray_f32.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int32]
        _lib = lib
        return lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


class SpatialIndex:
    """Exact 2D queries over a fixed point set (k-d tree backend)."""

    def __init__(self, points: np.ndarray, backend: str = "kdtree",
                 cell_size: float = 16.0):
        self._lib = load()
        self._pts = np.ascontiguousarray(points, np.float32)
        assert self._pts.ndim == 2 and self._pts.shape[1] == 2
        self._backend = backend
        if backend == "kdtree":
            self._h = self._lib.kdtree_build(_fptr(self._pts),
                                             len(self._pts))
        elif backend == "grid":
            self._h = self._lib.grid_build(_fptr(self._pts), len(self._pts),
                                           ctypes.c_float(cell_size))
        else:
            raise ValueError(backend)

    def nearest(self, q) -> tuple[int, float]:
        assert self._backend == "kdtree"
        d2 = ctypes.c_float()
        idx = self._lib.kdtree_nearest(self._h, float(q[0]), float(q[1]),
                                       ctypes.byref(d2))
        return int(idx), float(d2.value)

    def k_nearest(self, q, k: int):
        assert self._backend == "kdtree"
        idx = np.full(k, -1, np.int32)
        d2 = np.zeros(k, np.float32)
        n = self._lib.kdtree_knearest(self._h, float(q[0]), float(q[1]), k,
                                      _iptr(idx), _fptr(d2))
        return idx[:n], d2[:n]

    def radius(self, q, r: float, cap: int = 256) -> np.ndarray:
        out = np.zeros(cap, np.int32)
        fn = (self._lib.kdtree_radius if self._backend == "kdtree"
              else self._lib.grid_radius)
        n = fn(self._h, float(q[0]), float(q[1]), float(r), _iptr(out), cap)
        return out[: min(n, cap)]

    def __del__(self):
        lib = getattr(self, "_lib", None)
        h = getattr(self, "_h", None)
        if lib is not None and h:
            (lib.kdtree_free if self._backend == "kdtree"
             else lib.grid_free)(h)


class ImagePrefetcher:
    """Native threaded frame loader: yields (idx, (H,W) float32 in [0,1])."""

    def __init__(self, paths, width: int, height: int, workers: int = 2,
                 lookahead: int = 8):
        self._lib = load()
        joined = "\n".join(paths).encode()
        self.width, self.height = width, height
        self._n = len(paths)
        self._h = self._lib.prefetcher_create(joined, width, height,
                                              workers, lookahead)

    def __len__(self):
        return self._n

    def get(self, idx: int) -> np.ndarray:
        out = np.empty((self.height, self.width), np.float32)
        rc = self._lib.prefetcher_get(self._h, idx, _fptr(out))
        if rc != 0:
            raise IOError(f"prefetcher_get({idx}) -> {rc}")
        return out

    def __iter__(self):
        for i in range(self._n):
            yield i, self.get(i)

    def close(self):
        if getattr(self, "_h", None):
            self._lib.prefetcher_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def decode_png_gray(data: bytes, width: int, height: int) -> np.ndarray:
    lib = load()
    out = np.empty((height, width), np.float32)
    buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    rc = lib.png_decode_gray_f32(buf, len(data), _fptr(out), width * height)
    if rc != 0:
        raise ValueError(f"png decode failed: {rc}")
    return out
