"""Build and load the port's CUDA kernels on first use.

``csrc/*.cu`` compile with nvcc, one process per source started together,
and link into one shared library with a plain C interface (no PyTorch
headers, so a build takes seconds), named by the hash of the sources and
flags under ``build/kernels/`` at the repo root, which ``.gitignore``
lists. The wrappers (``ops/hamming.py``, ``ops/associate.py``) call the C
entries through ``ctypes`` on PyTorch's current stream; each entry returns
``cudaGetLastError()``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class Kernels:
    lib: ctypes.CDLL
    path: Path
    log: str            # nvcc/ptxas output of the build ("" when cached)
    seconds: float      # build time (0 when the library was already built)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build on a host "
                       "with the CUDA toolkit")


@functools.lru_cache(maxsize=1)
def load() -> Kernels:
    """Compile (if needed) and load the kernel library."""
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256()
    for p in sources:
        h.update(p.name.encode() + p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    so = BUILD_DIR / f"libvslam_kernels_{h.hexdigest()[:16]}.so"
    log, seconds = "", 0.0
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        objs = [so.with_name(f"{p.stem}.{os.getpid()}.o") for p in sources]
        t0 = time.perf_counter()
        try:
            procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o",
                                       str(o), str(p)],
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                     for p, o in zip(sources, objs)]
            outs = [(p.communicate()[0], p.returncode) for p in procs]
            log = "".join(text for text, _ in outs)
            if any(rc for _, rc in outs):
                raise RuntimeError(f"nvcc failed:\n{log}")
            r = subprocess.run([_nvcc(), *NVCC_FLAGS[:2], "-shared", "-o",
                                str(tmp), *map(str, objs)],
                               capture_output=True, text=True)
            log += r.stdout + r.stderr
            if r.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({r.returncode}):\n"
                                   f"{log}")
        finally:
            for o in objs:
                o.unlink(missing_ok=True)
        seconds = time.perf_counter() - t0
        os.replace(tmp, so)     # atomic: a concurrent build never sees half
    return Kernels(lib=ctypes.CDLL(str(so)), path=so, log=log,
                   seconds=seconds)


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a nonzero cudaError_t."""
    if err != 0:
        name = load().lib.vslam_cuda_error_string(err)
        raise RuntimeError(f"{what}: CUDA error {err} ({name.decode()})")


def declare(name: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry ``name`` with its argument types (pointers and the
    stream as c_void_p, so ctypes never truncates them to 32 bits)."""
    lib = load().lib
    lib.vslam_cuda_error_string.argtypes = [ctypes.c_int]
    lib.vslam_cuda_error_string.restype = ctypes.c_char_p
    fn = getattr(lib, name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn
