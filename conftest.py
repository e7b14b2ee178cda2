"""Build the native library (``native/``) once, before any test runs.

``vslam_tpu.utils.native.load()`` builds ``native/libvslam_native.so``
with ``make`` on first use, under a lock that holds only within one
process. Under pytest-xdist every worker imports ``tests/test_native.py``,
which calls ``load()``, so several ``make`` runs could write the library at
once, and a worker could load a file another worker's linker was still
writing ("file too short"), which skips the module. Here the controller
(or a run without workers) builds the library before the workers start,
under an exclusive ``flock`` on ``native/.build.lock``, so concurrent
pytest runs build it one at a time too. The workers then find it built.

A failed build is reported and the run goes on: the native tests then
skip as they would without a toolchain. This file selects, skips and marks
no test.
"""
import fcntl
import os
import subprocess

NATIVE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native")


def pytest_configure(config):
    if hasattr(config, "workerinput"):      # an xdist worker
        return
    with open(os.path.join(NATIVE, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            r = subprocess.run(["make", "-C", NATIVE, "-j4"],
                               capture_output=True, text=True, timeout=600)
        except (OSError, subprocess.TimeoutExpired) as e:
            print(f"conftest: native build not run: {e}")
            return
        if r.returncode != 0:
            print(f"conftest: native build failed ({r.returncode}): "
                  f"{r.stderr.strip()[-2000:]}")
