"""Imported by the port's tests that hold `extract_surface`'s soup to the
JAX package's, vertex for vertex and in order: `require()` makes sure the
JAX package's native library is built and loaded in this process first.

Why: the JAX package takes its C++ marching path only when
`gpis_tpu.native.bindings.available()`, and its NumPy fallback emits the
same triangles in another order.  Its library is not tracked; on a fresh
checkout the first process to load it builds it in place with g++
(`gpis_tpu/native/build.py`), writing straight to the final path.  A
concurrent test worker that loads the half-written file gets OSError, and
the bindings cache that failure for the rest of the process, whose JAX
sessions then fall back to NumPy.  So here the library is built under an
`fcntl` lock into a temporary file that `os.replace` moves into place, and
a cached failure is tried again.  If the library still cannot be had, the
test fails: it neither skips nor compares against the fallback's order.
"""

import fcntl
import os
import subprocess

from gpis_tpu.native import bindings as nb
from gpis_tpu.native import build as nbuild


def _loadable(path) -> bool:
    import ctypes

    try:
        ctypes.CDLL(str(path))
        return True
    except OSError:
        return False


# The lock lives in the port's git-ignored build directory, not in the JAX
# package.
LOCK = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "gpis_tpu_torch", "_build", "jax_native.lock")


def _build_in_place() -> None:
    out, src = nbuild._OUT, nbuild._SRC
    os.makedirs(os.path.dirname(LOCK), exist_ok=True)
    with open(LOCK, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists() and out.stat().st_mtime >= src.stat().st_mtime and _loadable(out):
            return
        tmp = f"{out}.{os.getpid()}.tmp"
        subprocess.run(["g++", "-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
                        "-shared", "-o", tmp, str(src)], check=True, capture_output=True)
        os.replace(tmp, out)


def require() -> None:
    """Build (if need be) and load the JAX package's native library in this
    process; AssertionError if it cannot be had."""
    if nb._LIB is not None:
        return
    _build_in_place()
    nb._TRIED = False  # a failure cached by an earlier, racing load is tried again
    assert nb.available(), "the JAX package's native library could not be built and loaded"
