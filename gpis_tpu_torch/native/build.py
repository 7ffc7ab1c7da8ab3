"""Build the native host runtime: `python -m gpis_tpu_torch.native.build`.

One g++ call, no pybind11 (the ABI is plain C, consumed through ctypes):

    g++ -O3 -fPIC -std=c++17 -Wall -shared -o <lib> native/src/gomcpp.cpp

into gpis_tpu_torch/_build/native-<hash>/libgomcpp.so, the directory keyed
by a hash of the source and the flags.  Concurrent builds (test workers,
ranks) serialize on an `fcntl` lock beside the library, and each writes a
temporary file that `os.replace` moves into place, so a loader never sees
half a file.  `ensure_built()` returns the library's path or raises with
the compiler's output: nothing here falls back.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess
import sys

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src", "gomcpp.cpp")
BUILD_ROOT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-shared"]


def lib_path() -> str:
    """Where the library for this source and these flags lives."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    with open(SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_ROOT, f"native-{h.hexdigest()[:16]}", "libgomcpp.so")


def ensure_built(force: bool = False) -> str:
    """Compile the library if it is not there (or `force`); returns its
    path.  Raises RuntimeError when g++ is missing or fails."""
    out = lib_path()
    if os.path.exists(out) and not force:
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(out) and not force:  # another process built it meanwhile
            return out
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = ["g++", *FLAGS, "-o", tmp, SRC]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except FileNotFoundError as e:
            raise RuntimeError(f"native build needs g++: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"native build failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{proc.stderr}")
        os.replace(tmp, out)
    return out


if __name__ == "__main__":
    print(f"built {ensure_built(force='--force' in sys.argv)}")
