"""ctypes bindings of the native host runtime (port of
gpis_tpu/native/bindings.py).

The library is built at first use (`native.build.ensure_built`).  Unlike the
JAX package's bindings, nothing here degrades quietly: `available()`
reports whether the library could be built and loaded, and every entry
point raises RuntimeError, with the build's error, when it could not.  The
callers that take the library by default (`surface.marching`,
`data.voxel`, `data.io`'s binary PLY reader) say so in their signatures.
"""

from __future__ import annotations

import ctypes

import numpy as np

from gpis_tpu_torch.native import build

__all__ = ["available", "require", "voxel_downsample", "marching_tets", "ply_extract"]

_LIB = None
_ERROR: str | None = None


def _load():
    """The loaded library, or None with `_ERROR` set; tried once a process."""
    global _LIB, _ERROR
    if _LIB is not None or _ERROR is not None:
        return _LIB
    try:
        lib = ctypes.CDLL(build.ensure_built())
    except (RuntimeError, OSError) as e:
        _ERROR = str(e)
        return None
    c_d = ctypes.POINTER(ctypes.c_double)
    lib.gom_voxel_downsample.restype = ctypes.c_int64
    lib.gom_voxel_downsample.argtypes = [c_d, ctypes.c_int64, ctypes.c_double, c_d]
    lib.gom_marching_tets.restype = ctypes.c_int64
    lib.gom_marching_tets.argtypes = [
        c_d, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        c_d, c_d, c_d, ctypes.c_double, ctypes.POINTER(c_d),
    ]
    lib.gom_free.restype = None
    lib.gom_free.argtypes = [ctypes.c_void_p]
    c_i32 = ctypes.POINTER(ctypes.c_int32)
    lib.gom_ply_extract.restype = ctypes.c_int64
    lib.gom_ply_extract.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, c_i32, c_i32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, c_d, c_d,
    ]
    _LIB = lib
    return _LIB


def available() -> bool:
    """True when the library is built (or could be) and loaded."""
    return _load() is not None


def require():
    """The loaded library; RuntimeError with the build's error otherwise."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the native host library is unavailable: {_ERROR}")
    return lib


def _as_c(arr):
    return np.ascontiguousarray(arr, dtype=np.float64)


def _ptr(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def voxel_downsample(points: np.ndarray, leaf: float) -> np.ndarray:
    """Centroid voxel-grid filter, voxels in first-seen order."""
    lib = require()
    pts = _as_c(points)
    out = np.empty((len(pts), 3), np.float64)
    m = lib.gom_voxel_downsample(_ptr(pts), len(pts), leaf, _ptr(out))
    return out[:m].copy()


def marching_tets(field: np.ndarray, axis_x, axis_y=None, axis_z=None, iso: float = 0.0):
    """Native marching tetrahedra; the triangle soup of
    surface.marching.marching_tetrahedra, in (cell, tetrahedron, triangle)
    order."""
    lib = require()
    f = _as_c(field)
    rx, ry, rz = f.shape
    ax = _as_c(axis_x)
    ay = ax if axis_y is None else _as_c(axis_y)
    az = ax if axis_z is None else _as_c(axis_z)
    out_ptr = ctypes.POINTER(ctypes.c_double)()
    ntri = lib.gom_marching_tets(_ptr(f), rx, ry, rz, _ptr(ax), _ptr(ay), _ptr(az), iso,
                                 ctypes.byref(out_ptr))
    if ntri == 0:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    buf = np.ctypeslib.as_array(out_ptr, shape=(ntri * 3, 3)).copy()
    lib.gom_free(out_ptr)
    return buf, np.arange(ntri * 3, dtype=np.int64).reshape(-1, 3)


_PLY_KINDS = {"float": 0, "float32": 0, "double": 1, "float64": 1,
              "uchar": 2, "uint8": 2, "char": 2, "int8": 2,
              "short": 3, "ushort": 3, "int16": 3, "uint16": 3,
              "int": 4, "int32": 4, "uint": 4, "uint32": 4}
_PLY_SIZES = {0: 4, 1: 8, 2: 1, 3: 2, 4: 4}


def ply_extract(buf: bytes, n_vertex: int, prop_types, idx):
    """xyz (and normals, where nx, ny, nz are properties) of a binary
    little-endian PLY vertex buffer; prop_types: the PLY type of each
    property; idx: property name -> index."""
    lib = require()
    kinds = np.asarray([_PLY_KINDS[t] for t in prop_types], np.int32)
    sizes = np.asarray([_PLY_SIZES[k] for k in kinds], np.int32)
    arr = np.frombuffer(buf, np.uint8)
    pts = np.empty((n_vertex, 3), np.float64)
    has_n = all(k in idx for k in ("nx", "ny", "nz"))
    nrm = np.empty((n_vertex, 3), np.float64) if has_n else None
    c_i32 = ctypes.POINTER(ctypes.c_int32)
    lib.gom_ply_extract(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n_vertex,
        sizes.ctypes.data_as(c_i32), kinds.ctypes.data_as(c_i32),
        len(prop_types), idx["x"], idx["y"], idx["z"],
        idx.get("nx", -1), idx.get("ny", -1), idx.get("nz", -1),
        _ptr(pts), _ptr(nrm) if has_n else ctypes.cast(None, ctypes.POINTER(ctypes.c_double)))
    return pts, nrm
