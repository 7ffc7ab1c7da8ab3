"""The port's C++ host runtime (`gpis_tpu_torch/native/`) against the
port's NumPy paths, after tests/test_native.py: marching tetrahedra equal
element for element and in the same order (cell, tetrahedron, triangle) on
isotropic, anisotropic, empty and sign-flipped fields; the voxel filter's
voxels and centroids (in first-seen order against NumPy's sorted order);
the PLY extract against `struct`.  Then the build: concurrent builds
serialize on the lock and leave one whole library, and a missing library
raises instead of falling back.  Exact, but 1e-12 on interpolated vertices
(g++ and NumPy may round a product differently)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch_exp_warm  # noqa: F401 -- warms torch.exp before any test (see the module)

from gpis_tpu.native import bindings as jnb
from gpis_tpu_torch.data import io, voxel
from gpis_tpu_torch.native import bindings as nb
from gpis_tpu_torch.native import build
from gpis_tpu_torch.surface import marching

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """One intra-op thread for the module: these sizes gain nothing from
    more, and the suite's workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ellipsoid(r=24):
    ax = np.linspace(-1.4, 1.4, r)
    gx, gy, gz = np.meshgrid(ax, ax, ax, indexing="ij")
    return np.sqrt(gx**2 + 0.8 * gy**2 + 1.3 * gz**2) - 1.0, ax


@pytest.mark.parametrize("case", ["ellipsoid", "flipped", "iso", "anisotropic", "empty"])
def test_marching_native_matches_numpy_in_order(case):
    field, ax = _ellipsoid()
    axes = (ax,)
    iso = 0.0
    if case == "flipped":
        field = -field
    elif case == "iso":
        iso = 0.3
    elif case == "anisotropic":
        ax, ay, az = np.linspace(-2, 2, 20), np.linspace(-1, 1, 12), np.linspace(-1.5, 1.5, 16)
        gx, gy, gz = np.meshgrid(ax, ay, az, indexing="ij")
        field = np.sqrt((gx / 1.5) ** 2 + gy**2 + gz**2) - 0.8
        axes = (ax, ay, az)
    elif case == "empty":
        field = np.ones((8, 8, 8))
        axes = (np.linspace(0, 1, 8),)
    v, f = marching.marching_tetrahedra(field, *axes, iso=iso)
    v_np, f_np = marching.marching_tetrahedra(field, *axes, iso=iso, native=False)
    assert v.shape == v_np.shape and (len(v) > 100) == (case != "empty")
    np.testing.assert_array_equal(f, f_np)
    np.testing.assert_allclose(v, v_np, rtol=0, atol=1e-12)
    # The JAX package's library (built with -march=native, so its products
    # may fuse into FMAs): the same soup.
    if jnb.available():
        jv, jf = jnb.marching_tets(field, *axes, iso=iso)
        np.testing.assert_array_equal(jf, f)
        np.testing.assert_allclose(jv, v, rtol=0, atol=1e-12)


@pytest.mark.parametrize("leaf", [0.0, 0.05, 0.25, 1.0])
def test_voxel_native_matches_numpy(leaf):
    pts = np.random.default_rng(3).normal(size=(3000, 3))
    got = voxel.voxel_downsample(pts, leaf)
    want = voxel._voxel_downsample_numpy(pts, leaf)
    assert got.shape == want.shape
    # NumPy sorts the voxels by key, the library keeps them in first-seen order.
    np.testing.assert_allclose(got[np.lexsort(np.floor(got / leaf).T[::-1])] if leaf else got,
                               want, rtol=0, atol=1e-12)
    if leaf:
        keys = np.floor(pts / leaf)
        _, first = np.unique(keys, axis=0, return_index=True)
        np.testing.assert_array_equal(np.floor(got / leaf), keys[np.sort(first)])


@pytest.mark.parametrize("normals", [False, True])
def test_ply_extract_matches_struct(tmp_path, normals):
    rng = np.random.default_rng(4)
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    nrm = rng.normal(size=(300, 3)).astype(np.float32) if normals else None
    p = str(tmp_path / "b.ply")
    io.save_ply(p, pts, normals=nrm, colors=rng.uniform(size=(300, 3)), binary=True)
    got, want = io.load_ply(p), io.load_ply(p, native=False)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[0], pts.astype(np.float64))
    if normals:
        np.testing.assert_array_equal(got[1], want[1])
    else:
        assert got[1] is None and want[1] is None


def test_concurrent_builds_leave_one_whole_library(tmp_path):
    code = ("import sys; from gpis_tpu_torch.native import build; "
            "build.BUILD_ROOT = sys.argv[1]; print(build.ensure_built())")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env={**os.environ, "PYTHONPATH": REPO}) for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    paths = {o.strip() for o, _ in outs}
    assert len(paths) == 1
    (lib,) = paths
    assert lib.startswith(str(tmp_path)) and os.path.basename(lib) == "libgomcpp.so"
    left = sorted(os.listdir(os.path.dirname(lib)))
    assert left == ["libgomcpp.so", "libgomcpp.so.lock"], left  # no temporary file left
    import ctypes

    assert ctypes.CDLL(lib).gom_marching_tets


def test_missing_library_raises(monkeypatch):
    def no_compiler(force=False):
        raise RuntimeError("native build needs g++: not found")

    monkeypatch.setattr(build, "ensure_built", no_compiler)
    monkeypatch.setattr(nb, "_LIB", None)
    monkeypatch.setattr(nb, "_ERROR", None)
    assert not nb.available()
    field, ax = _ellipsoid(10)
    for call in (lambda: marching.marching_tetrahedra(field, ax),
                 lambda: voxel.voxel_downsample(np.zeros((3, 3)), 0.1),
                 lambda: nb.ply_extract(b"", 0, ["float"] * 3, {"x": 0, "y": 1, "z": 2})):
        with pytest.raises(RuntimeError, match="native host library is unavailable.*g\\+\\+"):
            call()
    assert len(marching.marching_tetrahedra(field, ax, native=False)[0]) > 0


def test_jax_native_helper_recovers_a_cached_failure(monkeypatch):
    """tests/torch_jax_native.require(): a load failure that the JAX
    bindings cached (a worker that read the library half-written) is tried
    again, so the JAX sessions compared with the port take the native
    marching order."""
    import torch_jax_native

    monkeypatch.setattr(jnb, "_TRIED", True)
    monkeypatch.setattr(jnb, "_LIB", None)
    assert not jnb.available()
    torch_jax_native.require()
    assert jnb.available()
    field, ax = _ellipsoid(12)
    from gpis_tpu.surface import marching as jmarching

    np.testing.assert_allclose(jmarching.marching_tetrahedra(field, ax)[0],
                               marching.marching_tetrahedra(field, ax)[0], rtol=0, atol=1e-12)
