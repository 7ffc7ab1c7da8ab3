"""The port's host utilities against the JAX package's, on the CPU:
`data/io.py` (ASCII and binary PLY, ASCII, binary and padded binary PCD,
NPZ, XYZ; after tests/test_data.py), `data/synthetic.py`, `viz/export.py`,
`utils/profiling.py` (after tests/test_utils.py) and
`utils/provenance.py`.  Loaders are exact (the same bytes in, the same
float64 out); the exports are compared as text."""

import json
import os
import subprocess

import numpy as np
import pytest
import torch
import torch_exp_warm  # noqa: F401 -- warms torch.exp before any test (see the module)

from gpis_tpu.data import io as jio
from gpis_tpu.data import synthetic as jsyn
from gpis_tpu.utils import profiling as jprof
from gpis_tpu.utils import provenance as jprov
from gpis_tpu.viz import export as jexport
from gpis_tpu_torch.data import io
from gpis_tpu_torch.data import synthetic as syn
from gpis_tpu_torch.utils import profiling, provenance
from gpis_tpu_torch.viz import export


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """One intra-op thread for the module: these sizes gain nothing from
    more, and the suite's workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(got, want):
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            assert g.dtype == w.dtype == np.float64
            np.testing.assert_array_equal(g, w)


def _write_pcd_ascii(path, pts, normals=None):
    fields = "x y z" + (" normal_x normal_y normal_z" if normals is not None else "")
    nf = 3 + (3 if normals is not None else 0)
    with open(path, "w") as f:
        f.write("# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n")
        f.write(f"FIELDS {fields}\n")
        f.write("SIZE " + " ".join(["4"] * nf) + "\n")
        f.write("TYPE " + " ".join(["F"] * nf) + "\n")
        f.write("COUNT " + " ".join(["1"] * nf) + "\n")
        f.write(f"WIDTH {len(pts)}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n")
        f.write(f"POINTS {len(pts)}\nDATA ascii\n")
        for i in range(len(pts)):
            row = list(pts[i]) + (list(normals[i]) if normals is not None else [])
            f.write(" ".join(f"{v:.6f}" for v in row) + "\n")


def _write_ply_binary(path, props, rows):
    """A binary little-endian PLY of `rows` with (type, name) `props`."""
    codes = {"float": "<f4", "double": "<f8", "uchar": "u1", "short": "<i2", "int": "<i4"}
    rec = np.empty(len(rows), dtype=[(name, codes[t]) for t, name in props])
    for k, (_, name) in enumerate(props):
        rec[name] = rows[:, k]
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\ncomment made by a test\n")
        f.write(f"element vertex {len(rows)}\n".encode())
        for t, name in props:
            f.write(f"property {t} {name}\n".encode())
        f.write(b"element face 0\nproperty list uchar int vertex_indices\nend_header\n")
        f.write(rec.tobytes())


@pytest.mark.parametrize("kind", ["ply_ascii", "ply_ascii_normals", "ply_binary_float",
                                  "ply_binary_mixed", "pcd_ascii", "pcd_binary",
                                  "pcd_binary_padded", "npz", "npz_normals", "xyz",
                                  "xyz_normals"])
def test_load_cloud_matches_jax(tmp_path, kind):
    rng = np.random.default_rng(5)
    pts, nrm = rng.normal(size=(40, 3)), rng.normal(size=(40, 3))
    p = str(tmp_path / ("c." + kind.split("_")[0]))
    if kind.startswith("ply_ascii"):
        jio.save_ply(p, pts, normals=nrm if kind.endswith("normals") else None)
    elif kind == "ply_binary_float":
        _write_ply_binary(p, [("float", n) for n in ("x", "y", "z", "nx", "ny", "nz")],
                          np.concatenate([pts, nrm], axis=1))
    elif kind == "ply_binary_mixed":  # doubles, colors and an int between
        props = [("double", "x"), ("uchar", "red"), ("double", "y"), ("int", "id"),
                 ("double", "z"), ("short", "s")]
        rows = np.concatenate([pts[:, :1], rng.integers(0, 255, (40, 1)), pts[:, 1:2],
                               rng.integers(-9, 9, (40, 1)), pts[:, 2:], np.ones((40, 1))], 1)
        _write_ply_binary(p, props, rows)
    elif kind == "pcd_ascii":
        _write_pcd_ascii(p, pts, nrm)
    elif kind.startswith("pcd_binary"):
        f4 = pts.astype("<f4")
        fields, cols = (b"x y z _", 4) if kind.endswith("padded") else (b"x y z", 3)
        rows = np.concatenate([f4, np.zeros((40, 1), "<f4")], 1) if cols == 4 else f4
        with open(p, "wb") as f:
            f.write(b"VERSION 0.7\nFIELDS " + fields + b"\nSIZE" + b" 4" * cols + b"\nTYPE"
                    + b" F" * cols + b"\nCOUNT" + b" 1" * cols
                    + b"\nWIDTH 40\nHEIGHT 1\nPOINTS 40\nDATA binary\n")
            f.write(rows.tobytes())
    elif kind.startswith("npz"):
        np.savez(p, points=pts, **({"normals": nrm} if kind.endswith("normals") else {}))
    else:
        np.savetxt(p, np.concatenate([pts, nrm], 1) if kind.endswith("normals") else pts)
    got, want = io.load_cloud(p), jio.load_cloud(p)
    _same(got, want)
    if kind.startswith("ply_binary"):  # the native extractor and the struct path agree
        _same(io.load_ply(p, native=False), got)


@pytest.mark.parametrize("normals, colors", [(False, False), (True, True)])
def test_save_ply_ascii_matches_jax_and_binary_reads_back(tmp_path, normals, colors):
    rng = np.random.default_rng(6)
    pts = rng.normal(size=(30, 3))
    kw = dict(normals=rng.normal(size=(30, 3)) if normals else None,
              colors=rng.uniform(size=(30, 3)) if colors else None)
    a, b = str(tmp_path / "a.ply"), str(tmp_path / "b.ply")
    io.save_ply(a, pts, **kw)
    jio.save_ply(b, pts, **kw)
    assert open(a).read() == open(b).read()
    for dtype in (np.float64, np.float32):
        p = str(tmp_path / f"bin_{np.dtype(dtype).name}.ply")
        io.save_ply(p, pts.astype(dtype), binary=True, **kw)
        got, want = io.load_cloud(p), jio.load_cloud(p)  # through both packages' native paths
        _same(got, want)
        np.testing.assert_array_equal(got[0], pts.astype(dtype))
        if normals:
            np.testing.assert_array_equal(got[1], kw["normals"].astype(dtype))


@pytest.mark.parametrize("name, args", [
    ("sphere_cloud", (100,)), ("sphere_cloud", (50, 2.0, (1.0, -1.0, 0.5), 0.01, 3)),
    ("partial_sphere_cloud", (80, 1.0, 0.3, 2)), ("ellipsoid_cloud", (60,)),
    ("box_cloud", (70,)), ("torus_cloud", (90, 1.2, 0.3, 4))])
def test_synthetic_clouds_match_jax(name, args):
    for dtype in (np.float64, np.float32):
        got = getattr(syn, name)(*args, dtype=dtype)
        want = getattr(jsyn, name)(*args, dtype=dtype)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    q = np.random.default_rng(7).normal(size=(20, 3))
    np.testing.assert_array_equal(syn.sdf_sphere(q, 0.7, (0.1, 0, 0)),
                                  jsyn.sdf_sphere(q, 0.7, (0.1, 0, 0)))
    np.testing.assert_array_equal(syn.sdf_torus(q, 1.1, 0.2), jsyn.sdf_torus(q, 1.1, 0.2))


def test_viz_exports_match_jax(tmp_path):
    rng = np.random.default_rng(8)
    verts, faces = rng.normal(size=(12, 3)), rng.integers(0, 12, size=(7, 3))
    var, nrm = rng.uniform(size=12), rng.normal(size=(12, 3))
    np.testing.assert_array_equal(export.variance_colormap(var), jexport.variance_colormap(var))
    np.testing.assert_array_equal(export.variance_colormap(np.ones(3)),
                                  jexport.variance_colormap(np.ones(3)))
    charts = [{"center": [0.0, 0.1, 0.2], "normal": [0, 0, 1.0], "u": [1.0, 0, 0],
               "v": [0, 1.0, 0], "radius": 0.1}]
    for fn, args, kw in (
            ("export_isosurface_ply", (verts, faces), dict(variance=var, normals=nrm)),
            ("export_isosurface_ply", (verts, faces), {}),
            ("export_cloud_ply", (verts,), dict(variance=var, normals=nrm)),
            ("export_html", (verts, faces), dict(variance=var, charts=charts,
                                                 best_path=verts[:4])),
            ("export_html", (verts, faces), {})):
        a, b = str(tmp_path / "a"), str(tmp_path / "b")
        getattr(export, fn)(a, *args, **kw)
        getattr(jexport, fn)(b, *args, **kw)
        assert open(a).read() == open(b).read(), fn
    html = open(a).read()
    assert "gpis-tpu viewer" in html
    payload = json.loads(html.split("const D=")[1].split(";\n")[0])
    assert payload["faces"] == faces.tolist() and payload["path"] == []


def test_profiling_matches_jax(tmp_path):
    for mod in (profiling, jprof):
        with mod.trace(None):  # no log dir: a clean no-op
            pass
    log_dir = str(tmp_path / "trace")
    with profiling.trace(log_dir):
        with profiling.span("product"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    spans_name, trace_name = sorted(os.listdir(log_dir))
    assert trace_name.startswith("trace.") and trace_name.endswith(".json")
    # The window's span record lies beside the Chrome trace, under its stem.
    assert spans_name == "spans." + trace_name[len("trace."):]
    events = json.load(open(os.path.join(log_dir, trace_name)))["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert any(e.get("name") == "gpis.product" for e in events)
    record = json.load(open(os.path.join(log_dir, spans_name)))
    assert [s[0] for s in record["spans"]] == ["product"] and record["anchor"]


def test_provenance_matches_jax(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert provenance.head_rev() == jprov.head_rev() == provenance.head_rev(repo)
    stamp, jstamp = provenance.provenance(), jprov.provenance()
    assert set(stamp) == set(jstamp) and stamp.get("rev") == jstamp.get("rev")
    # A fresh repository: its rev, clean, then dirty once a tracked file changes.
    d = str(tmp_path)
    git = ["git", "-C", d, "-c", "user.name=t", "-c", "user.email=t@t"]
    subprocess.run(["git", "init", "-q", d], check=True)
    (tmp_path / "f.txt").write_text("a")
    (tmp_path / "PROGRESS.jsonl").write_text("{}")
    subprocess.run(git + ["add", "."], check=True)
    subprocess.run(git + ["commit", "-q", "-m", "x"], check=True)
    rev = subprocess.run(git + ["rev-parse", "--short", "HEAD"], capture_output=True,
                         text=True).stdout.strip()
    assert provenance.head_rev(d) == jprov.head_rev(d) == (rev, False)
    (tmp_path / "PROGRESS.jsonl").write_text("{1}")  # the journal does not count
    assert provenance.head_rev(d) == (rev, False)
    (tmp_path / "f.txt").write_text("b")
    assert provenance.head_rev(d) == jprov.head_rev(d) == (rev, True)
    assert provenance.head_rev(str(tmp_path / "nowhere")) == (None, False)
