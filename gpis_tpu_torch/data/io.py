"""Point-cloud IO (port of gpis_tpu/data/io.py): ASCII and binary
little-endian PLY (positions and optional normals), PCL's PCD (ascii and
binary), NPZ and whitespace XYZ text.  NumPy on the host: IO never touches
the card.  The binary PLY reader hands the vertex records to the port's
C++ runtime (`native.bindings.ply_extract`), as the JAX package does where
its library is built; `load_ply(..., native=False)` unpacks them in Python.
"""

from __future__ import annotations

import struct

import numpy as np

from gpis_tpu_torch.native import bindings as nb

__all__ = ["load_cloud", "save_ply", "load_ply"]

_PLY_TYPES = {
    "float": ("f", 4), "float32": ("f", 4), "double": ("d", 8), "float64": ("d", 8),
    "uchar": ("B", 1), "uint8": ("B", 1), "char": ("b", 1), "int8": ("b", 1),
    "short": ("h", 2), "ushort": ("H", 2), "int": ("i", 4), "int32": ("i", 4),
    "uint": ("I", 4), "uint32": ("I", 4),
}


def load_cloud(path: str):
    """Load a cloud from .ply/.pcd/.npz/.xyz/.txt. Returns (points, normals|None)."""
    if path.endswith(".ply"):
        return load_ply(path)
    if path.endswith(".pcd"):
        return load_pcd(path)
    if path.endswith(".npz"):
        d = np.load(path)
        pts = np.asarray(d["points"], np.float64)
        nrm = np.asarray(d["normals"], np.float64) if "normals" in d else None
        return pts, nrm
    data = np.loadtxt(path)
    if data.shape[1] >= 6:
        return data[:, :3], data[:, 3:6]
    return data[:, :3], None


def load_pcd(path: str):
    """PCL .pcd reader (ascii and binary formats)."""
    with open(path, "rb") as f:
        fields, sizes, types, counts = [], [], [], []
        n_points = 0
        data_mode = None
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: truncated PCD header")
            parts = line.decode("ascii", "replace").strip().split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0].upper()
            if key == "FIELDS":
                fields = [p.lower() for p in parts[1:]]
            elif key == "SIZE":
                sizes = [int(p) for p in parts[1:]]
            elif key == "TYPE":
                types = parts[1:]
            elif key == "COUNT":
                counts = [int(p) for p in parts[1:]]
            elif key == "POINTS":
                n_points = int(parts[1])
            elif key == "DATA":
                data_mode = parts[1].lower()
                break
        counts = counts or [1] * len(fields)
        np_types = {("F", 4): "f4", ("F", 8): "f8", ("U", 1): "u1", ("U", 2): "u2",
                    ("U", 4): "u4", ("I", 1): "i1", ("I", 2): "i2", ("I", 4): "i4"}
        dtype = np.dtype([
            (name if cnt == 1 else f"{name}_", f"<{np_types[(t, s)]}", (cnt,) if cnt > 1 else ())
            for name, s, t, cnt in zip(fields, sizes, types, counts)
        ])
        if data_mode == "ascii":
            rows = np.loadtxt(f, max_rows=n_points)
            rows = rows.reshape(n_points, -1)
            idx = {}
            col = 0
            for name, cnt in zip(fields, counts):
                idx[name] = col
                col += cnt
            pts = rows[:, [idx["x"], idx["y"], idx["z"]]].astype(np.float64)
            nrm = None
            if all(k in idx for k in ("normal_x", "normal_y", "normal_z")):
                nrm = rows[:, [idx["normal_x"], idx["normal_y"], idx["normal_z"]]].astype(np.float64)
            return pts, nrm
        if data_mode == "binary":
            raw = np.frombuffer(f.read(dtype.itemsize * n_points), dtype=dtype,
                                count=n_points)
            pts = np.stack([raw["x"], raw["y"], raw["z"]], axis=1).astype(np.float64)
            nrm = None
            if all(k in dtype.names for k in ("normal_x", "normal_y", "normal_z")):
                nrm = np.stack([raw["normal_x"], raw["normal_y"], raw["normal_z"]],
                               axis=1).astype(np.float64)
            return pts, nrm
        raise ValueError(f"unsupported PCD data mode {data_mode!r} (ascii/binary only)")


def load_ply(path: str, *, native: bool = True):
    """(points, normals | None) of an ASCII or binary little-endian PLY.
    Binary records go to the C++ runtime with `native` (which raises if it
    cannot be built), else through `struct`."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        props: list[tuple[str, str]] = []
        n_vertex = 0
        in_vertex = False
        while True:
            line = f.readline().split()
            if not line:
                raise ValueError("unexpected EOF in PLY header")
            if line[0] == b"format":
                fmt = line[1].decode()
            elif line[0] == b"element":
                in_vertex = line[1] == b"vertex"
                if in_vertex:
                    n_vertex = int(line[2])
            elif line[0] == b"property" and in_vertex:
                props.append((line[1].decode(), line[2].decode()))
            elif line[0] == b"end_header":
                break
        names = [p[1] for p in props]
        idx = {n: i for i, n in enumerate(names)}
        if fmt == "ascii":
            rows = np.loadtxt(f, max_rows=n_vertex).reshape(n_vertex, len(props))
        elif fmt == "binary_little_endian":
            fmt_str = "<" + "".join(_PLY_TYPES[t][0] for t, _ in props)
            size = struct.calcsize(fmt_str)
            buf = f.read(size * n_vertex)
            if native:  # the C++ extractor parses the record buffer directly
                return nb.ply_extract(buf, n_vertex, [t for t, _ in props], idx)
            rows = np.array([struct.unpack_from(fmt_str, buf, i * size) for i in range(n_vertex)])
        else:
            raise ValueError(f"unsupported PLY format {fmt}")
        pts = rows[:, [idx["x"], idx["y"], idx["z"]]].astype(np.float64)
        nrm = None
        if all(k in idx for k in ("nx", "ny", "nz")):
            nrm = rows[:, [idx["nx"], idx["ny"], idx["nz"]]].astype(np.float64)
        return pts, nrm


def save_ply(path: str, points, normals=None, colors=None, *, binary: bool = False):
    """Write a PLY of points with optional normals and colors in [0, 1]
    (`viz.export` writes variance-colored clouds through it).  ASCII by
    default, as the JAX package writes it; `binary=True` writes binary
    little-endian records, positions and normals as `float` for float32
    points and `double` otherwise, colors as `uchar`."""
    pts = np.asarray(points)
    n = len(pts)
    cols = None if colors is None else np.clip(np.asarray(colors) * 255, 0, 255).astype(np.uint8)
    if binary:
        ftype, fmt = ("float", "<f4") if pts.dtype == np.float32 else ("double", "<f8")
        fields = [(name, fmt) for name in ("x", "y", "z")]
        if normals is not None:
            fields += [(name, fmt) for name in ("nx", "ny", "nz")]
        if cols is not None:
            fields += [(name, "u1") for name in ("red", "green", "blue")]
        rec = np.empty(n, dtype=np.dtype(fields))
        for d, name in enumerate(("x", "y", "z")):
            rec[name] = pts[:, d]
        if normals is not None:
            nrm = np.asarray(normals)
            for d, name in enumerate(("nx", "ny", "nz")):
                rec[name] = nrm[:, d]
        if cols is not None:
            for d, name in enumerate(("red", "green", "blue")):
                rec[name] = cols[:, d]
        header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
        header += [f"property {'uchar' if t == 'u1' else ftype} {name}" for name, t in fields]
        header.append("end_header\n")
        with open(path, "wb") as f:
            f.write("\n".join(header).encode("ascii"))
            f.write(rec.tobytes())
        return
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if normals is not None:
            f.write("property float nx\nproperty float ny\nproperty float nz\n")
        if cols is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for i in range(n):
            row = list(pts[i])
            if normals is not None:
                row += list(np.asarray(normals)[i])
            f.write(" ".join(f"{v:.6f}" for v in row))
            if cols is not None:
                f.write(" " + " ".join(str(int(v)) for v in cols[i]))
            f.write("\n")
