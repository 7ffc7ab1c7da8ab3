"""Isosurface extraction from the dense posterior grid (BASELINE config 4;
replaces the reference's RViz isosurface-sample publishing, SURVEY.md §3
C4/C10).

Marching *tetrahedra*: each grid cell splits into 6 tetrahedra sharing the
0-6 diagonal; each tet contributes 0-2 triangles depending on the sign
pattern of f at its 4 corners.  Chosen over classic marching cubes because
it needs no hand-transcribed 256-case table (the 16-case tet table below is
generated programmatically and is provably complete) while producing a
watertight triangulation of the f=0 level set.

This is deliberately *host-side* NumPy: the output size is data-dependent
(anathema to XLA static shapes) and the work is O(cells), negligible next to
the device-side GP evaluation that produced the field.  The port's own copy of
gpis_tpu/surface/marching.py.  By default the port's C++ runtime
(`native.bindings.marching_tets`, built at first use) extracts the soup;
`native=False` takes the NumPy path, which emits the same triangles in the
same order (by cell, then tetrahedron, then triangle), so both packages
return one soup element for element whichever path each takes where the
JAX package's library is built.
"""

from __future__ import annotations

import numpy as np

from gpis_tpu_torch.native import bindings as nb

__all__ = ["marching_tetrahedra", "weld_vertices"]

# Cube corners by (x, y, z) bit pattern, and the 6-tet decomposition around
# the 0-6 diagonal.
_CORNERS = np.array(
    [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0], [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]]
)
_TETS = np.array(
    [[0, 1, 2, 6], [0, 2, 3, 6], [0, 3, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6], [0, 5, 1, 6]]
)


def _build_case_table():
    """For each 4-bit inside-mask: list of triangles, each triangle a list of
    3 tet-edge (i, j) pairs whose zero crossings form the triangle."""
    table = []
    for mask in range(16):
        inside = [v for v in range(4) if mask >> v & 1]
        outside = [v for v in range(4) if not mask >> v & 1]
        tris = []
        if len(inside) == 1:
            a = inside[0]
            o = outside
            tris = [[(a, o[0]), (a, o[1]), (a, o[2])]]
        elif len(inside) == 3:
            a = outside[0]
            o = inside
            tris = [[(a, o[0]), (a, o[1]), (a, o[2])]]
        elif len(inside) == 2:
            a, b = inside
            c, d = outside
            # Quad across edges (a,c),(a,d),(b,d),(b,c) -> two triangles.
            tris = [
                [(a, c), (a, d), (b, d)],
                [(a, c), (b, d), (b, c)],
            ]
        table.append(tris)
    return table


_CASES = _build_case_table()


def marching_tetrahedra(field, axis_x, axis_y=None, axis_z=None, iso: float = 0.0,
                        *, native: bool = True):
    """Extract the `field == iso` surface.

    field: (RX, RY, RZ) scalar grid; axis_*: coordinate vectors (axis_x reused
    for all axes if the others are omitted).  Returns (verts (K, 3),
    faces (K//3, 3)) as a triangle soup (use `weld_vertices` to index-share).
    `native=True` runs the C++ runtime and raises if it cannot be built;
    `native=False` the NumPy path (the same soup)."""
    if native:
        return nb.marching_tets(field, axis_x, axis_y, axis_z, iso)
    f = np.asarray(field, np.float64) - iso
    ax = np.asarray(axis_x, np.float64)
    ay = ax if axis_y is None else np.asarray(axis_y, np.float64)
    az = ax if axis_z is None else np.asarray(axis_z, np.float64)
    rx, ry, rz = f.shape

    # Corner values/positions for every cell: (ncells, 8).
    cx, cy, cz = np.meshgrid(
        np.arange(rx - 1), np.arange(ry - 1), np.arange(rz - 1), indexing="ij"
    )
    cx, cy, cz = cx.ravel(), cy.ravel(), cz.ravel()
    corner_vals = np.empty((cx.size, 8))
    corner_pos = np.empty((cx.size, 8, 3))
    for c, (dx, dy, dz) in enumerate(_CORNERS):
        ix, iy, iz = cx + dx, cy + dy, cz + dz
        corner_vals[:, c] = f[ix, iy, iz]
        corner_pos[:, c, 0] = ax[ix]
        corner_pos[:, c, 1] = ay[iy]
        corner_pos[:, c, 2] = az[iz]

    # Quick reject: cells whose 8 corners share a sign produce nothing.
    sign = corner_vals < 0.0
    active = (sign.any(axis=1)) & (~sign.all(axis=1))
    corner_vals = corner_vals[active]
    corner_pos = corner_pos[active]

    all_tris, keys = [], []
    cell_ids = np.arange(corner_vals.shape[0])
    for t_idx, tet in enumerate(_TETS):
        tv = corner_vals[:, tet]  # (n, 4)
        tp = corner_pos[:, tet]  # (n, 4, 3)
        mask = ((tv < 0.0) << np.arange(4)).sum(axis=1)
        for m in range(1, 15):
            tris = _CASES[m]
            if not tris:
                continue
            sel = mask == m
            if not sel.any():
                continue
            v, p = tv[sel], tp[sel]
            for k, tri in enumerate(tris):
                keys.append(np.stack([cell_ids[sel], np.full(v.shape[0], 2 * t_idx + k)], 1))
                pts = []
                for i, j in tri:
                    fi, fj = v[:, i], v[:, j]
                    t = fi / (fi - fj)  # crossing: signs differ by construction
                    pts.append(p[:, i] + t[:, None] * (p[:, j] - p[:, i]))
                all_tris.append(np.stack(pts, axis=1))  # (k, 3, 3)

    if not all_tris:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    key = np.concatenate(keys)
    soup = np.concatenate(all_tris, axis=0)[np.lexsort((key[:, 1], key[:, 0]))]  # (ntri, 3, 3)
    verts = soup.reshape(-1, 3)
    faces = np.arange(len(verts), dtype=np.int64).reshape(-1, 3)
    return verts, faces


def weld_vertices(verts, faces, decimals: int = 8):
    """Merge coincident vertices (exact after rounding) -> indexed mesh."""
    key = np.round(verts, decimals)
    uniq, inv = np.unique(key, axis=0, return_inverse=True)
    return uniq, inv[faces]
