"""Voxel-grid downsampling (reference's PCL `VoxelGrid` stage, SURVEY.md
§4.1 "VoxelGrid downsample (PCL), hot: O(N)").

Host-side preprocessing, like in the reference (the cloud is downsampled
before it ever reaches the GP).  The port's own copy of
gpis_tpu/data/voxel.py: `voxel_downsample` runs the port's C++ runtime
(`native.bindings`), as the JAX package does where its library is built,
so both keep the voxels in its first-seen order.
"""

from __future__ import annotations

import numpy as np

from gpis_tpu_torch.native import bindings as nb

__all__ = ["voxel_downsample"]


def _voxel_downsample_numpy(points: np.ndarray, leaf: float) -> np.ndarray:
    pts = np.asarray(points, dtype=np.float64)
    if leaf <= 0 or len(pts) == 0:
        return pts
    keys = np.floor(pts / leaf).astype(np.int64)
    # Unique voxel per point; centroid of points in each voxel (PCL semantics).
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    sums = np.zeros((len(uniq), 3))
    np.add.at(sums, inv, pts)
    counts = np.bincount(inv, minlength=len(uniq)).astype(np.float64)
    return sums / counts[:, None]


def voxel_downsample(points, leaf: float):
    """Centroid voxel-grid filter, by the C++ runtime (voxels in first-seen
    order; raises if the runtime cannot be built). leaf<=0 returns the
    input unchanged.  `_voxel_downsample_numpy` is its NumPy twin (voxels
    in sorted key order)."""
    return nb.voxel_downsample(np.asarray(points, np.float64), leaf)


def voxel_downsample_with_normals(points, normals, leaf: float):
    """Voxel filter carrying normals: centroid position + renormalized mean
    normal per occupied voxel (what PCL's VoxelGrid does with normal
    fields).  Cells whose normals cancel entirely keep the first normal."""
    pts = np.asarray(points, np.float64)
    nrm = np.asarray(normals, np.float64)
    if leaf <= 0 or len(pts) == 0:
        return pts, nrm
    keys = np.floor(pts / leaf).astype(np.int64)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    m = len(uniq)
    psum = np.zeros((m, 3))
    nsum = np.zeros((m, 3))
    np.add.at(psum, inv, pts)
    np.add.at(nsum, inv, nrm)
    counts = np.bincount(inv, minlength=m).astype(np.float64)
    out_p = psum / counts[:, None]
    norms = np.linalg.norm(nsum, axis=1)
    # Degenerate cells (normals cancel): fall back to the first member's normal.
    first = np.zeros(m, np.int64)
    seen = np.zeros(m, bool)
    for i, cell in enumerate(inv):
        if not seen[cell]:
            first[cell] = i
            seen[cell] = True
    out_n = np.where(norms[:, None] > 1e-12, nsum / np.maximum(norms, 1e-12)[:, None],
                     nrm[first])
    return out_p, out_n
