"""Synthetic point-cloud generators (port of gpis_tpu/data/synthetic.py,
NumPy, the same draws from the same seeds): sphere, partial sphere,
ellipsoid, box and torus clouds with outward normals, and the signed
distances of the sphere and the torus for analytic-truth checks."""

from __future__ import annotations

import numpy as np

__all__ = ["sphere_cloud", "ellipsoid_cloud", "box_cloud", "partial_sphere_cloud", "torus_cloud",
           "sdf_sphere", "sdf_torus"]


def _rng(seed):
    return np.random.default_rng(seed)


def sphere_cloud(n: int, radius: float = 1.0, center=(0.0, 0.0, 0.0), noise: float = 0.0,
                 seed: int = 0, dtype=np.float64):
    """n points on a sphere (+ optional radial Gaussian noise). Returns
    (points, normals)."""
    g = _rng(seed)
    v = g.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    r = radius + (g.normal(scale=noise, size=(n, 1)) if noise > 0 else 0.0)
    pts = (v * r + np.asarray(center)).astype(dtype)
    return pts, v.astype(dtype)


def partial_sphere_cloud(n: int, radius: float = 1.0, cap_cos: float = 0.0, seed: int = 0,
                         dtype=np.float64):
    """Partial view of a sphere: only points with z/r > cap_cos (a
    single-viewpoint RGB-D scan)."""
    pts, nrm = sphere_cloud(int(n * 4 / max(1e-3, 1.0 - cap_cos)), radius, seed=seed, dtype=dtype)
    keep = nrm[:, 2] > cap_cos
    return pts[keep][:n], nrm[keep][:n]


def ellipsoid_cloud(n: int, radii=(1.0, 0.7, 0.5), seed: int = 0, dtype=np.float64):
    g = _rng(seed)
    v = g.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pts = v * np.asarray(radii)
    # Outward normals of an ellipsoid: grad of (x/a)^2+(y/b)^2+(z/c)^2.
    nrm = pts / np.asarray(radii) ** 2
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return pts.astype(dtype), nrm.astype(dtype)


def box_cloud(n: int, half=(0.6, 0.5, 0.4), seed: int = 0, dtype=np.float64):
    g = _rng(seed)
    half = np.asarray(half, dtype)
    areas = np.array([half[1] * half[2], half[0] * half[2], half[0] * half[1]])
    face_axis = g.choice(3, size=n, p=areas / areas.sum())
    sign = g.choice([-1.0, 1.0], size=n)
    pts = g.uniform(-1.0, 1.0, size=(n, 3)) * half
    nrm = np.zeros((n, 3), dtype)
    pts[np.arange(n), face_axis] = sign * half[face_axis]
    nrm[np.arange(n), face_axis] = sign
    return pts.astype(dtype), nrm


def sdf_sphere(q, radius: float = 1.0, center=(0.0, 0.0, 0.0)):
    """Ground-truth signed distance of a sphere (for surface-RMSE checks)."""
    return np.linalg.norm(np.asarray(q) - np.asarray(center), axis=-1) - radius


def torus_cloud(n: int, R: float = 1.0, r: float = 0.35, seed: int = 0, dtype=np.float64):
    """n points on a torus (major radius R, tube radius r) with outward
    normals — a genus-1 surface that stresses isosurface extraction and the
    implicit labeling (the internal -1 point sits OFF the surface's solid)."""
    g = _rng(seed)
    u = g.uniform(0, 2 * np.pi, n)
    v = g.uniform(0, 2 * np.pi, n)
    cx, sx = np.cos(u), np.sin(u)
    pts = np.stack([(R + r * np.cos(v)) * cx, (R + r * np.cos(v)) * sx,
                    r * np.sin(v)], axis=1)
    nrm = np.stack([np.cos(v) * cx, np.cos(v) * sx, np.sin(v)], axis=1)
    return pts.astype(dtype), nrm.astype(dtype)


def sdf_torus(q, R: float = 1.0, r: float = 0.35):
    """Signed distance of a torus."""
    q = np.asarray(q)
    qxy = np.linalg.norm(q[..., :2], axis=-1)
    return np.sqrt((qxy - R) ** 2 + q[..., 2] ** 2) - r
