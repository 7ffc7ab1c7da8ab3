"""Seeded inputs: a configuration's object cloud under a seeded rigid motion,
its radial normals, and the contacts a finger makes along a path.

The shape is the configuration's (a Fibonacci sphere of `n_surface` points,
its `radius` and `center`, optionally without the cap z > `cap_z`); the
seed draws the pose, a rotation (uniform, or a spin about z alone, as the
traffic asks) and a translation, and where the
traffic asks for it the semi-axes of an ellipsoid the sphere is stretched
to, so that successive clouds are different objects.  Every seed asks the
program for the same sizes of work.
"""

from __future__ import annotations

import numpy as np

from perfbench.reference.gp import fibonacci_sphere

__all__ = ["Cloud", "make_cloud", "path_contacts"]


class Cloud:
    """A world-frame cloud (float32), its unit normals, and the true
    sphere's centre and radius in the world frame."""

    def __init__(self, points, normals, center, radius):
        self.points, self.normals, self.center, self.radius = points, normals, center, radius


def _rotation(rng) -> np.ndarray:
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q


def _yaw(rng) -> np.ndarray:
    """A uniform spin about the z axis."""
    a = rng.uniform(0.0, 2.0 * np.pi)
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def unit_points(n: int, cap_z: float | None = None) -> np.ndarray:
    """n Fibonacci points of the unit sphere; with cap_z, the points of a
    denser Fibonacci sphere that lie at z <= cap_z (the last n of them)."""
    if cap_z is None:
        return fibonacci_sphere(n)
    total = round(n / (1.0 - (1.0 - cap_z) / 2.0))
    pts = fibonacci_sphere(total)
    pts = pts[pts[:, 2] <= cap_z][-n:]
    if len(pts) != n:
        raise ValueError(f"{len(pts)} points below the cap z <= {cap_z}, not {n}")
    return pts


def make_cloud(shape: dict, rng, cap_z: float | None = None, axes=None,
               rotation: str = "uniform") -> Cloud:
    """The configuration's sphere (`shape`: n_surface, radius, center) under
    a `rotation` ("uniform" or "yaw") and a translation in [-1, 1]^3
    drawn from rng; with `axes` (lo, hi), first
    stretched to an ellipsoid whose semi-axes are drawn from [lo, hi] times
    the radius (its normals then the ellipsoid's)."""
    unit = unit_points(int(shape["n_surface"]), cap_z)
    rot = {"uniform": _rotation, "yaw": _yaw}[rotation](rng)
    shift = rng.uniform(-1.0, 1.0, size=3)
    a = np.ones(3) if axes is None else rng.uniform(axes[0], axes[1], size=3)
    center = np.asarray(shape["center"], np.float64) @ rot.T + shift
    grad = unit / a
    normals = (grad / np.linalg.norm(grad, axis=1, keepdims=True)) @ rot.T
    points = center + float(shape["radius"]) * (unit * a) @ rot.T
    return Cloud(points.astype(np.float32), normals.astype(np.float32), center,
                 float(shape["radius"]))


def path_contacts(path_world, cloud: Cloud, k: int) -> np.ndarray:
    """k contacts evenly spaced along a path's polyline (its one pose, if it
    has one), moved radially onto the true sphere (float32)."""
    p = np.asarray(path_world, np.float64)
    if len(p) > 1:
        s = np.concatenate([[0.0], np.cumsum(np.linalg.norm(np.diff(p, axis=0), axis=1))])
        t = np.linspace(0.0, s[-1], k)
        p = np.stack([np.interp(t, s, p[:, i]) for i in range(3)], axis=1)
    else:
        p = np.repeat(p, k, axis=0)
    d = p - cloud.center
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (cloud.center + cloud.radius * d).astype(np.float32)
