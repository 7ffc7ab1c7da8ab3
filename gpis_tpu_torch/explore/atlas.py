"""Atlas of tangent-space charts (port of gpis_tpu/explore/atlas.py).

A chart is (centre on the estimated surface, outward normal, tangent basis,
radius); the radius shrinks where the posterior variance is high, so the
atlas treads carefully where it is uncertain.  The tree is host logic:
`Chart`, its basis, its radius and its disc samples are NumPy, as in the
JAX package, and centres, normals and variances cross to the host once a
chart.  The device work is the port's own: normals from
`surface.projection.surface_normals`, variances from one
`gp.regression.predict` call, and a candidate's projection from
`projection.project_point` with the mean's analytic gradient
(`projection._gradient`) in place of JAX's `jax.grad`.  That one-point
predict runs inside `jax.jit` in the JAX package, where a committee answers
from every expert: the port passes `gate=0`, which only a committee reads.

On a sharded model every rank runs the same host loop, so every value it
branches on must be the same on every rank: the predicts are (their output
is all-gathered), and the projected points and normals, which each rank
computes on its own, are taken from rank 0 (`_agree`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gpis_tpu_torch.config import ExploreConfig
from gpis_tpu_torch.gp import regression as gpr
from gpis_tpu_torch.gp.kinds import model_kind
from gpis_tpu_torch.kernels import functions as kf
from gpis_tpu_torch.surface import projection
from gpis_tpu_torch.utils import profiling

__all__ = ["Chart", "make_charts", "disc_samples", "project_and_chart"]


@dataclasses.dataclass
class Chart:
    """One tangent-space disc of the atlas (a host object)."""

    id: int
    center: np.ndarray  # (3,) on the estimated surface
    normal: np.ndarray  # (3,) outward unit normal
    u: np.ndarray  # (3,) tangent basis
    v: np.ndarray  # (3,)
    radius: float
    variance: float
    parent: int  # parent chart id, -1 for the root


def _tangent_basis(normal: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Orthonormal (u, v) spanning the plane perpendicular to `normal`."""
    # The world axis least aligned with the normal, for stability.
    a = np.zeros(3)
    a[np.argmin(np.abs(normal))] = 1.0
    u = np.cross(normal, a)
    u /= np.linalg.norm(u)
    v = np.cross(normal, u)
    return u, v


def chart_radius(variance: float, prior_var: float, cfg: ExploreConfig) -> float:
    """Variance-shrunk disc radius: radius_max where the posterior is
    certain, shrinking toward radius_min as the variance nears the prior."""
    rel = float(np.clip(variance / max(prior_var, 1e-30), 0.0, 1.0))
    r = cfg.radius_max * (1.0 - cfg.variance_radius_gain * rel)
    return float(np.clip(r, cfg.radius_min, cfg.radius_max))


def _agree(model, t: torch.Tensor) -> torch.Tensor:
    """Rank 0's values of t on every rank of a sharded model's mesh (t
    itself for any other model)."""
    if model_kind(model) in ("sharded", "sharded_joint"):
        t = t.contiguous()
        torch.distributed.broadcast(t, src=0)
    return t


def make_charts(model, centers, cfg: ExploreConfig, *, ids, parents):
    """Charts at (M, 3) centres: the normals in one call, the variances in
    one predict, one copy of each to the host."""
    centers = torch.as_tensor(centers).to(dtype=model.dtype, device=model.device)
    both = _agree(model, torch.cat([centers, projection.surface_normals(model, centers)], dim=1))
    var = gpr.predict(model, both[:, :3].contiguous())[1]
    with profiling.wait("chart.copy", 2):
        var, both = var.cpu().numpy(), both.cpu().numpy()
    centers, normals = both[:, :3], both[:, 3:]
    prior = float(kf.k_diag0(model.kernel, model.params))
    charts = []
    for i in range(len(centers)):
        u, v = _tangent_basis(normals[i])
        charts.append(Chart(id=int(ids[i]), center=centers[i], normal=normals[i], u=u, v=v,
                            radius=chart_radius(float(var[i]), prior, cfg),
                            variance=float(var[i]), parent=int(parents[i])))
    return charts


def project_and_chart(model, x0, cfg: ExploreConfig, *, cid, parent):
    """Project a candidate (3,) onto the surface and build its Chart: the
    projection, the normal there (the mean's gradient, normalized) and a
    one-point predict.  Returns None when the projection does not
    converge."""
    profiling.count("project.tried")
    x, ok = projection.project_point(model, torch.as_tensor(x0))
    g = projection._gradient(model, x[None, :])[0]
    n = g / torch.clamp(torch.linalg.vector_norm(g), min=1e-12)
    both = _agree(model, torch.cat([x, n, ok.to(x.dtype)[None]]))
    with profiling.wait("chart.copy"):
        host = both.cpu().numpy()
    if not host[6]:
        return None
    n = host[3:6]
    var = gpr.predict(model, both[None, :3], gate=0)[1][0]
    with profiling.wait("chart.var"):
        var = float(var)
    u, v = _tangent_basis(n)
    prior = float(kf.k_diag0(model.kernel, model.params))
    return Chart(id=int(cid), center=host[:3], normal=n, u=u, v=v,
                 radius=chart_radius(var, prior, cfg), variance=var, parent=int(parent))


def disc_samples(chart: Chart, n: int) -> np.ndarray:
    """n candidate points on the chart's disc boundary."""
    theta = np.linspace(0.0, 2.0 * np.pi, n, endpoint=False)
    return (
        chart.center[None, :]
        + chart.radius * (np.cos(theta)[:, None] * chart.u[None, :]
                          + np.sin(theta)[:, None] * chart.v[None, :])
    )
