"""Surface projection (port of gpis_tpu/surface/projection.py).

Newton iteration of a point onto the posterior mean's zero set,

    x <- x - f(x) g / max(|g|^2, 1e-12),   g = grad f(x),

each step clipped to `step_clip` in length, until |f| <= tol or after
`max_iters` steps.  The JAX package takes g from `jax.grad` of the
posterior mean under `vmap` and a `lax.while_loop` a seed.  Here the mean
runs through Kernels A and E, which have no backward pass, so g is the
mean's analytic gradient: sum_i alpha_i 2 dk_dr2 (q - x_i) over the value
columns (`kernels.derivative.cross_cov_grad_value`), the joint model's
`predict_gradient` form over its value and gradient columns, and, after
out-of-core updates, the same over the touch tail; a committee's mean and
gradient come together from `experts.mean_and_gradient` (through every
expert's mean and variance).  All seeds step as one
batch, and a mask keeps each on its own JAX loop: a seed that has converged
or run out of steps is neither evaluated nor moved again.
"""

from __future__ import annotations

import torch

from gpis_tpu_torch.gp import regression as gpr
from gpis_tpu_torch.gp.kinds import model_kind
from gpis_tpu_torch.kernels import derivative as kd
from gpis_tpu_torch.linalg import outofcore as ooc
from gpis_tpu_torch.utils import profiling

__all__ = ["project_points", "surface_normals", "project_point"]

# Points per gradient evaluation: the (M, C, 3) differences of one chunk
# stay under ~0.5 GB at C = 16,384 in float32.
_CHUNK = 2048


def _per_axis(g: torch.Tensor, m: int) -> torch.Tensor:
    """(3M,) dimension-major gradient components -> (M, 3)."""
    return torch.stack([g[:m], g[m:2 * m], g[2 * m:]], dim=1)


def _gradient(model, q: torch.Tensor) -> torch.Tensor:
    """grad of the posterior mean at q (M, 3): (M, 3)."""
    kind = model_kind(model)
    if kind == "experts":
        from gpis_tpu_torch.gp import experts as gpe

        return gpe.mean_and_gradient(model, q)[1]
    if kind == "joint":
        from gpis_tpu_torch.gp import derivative as gpd

        return gpd.predict_gradient(model, q)
    m = q.shape[0]
    if kind == "sharded_joint":
        c = model.n0
        kq = torch.cat([kd.cross_cov_grad(model.kernel, q, model.x[:c], model.params),
                        kd.cross_cov_grad_value(model.kernel, q, model.x[c:], model.params)],
                       dim=1)
        return _per_axis(kq @ model.alpha, m)
    cross = kd.cross_cov_grad if kind == "ooc_joint" else kd.cross_cov_grad_value
    g = _per_axis(cross(model.kernel, q, model.x, model.params) @ model.alpha, m)
    if kind in ("ooc", "ooc_joint") and model.n_tail:
        g = g + _per_axis(ooc.tail_cross(model, q, grad=True) @ model.tail_alpha, m)
    return g


def _mean_and_gradient(model, q: torch.Tensor):
    if model_kind(model) == "experts":
        from gpis_tpu_torch.gp import experts as gpe

        parts = [gpe.mean_and_gradient(model, qc) for qc in torch.split(q, _CHUNK)]
    else:
        parts = [(gpr.predict_mean(model, qc), _gradient(model, qc))
                 for qc in torch.split(q, _CHUNK)]
    return torch.cat([f for f, _ in parts]), torch.cat([g for _, g in parts])


def _project(model, seeds: torch.Tensor, max_iters: int, tol: float, step_clip: float):
    with profiling.wait("project.upload"):
        x = torch.as_tensor(seeds).to(dtype=model.dtype, device=model.device, copy=True)
    if x.shape[0] == 0:
        return x, torch.zeros((0,), dtype=torch.bool, device=x.device)
    # f and g at the point where the last step ended: the JAX loop evaluates
    # them again at the start of the next step, at the same point, so
    # reusing them gives the same numbers.
    f, g = _mean_and_gradient(model, x)
    for _ in range(max_iters):
        with profiling.wait("project.active"):
            active = torch.nonzero(f.abs() > tol).flatten()
        if active.numel() == 0:
            break
        fa, ga = f[active], g[active]
        g2 = torch.clamp(torch.sum(ga * ga, dim=1), min=1e-12)
        step = fa[:, None] * ga / g2[:, None]
        norm = torch.linalg.vector_norm(step, dim=1, keepdim=True)
        step = torch.where(norm > step_clip, step * (step_clip / norm), step)
        xa = x[active] - step
        f[active], g[active] = _mean_and_gradient(model, xa)
        x[active] = xa
    return x, f.abs() <= tol


def project_point(model, x0, *, max_iters: int = 20, tol: float = 1e-6,
                  step_clip: float = 0.25):
    """Newton-project one point (3,) onto f = 0, steps clipped to
    `step_clip`.  Returns (x_surf (3,), converged)."""
    x, ok = _project(model, torch.as_tensor(x0)[None, :], max_iters, tol, step_clip)
    return x[0], ok[0]


def project_points(model, seeds, *, max_iters: int = 20, tol: float = 1e-6):
    """Project (M, 3) seeds at once.  Returns (points (M, 3), converged (M,)
    bool): converged where |f| <= tol at the last point."""
    return _project(model, seeds, max_iters, tol, 0.25)


def surface_normals(model, points) -> torch.Tensor:
    """Outward unit normals at (M, 3) points: the normalized posterior-mean
    gradient (the field grows from -1 inside to +1 outside)."""
    points = torch.as_tensor(points).to(dtype=model.dtype, device=model.device)
    g = torch.cat([_gradient(model, p) for p in torch.split(points, _CHUNK)] or [points])
    return g / torch.clamp(torch.linalg.vector_norm(g, dim=1, keepdim=True), min=1e-12)
