"""Dense query-grid posterior evaluation (port of gpis_tpu/surface/grid.py).

Queries stream through the posterior in chunks of 8,192 -- a Python loop in
place of the JAX package's `lax.map` -- so the staged kq of one chunk
(chunk x C) is the only query-sized buffer alive.  A value model (`GPModel`)
and a joint one (`DerivGPModel`) are served alike, through
`regression.predict`; so is a sharded one (`ShardedGPModel`), whose every
rank walks the same chunks.  An out-of-core model takes all the points in one
`regression.predict` call: its query chunks them itself and streams each W
panel once for all chunks, where a call per chunk would stream W per chunk.
"""

from __future__ import annotations

import torch

from gpis_tpu_torch._build import resolve_device
from gpis_tpu_torch.gp import regression as gpr
from gpis_tpu_torch.gp.kinds import model_kind
from gpis_tpu_torch.gp.model import GPModel

__all__ = ["CHUNK", "make_grid", "evaluate_points_chunked", "evaluate_grid"]

CHUNK = 8192  # queries per posterior call


def make_grid(resolution: int, extent: float, *, dtype=torch.float32, device="cuda"):
    """Cube grid of `resolution`^3 points over [-extent, extent]^3 in the
    normalized frame.  Returns (coords (R^3, 3), axis (R,))."""
    axis = torch.linspace(-extent, extent, resolution, dtype=dtype, device=resolve_device(device))
    gx, gy, gz = torch.meshgrid(axis, axis, axis, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1), gz.reshape(-1)], dim=1), axis


def evaluate_points_chunked(model: GPModel, q: torch.Tensor):
    """Posterior (mean, variance) at (M,3) points, CHUNK queries at a time."""
    if q.shape[0] == 0:
        return q.new_zeros((0,)), q.new_zeros((0,))
    if model_kind(model) in ("ooc", "ooc_joint"):
        return gpr.predict(model, q)
    means, variances = zip(*(gpr.predict(model, q[i:i + CHUNK])
                             for i in range(0, q.shape[0], CHUNK)))
    return torch.cat(means), torch.cat(variances)


def evaluate_grid(model: GPModel, resolution: int, extent: float):
    """Dense grid evaluation on the model's device.  Returns
    (mean (R,R,R), var (R,R,R), axis (R,))."""
    coords, axis = make_grid(resolution, extent, dtype=model.dtype, device=model.device)
    mean, var = evaluate_points_chunked(model, coords)
    r = resolution
    return mean.reshape(r, r, r), var.reshape(r, r, r), axis
