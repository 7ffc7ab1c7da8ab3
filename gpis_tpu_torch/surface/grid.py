"""Dense query-grid posterior evaluation (port of gpis_tpu/surface/grid.py).

Queries stream through the posterior in chunks of `chunk=` (8,192) -- a
Python loop in place of the JAX package's `lax.map` -- so the staged kq of
one chunk (chunk x C) is the only query-sized buffer alive.  A value model (`GPModel`)
and a joint one (`DerivGPModel`) are served alike, through
`regression.predict`; so is a sharded one (`ShardedGPModel`), whose every
rank walks the same chunks.  An out-of-core model takes all the points in one
`outofcore.ooc_predict` call: its query chunks them itself and streams each
W panel once for all chunks, where a call per chunk would stream W per
chunk.  A committee (`ExpertGPModel`) takes all the points in one
`experts.predict(..., chunk=)` too, which gates each chunk to its nearest
experts.  `want_var=False` takes the posterior mean alone.
"""

from __future__ import annotations

import torch

from gpis_tpu_torch._build import resolve_device
from gpis_tpu_torch.gp import regression as gpr
from gpis_tpu_torch.gp.kinds import model_kind
from gpis_tpu_torch.gp.model import GPModel
from gpis_tpu_torch.linalg import outofcore as ooc

__all__ = ["CHUNK", "make_grid", "evaluate_points_chunked", "evaluate_grid"]

CHUNK = 8192  # queries per posterior call


def make_grid(resolution: int, extent: float, *, dtype=torch.float32, device="cuda"):
    """Cube grid of `resolution`^3 points over [-extent, extent]^3 in the
    normalized frame.  Returns (coords (R^3, 3), axis (R,))."""
    axis = torch.linspace(-extent, extent, resolution, dtype=dtype, device=resolve_device(device))
    gx, gy, gz = torch.meshgrid(axis, axis, axis, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1), gz.reshape(-1)], dim=1), axis


def evaluate_points_chunked(model: GPModel, q: torch.Tensor, *, chunk: int = CHUNK,
                            want_var: bool = True):
    """Posterior mean and variance at (M,3) points, `chunk` queries at a
    time.  want_var=False computes the mean alone and returns None for the
    variance, as the JAX package does."""
    if q.shape[0] == 0:
        return q.new_zeros((0,)), q.new_zeros((0,)) if want_var else None
    kind = model_kind(model)
    if kind == "experts":
        from gpis_tpu_torch.gp import experts as gpe

        mean, var = gpe.predict(model, q, chunk=chunk)
        return mean, var if want_var else None
    if kind in ("ooc", "ooc_joint"):
        if want_var:
            return ooc.ooc_predict(model, q, chunk=chunk)
        return ooc.ooc_predict_mean(model, q, chunk=chunk), None
    if not want_var:
        return torch.cat([gpr.predict_mean(model, q[i:i + chunk])
                          for i in range(0, q.shape[0], chunk)]), None
    means, variances = zip(*(gpr.predict(model, q[i:i + chunk])
                             for i in range(0, q.shape[0], chunk)))
    return torch.cat(means), torch.cat(variances)


def evaluate_grid(model: GPModel, resolution: int, extent: float, *, chunk: int = CHUNK,
                  want_var: bool = True):
    """Dense grid evaluation on the model's device.  Returns
    (mean (R,R,R), var (R,R,R) or None, axis (R,))."""
    coords, axis = make_grid(resolution, extent, dtype=model.dtype, device=model.device)
    mean, var = evaluate_points_chunked(model, coords, chunk=chunk, want_var=want_var)
    r = resolution
    return mean.reshape(r, r, r), None if var is None else var.reshape(r, r, r), axis
