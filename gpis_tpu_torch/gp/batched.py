"""Batched multi-object fitting, the data-parallel axis (port of
gpis_tpu/gp/batched.py).

B objects share one capacity C (shorter clouds ride the padding rows) and
are fitted one after another by `regression.fit_padded` (Kernel A's Gram,
the port's factor) into stacked (B, ...) tensors: a loop where the JAX
package vmaps, since torch.vmap cannot pass through the CUDA kernels.
With `mesh=` each rank of a `torch.distributed` group fits only its
contiguous share of the objects, as the JAX package's `NamedSharding`
leaves each device its shard; there is no collective.
"""

from __future__ import annotations

import dataclasses

import torch

from gpis_tpu_torch.gp import regression as gpr
from gpis_tpu_torch.gp.model import GPModel, as_dtype, round_up

__all__ = ["fit_batch", "predict_batch"]


def fit_batch(kernel, clouds, ys, noises, params, *, block: int = 128,
              pad_noise: float = 1e10, dtype=torch.float32, mesh=None,
              axis: str = "row") -> GPModel:
    """Fit B objects: clouds is a list of (N_b, 3) arrays (ragged: each is
    padded to the shared capacity round_up(max N_b, block)), ys and noises
    matching lists of arrays or scalars.  Returns a GPModel whose tensors
    carry a leading object axis (`params` shared, `n_touch` 0): object b is
    `dataclasses.replace(model, x=model.x[b], ...)`, which `predict_batch`
    takes apart.  With mesh (`parallel.mesh.RowMesh`), this rank's share of
    the objects only, on its device (B must divide by the group's size).
    `axis` names the JAX mesh axis; the process group has none."""
    del axis
    b = len(clouds)
    cap = round_up(max(len(c) for c in clouds), block)
    objects = range(b)
    if mesh is not None:
        row0, rows = mesh.band(b)
        objects = range(row0, row0 + rows)
    fits = []
    for i in objects:
        x = torch.as_tensor(clouds[i])
        dt = as_dtype(dtype, x)
        x = x.to(dtype=dt, device=x.device if mesh is None else mesh.device)
        n = x.shape[0]
        y = torch.as_tensor(ys[i]).to(dtype=dt, device=x.device).broadcast_to((n,))
        nz = torch.as_tensor(noises[i]).to(dtype=dt, device=x.device).broadcast_to((n,))
        xp, yp, np_ = gpr.pad_training(x, y, nz, cap, pad_noise, dt)
        fits.append(gpr.fit_padded(kernel, xp, yp, np_, params, n0=cap, pad_noise=pad_noise))
    first = fits[0]
    return dataclasses.replace(first, **{k: torch.stack([getattr(f, k) for f in fits])
                                         for k in ("x", "y", "noise", "chol", "alpha")})


def predict_batch(batch_model: GPModel, q):
    """Posterior (mean, variance) of every object at shared queries q
    (M, 3): two (B, M) tensors."""
    q = torch.as_tensor(q).to(dtype=batch_model.dtype, device=batch_model.device)
    out = [gpr.predict(dataclasses.replace(batch_model, x=batch_model.x[b], y=batch_model.y[b],
                                           noise=batch_model.noise[b],
                                           chol=batch_model.chol[b],
                                           alpha=batch_model.alpha[b]), q)
           for b in range(batch_model.x.shape[0])]
    return torch.stack([m for m, _ in out]), torch.stack([v for _, v in out])
