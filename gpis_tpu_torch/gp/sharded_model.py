"""Sharded GP model, config 5 behind the session API (port of
gpis_tpu/gp/sharded_model.py).

`fit_sharded` runs the row-sharded pipeline of `linalg.sharded` on a row
mesh (one process per rank): band Gram -> distributed blocked Cholesky,
with the jitter ladder -> W = L^{-1} -> alpha.  The `ShardedGPModel` it
returns holds this rank's bands of L and W and the replicated small state
(coordinates, targets, noise, alpha).  Every rank calls `predict` with the
same queries and gets the whole answer back; `update` borders tactile
points into touch slots of the last rank's band (`sharded_update_tail`).
"""

from __future__ import annotations

import dataclasses

import torch

from gpis_tpu_torch.gp.model import as_dtype, round_up
from gpis_tpu_torch.kernels import functions as kf
from gpis_tpu_torch.linalg import sharded as sh
from gpis_tpu_torch.parallel.mesh import RowMesh, make_row_mesh
from gpis_tpu_torch.utils import profiling

__all__ = ["ShardedGPModel", "fit_sharded"]


@dataclasses.dataclass
class ShardedGPModel:
    """This rank's part of a sharded exact GP: l and w are its (C / P, C)
    row bands; the rest is replicated.  `params` holds Python floats."""

    kernel: str
    x: torch.Tensor  # (C, 3)
    y: torch.Tensor  # (C,)
    noise: torch.Tensor  # (C,)
    params: dict
    l: torch.Tensor  # (C / P, C) band of the Cholesky factor
    w: torch.Tensor  # (C / P, C) band of L^{-1}
    alpha: torch.Tensor  # (C,)
    mesh: RowMesh
    block: int
    n0: int
    n_touch: int = 0
    n_real: int = 0  # real (non-padding) training rows of the fit

    @property
    def capacity(self) -> int:
        return self.x.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.x.dtype

    @property
    def device(self) -> torch.device:
        return self.x.device

    def update(self, new_x, new_y, new_noise) -> "ShardedGPModel":
        """Write tactile points into the touch slots, which begin after the
        real rows but never before the last rank's band, and re-form that
        band alone (`sharded_update_tail`).  Every rank passes the same
        points; the noise is floored at 4 eps C k(0).  Returns a new
        model."""
        c, dt, dev = self.capacity, self.dtype, self.device
        band = c // self.mesh.size
        rest = c - band
        new_x = torch.as_tensor(new_x).to(dtype=dt, device=dev)
        k_new = new_x.shape[0]
        start = max(self.n_real, rest) + self.n_touch
        if start + k_new > c:
            raise ValueError(
                f"touch batch {k_new} exceeds remaining tail-band capacity "
                f"{c - start} (band size {band})"
            )
        floor = 4.0 * torch.finfo(dt).eps * c * abs(float(kf.k_diag0(self.kernel, self.params)))
        x, y, noise = self.x.clone(), self.y.clone(), self.noise.clone()
        x[start:start + k_new] = new_x
        y[start:start + k_new] = torch.as_tensor(new_y, dtype=dt, device=dev)
        noise[start:start + k_new] = torch.clamp(
            torch.as_tensor(new_noise, dtype=dt, device=dev).broadcast_to((k_new,)), min=floor)
        l_new, w_new = sh.sharded_update_tail(self.kernel, self.params, x, noise, self.l, self.w,
                                              self.mesh)
        alpha = sh.sharded_alpha_from_linv(w_new, y, self.mesh)
        return dataclasses.replace(self, x=x, y=y, noise=noise, l=l_new, w=w_new, alpha=alpha,
                                   n_touch=self.n_touch + k_new)

    def predict(self, q: torch.Tensor, *, precision=None):
        """Posterior (mean, variance) at q (M, 3), the same on every rank:
        q is padded to a multiple of P, each rank answers its shard, and an
        all-gather joins the shards.  precision other than None takes the
        exact FP32 plain products (`sharded_predict_linv`; slow)."""
        m, p = q.shape[0], self.mesh.size
        pad = (-m) % p
        qp = torch.cat([q, q.new_zeros((pad, 3))]) if pad else q
        mean, var = sh.sharded_predict_linv(self.kernel, qp.contiguous(), self.x, self.params,
                                            self.alpha, self.w, self.mesh,
                                            precision=precision)
        return _all_gather(mean, p)[:m], _all_gather(var, p)[:m]


def _all_gather(t: torch.Tensor, p: int) -> torch.Tensor:
    return torch.cat(sh._all_gather(t, p))


def _capacity(n: int, touch_capacity: int, p: int, block: int) -> int:
    """A multiple of P x block with the touch slots inside the last rank's
    band (where the bordering update refactors), the JAX package's rule."""
    c = round_up(n + touch_capacity, p * block)
    while c - max(n, c - c // p) < touch_capacity:
        c += p * block
    return c


def fit_sharded(kernel: str, x, y, noise, params, mesh: RowMesh | None = None, *,
                n_devices: int | None = None, block: int = 256, touch_capacity: int = 0,
                pad_noise: float = 1e10, dtype=None,
                jitter: float | None = None) -> ShardedGPModel:
    """Distributed fit on `mesh` (or a row mesh of n_devices ranks on the
    device of x, when x is a tensor, else on CUDA), in `dtype` (x's when
    None): every rank passes the same x (N, 3), y (N,) and noise (scalar or
    (N,)).  The ladder tries the fit without jitter first, then with 1, 100
    and 1e4 x `jitter` (default 4 eps C k(0)) on the diagonal while the
    factor's diagonal has a NaN on any rank.  On CUDA the factor's panel
    updates run through Kernel G, the counterpart of the JAX package's
    Pallas panel kernel on the TPU; W's trailing update takes its plain
    product, as the JAX package's does."""
    mesh = mesh or make_row_mesh(n_devices, x.device if torch.is_tensor(x) else "cuda")
    x = torch.as_tensor(x, device=mesh.device)
    dt, dev, p = as_dtype(dtype, x), mesh.device, mesh.size
    n = x.shape[0]
    c = _capacity(n, touch_capacity, p, block)
    xp = torch.zeros((c, 3), dtype=dt, device=dev)
    xp[:n] = x.to(dt)
    yp = torch.zeros((c,), dtype=dt, device=dev)
    yp[:n] = torch.as_tensor(y, dtype=dt, device=dev)
    noisep = torch.full((c,), pad_noise, dtype=dt, device=dev)
    noisep[:n] = torch.as_tensor(noise, dtype=dt, device=dev).broadcast_to((n,))
    params = {k: float(v) for k, v in params.items()}
    if jitter is None:
        jitter = 4.0 * torch.finfo(dt).eps * c * abs(float(kf.k_diag0(kernel, params)))
    for extra in (0.0, jitter, jitter * 100.0, jitter * 1e4):
        profiling.count("fit.attempts")
        a = sh.sharded_gram(kernel, xp, params, noisep + extra, mesh)
        l = sh.sharded_cholesky(a, mesh, block=block)
        if not sh.any_nan_diagonal(l, mesh):
            noisep = noisep + extra
            break
        del a, l
    else:
        raise FloatingPointError("sharded Cholesky failed even with jitter")
    w = sh.sharded_linv(l, mesh, block=block)
    alpha = sh.sharded_alpha_from_linv(w, yp, mesh)
    return ShardedGPModel(kernel=kernel, x=xp, y=yp, noise=noisep, params=params, l=l, w=w,
                          alpha=alpha, mesh=mesh, block=block, n0=c, n_real=n)
