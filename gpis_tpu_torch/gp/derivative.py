"""GP regression with derivative (surface-normal) observations (port of
gpis_tpu/gp/derivative.py), BASELINE config 2.

Surface normals are observations of grad f in a joint system of size
J = 4C + T: the values and three gradient components of C points,
dimension-major, plus T value-only tactile slots at the tail.  Padding rows
and empty touch slots sit at the origin with `pad_noise` on every slot, so
they stay inert, as in gp.model.

* `fit_with_normals` -- joint Gram (Kernel E) -> Cholesky (Kernel B) ->
  alpha, with the NaN-jitter ladder.
* `with_linv_joint` -- attach W = L^{-1} (Kernel C).
* `predict` -- posterior mean and variance of f; a model carrying W takes
  `cuda_joint.fused_joint_query` (Kernels E + D staged, or F on the fly).
* `predict_gradient` -- posterior mean of grad f: surface normals.
* `update_joint` -- tactile (value-only) points bordered into the touch
  slots: the factor's trailing rows [4C, J) re-formed (K21 through
  Kernel E), W carried through when attached.
"""

from __future__ import annotations

import dataclasses

import torch

from gpis_tpu_torch.gp.model import align_capacity, as_dtype, round_up
from gpis_tpu_torch.gp.regression import _LINV_BLOCK, _MAX_JITTER_RETRIES, _border, _float_params
from gpis_tpu_torch.kernels import cuda_joint
from gpis_tpu_torch.kernels import derivative as kd
from gpis_tpu_torch.kernels import functions as kf
from gpis_tpu_torch.kernels import gram as kg
from gpis_tpu_torch.linalg import cholesky as lin
from gpis_tpu_torch.linalg.cuda_chol import blocked_linv

__all__ = ["DerivGPModel", "fit_with_normals", "with_linv_joint", "joint_cross_value",
           "predict", "predict_gradient", "update_joint"]


@dataclasses.dataclass(frozen=True)
class DerivGPModel:
    """Exact GP with value and gradient observations on one device.
    Capacity C points -> joint system size J = 4C + T."""

    x: torch.Tensor  # (C, 3)
    y: torch.Tensor  # (C,) value targets
    normals: torch.Tensor  # (C, 3) gradient targets (zero rows where absent)
    noise_f: torch.Tensor  # (C,)
    noise_g: torch.Tensor  # (C,)
    params: dict  # {"lengthscale", "signal_variance"}, Python floats
    chol: torch.Tensor  # (J, J)
    alpha: torch.Tensor  # (J,)
    kernel: str
    n0: int
    # W = chol^{-1} (J, J): the dense-query variance path.
    linv: torch.Tensor | None = None
    # Value-only tactile slots at joint rows [4C, J); None when T = 0.
    touch_x: torch.Tensor | None = None  # (T, 3)
    touch_y: torch.Tensor | None = None  # (T,)
    touch_noise: torch.Tensor | None = None  # (T,)
    n_touch: int | None = None

    @property
    def capacity(self) -> int:
        return self.x.shape[0]

    @property
    def touch_capacity(self) -> int:
        return 0 if self.touch_x is None else self.touch_x.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.x.dtype

    @property
    def device(self) -> torch.device:
        return self.x.device

    @property
    def noise(self) -> torch.Tensor:
        """Value-observation noise (so callers treat both model types alike)."""
        return self.noise_f


def fit_with_normals(kernel: str, x, y, normals, noise_f, noise_g, params, *, block: int = 64,
                     touch_capacity: int = 0, pad_noise: float = 1e10, dtype=None,
                     max_jitter_retries: int = _MAX_JITTER_RETRIES) -> DerivGPModel:
    """Fit on (x, y, normals) in `dtype` (x's when None).  Normal
    observations follow the GPIS convention that grad f on the surface is
    the outward unit normal.  touch_capacity > 0 preallocates value-only
    tactile slots at the joint tail (origin points with pad noise, inert
    until an update writes them).  The capacity rule is the JAX package's,
    so both pad to the same J; the jitter ladder retries up to
    `max_jitter_retries` times, as `regression.fit`'s."""
    dtype, dev = as_dtype(dtype, x), x.device
    n = x.shape[0]
    c = round_up(n, block)
    t = round_up(touch_capacity, block) if touch_capacity else 0
    if 4 * c + t >= 4096:
        # C to a multiple of 256 (4C lands on 1024) and the touch tail grown
        # so J = 4C + T is 1024-aligned (gp.model.align_capacity).
        c = round_up(c, 256)
        if t:
            t = align_capacity(4 * c + t) - 4 * c

    def padded(v, fill, shape):
        out = torch.full(shape, fill, dtype=dtype, device=dev)
        out[:n] = torch.as_tensor(v, dtype=dtype, device=dev).broadcast_to((n,) + shape[1:])
        return out

    xp = padded(x, 0.0, (c, 3))
    yp = padded(y, 0.0, (c,))
    npf = padded(noise_f, pad_noise, (c,))
    npg = padded(noise_g, pad_noise, (c,))
    nrm = padded(normals, 0.0, (c, 3))
    params = _float_params(params)
    tx = torch.zeros((t, 3), dtype=dtype, device=dev) if t else None
    ty = torch.zeros((t,), dtype=dtype, device=dev) if t else None
    tn = torch.full((t,), pad_noise, dtype=dtype, device=dev) if t else None

    jitter0 = 4.0 * torch.finfo(dtype).eps * (4 * c + t) * abs(float(kf.k_diag0(kernel, params)))
    extra = 0.0
    for attempt in range(max_jitter_retries + 1):
        # The factor overwrites the Gram in place (lin.cholesky), so every
        # attempt assembles the whole (J, J) system anew.
        l = lin.cholesky(kd.joint_gram(kernel, xp, params, noise_f=npf + extra,
                                       noise_g=npg + extra, touch_x=tx,
                                       touch_noise=None if tn is None else tn + extra))
        if not bool(torch.isnan(l.diagonal()).any()):
            break
        del l  # only one J x J attempt is alive at a time
        extra = jitter0 * (10.0**attempt)
    else:
        raise FloatingPointError(f"joint Cholesky failed even with jitter {extra:.2e}")
    yj = kd.joint_targets(yp, nrm)
    if t:
        yj = torch.cat([yj, ty])
    return DerivGPModel(x=xp, y=yp, normals=nrm, noise_f=npf, noise_g=npg, params=params,
                        chol=l, alpha=lin.cho_solve(l, yj), kernel=kernel, n0=c,
                        touch_x=tx, touch_y=ty, touch_noise=tn, n_touch=0 if t else None)


def with_linv_joint(model: DerivGPModel, *, block: int = _LINV_BLOCK) -> DerivGPModel:
    """Attach W = chol^{-1} (left-looking blocked TRSM, Kernel C)."""
    j = model.chol.shape[0]
    return dataclasses.replace(model, linv=blocked_linv(model.chol, block if j % block == 0 else j))


def joint_cross_value(model: DerivGPModel, q: torch.Tensor) -> torch.Tensor:
    """cov(f(q), joint observations): (M, J), core columns then touch slots."""
    return cuda_joint.joint_cross_value(model.kernel, q, model.x, model.params, model.touch_x)


def predict(model: DerivGPModel, q: torch.Tensor):
    """Posterior (mean, variance) of f at q (M, 3).  With W attached the
    joint query runs (staged or on the fly by size); otherwise a triangular
    solve against the factor."""
    q = q.contiguous()
    k0 = kf.k_diag0(model.kernel, model.params)
    if model.linv is not None:
        mean, quad = cuda_joint.fused_joint_query(model.kernel, q, model.x, model.params,
                                                  model.alpha, model.linv, model.touch_x)
        return mean, k0 - quad
    kq = joint_cross_value(model, q)
    v = lin.solve_lower(model.chol, kq.T)
    return kq @ model.alpha, k0 - torch.sum(v * v, dim=0)


def predict_gradient(model: DerivGPModel, q: torch.Tensor) -> torch.Tensor:
    """Posterior mean of grad f at q: (M, 3), the surface normals."""
    m = q.shape[0]
    kq = kd.cross_cov_grad(model.kernel, q, model.x, model.params)  # (3M, 4C)
    if model.touch_x is not None:
        kq = torch.cat([kq, kd.cross_cov_grad_value(model.kernel, q, model.touch_x,
                                                    model.params)], dim=1)
    g = kq @ model.alpha
    return torch.stack([g[:m], g[m:2 * m], g[2 * m:]], dim=1)


def update_joint(model: DerivGPModel, new_x, new_y, new_noise) -> DerivGPModel:
    """Append tactile (value-only) points to a joint model's touch slots and
    re-form only the trailing factor rows [4C, J) by bordering, the joint
    mirror of `gp.regression.update`: K21 = cov(touch values, the 4C core
    observations) through Kernel E, K22 over the touch slots with their
    noise (floored at 4 eps J k(0)).  W, when attached, is carried through
    and alpha = W^T (W y) over the joint targets and then the touch
    targets.  A new model is returned; overflow raises."""
    if model.touch_x is None:
        raise ValueError(
            "model has no touch slots; fit with touch_capacity > 0 "
            "(or refit via the session, which falls back automatically)"
        )
    t = model.touch_capacity
    n4 = 4 * model.capacity
    dt, dev = model.dtype, model.device
    new_x = torch.as_tensor(new_x).to(dtype=dt, device=dev)
    k_new = new_x.shape[0]
    occ = int(model.n_touch)
    if occ + k_new > t:
        raise ValueError(f"cumulative touches {occ + k_new} exceed touch capacity {t}")
    new_y = torch.as_tensor(new_y, dtype=dt, device=dev).broadcast_to((k_new,))
    floor = 4.0 * torch.finfo(dt).eps * (n4 + t) * float(kf.k_diag0(model.kernel, model.params))
    new_noise = torch.clamp(torch.as_tensor(new_noise, dtype=dt, device=dev), min=floor)

    tx, ty, tn = model.touch_x.clone(), model.touch_y.clone(), model.touch_noise.clone()
    tx[occ:occ + k_new] = new_x
    ty[occ:occ + k_new] = new_y
    tn[occ:occ + k_new] = new_noise.broadcast_to((k_new,))

    k21 = kd.cross_cov_value(model.kernel, tx, model.x, model.params)  # (T, 4C)
    k22 = kg.gram_reference(model.kernel, tx, model.params, noise=tn)
    yj = torch.cat([kd.joint_targets(model.y, model.normals), ty])
    chol, linv, alpha = _border(model.chol, model.linv, k21, k22, yj)
    return dataclasses.replace(model, chol=chol, alpha=alpha, linv=linv, touch_x=tx,
                               touch_y=ty, touch_noise=tn, n_touch=occ + k_new)
