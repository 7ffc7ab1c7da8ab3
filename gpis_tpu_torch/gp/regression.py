"""Exact GP regression (port of gpis_tpu/gp/regression.py:50-293, 296-378).

* ``fit`` / ``fit_padded`` -- Gram, Cholesky, alpha, with the NaN-jitter
  ladder.
* ``fit_inference`` -- the one-matrix-peak pipeline of query-only sessions:
  Gram (Kernel A) -> in-place blocked Cholesky (Kernel B) -> in-place
  W = L^{-1} (Kernel C) -> alpha = W^T (W y).
* ``with_linv`` -- attach W = L^{-1} (Kernel C) to a fitted model.
* ``predict`` / ``predict_mean`` -- posterior mean and variance; a model
  carrying W goes through the dense query (Kernels A and D staged, or
  Kernel F on the fly); a joint model is dispatched to ``gp.derivative``,
  an out-of-core one to ``linalg.outofcore`` and a sharded one to its own
  ``predict`` through ``gp.kinds.model_kind``.

Functions take tensors and work on the device the tensors are on.  The
ladder reacts only to a NaN factor diagonal (what `cholesky` returns for a
matrix that is not positive definite); a kernel failure raises through it.
"""

from __future__ import annotations

import dataclasses

import torch

from gpis_tpu_torch.gp.kinds import model_kind
from gpis_tpu_torch.gp.model import GPModel, align_capacity, round_up
from gpis_tpu_torch.kernels import functions as kf
from gpis_tpu_torch.kernels import gram as kg
from gpis_tpu_torch.kernels.cuda_query import fused_query
from gpis_tpu_torch.linalg import cholesky as lin
from gpis_tpu_torch.linalg import outofcore as ooc
from gpis_tpu_torch.linalg.cuda_chol import blocked_linv

__all__ = ["fit", "fit_padded", "fit_inference", "with_linv", "predict", "predict_mean"]

_LINV_BLOCK = 256
_MAX_JITTER_RETRIES = 6


def _float_params(params) -> dict:
    return {k: float(v) for k, v in params.items()}


def _pad_training(x, y, noise, capacity: int, pad_noise: float):
    """Pad to `capacity` with origin points, zero targets and `pad_noise`
    (see gp.model for why that is exact), in x's dtype."""
    n, dev, dtype = x.shape[0], x.device, x.dtype
    xp = torch.zeros((capacity, 3), dtype=dtype, device=dev)
    xp[:n] = x
    yp = torch.zeros((capacity,), dtype=dtype, device=dev)
    yp[:n] = y
    noisep = torch.full((capacity,), pad_noise, dtype=dtype, device=dev)
    noisep[:n] = torch.as_tensor(noise, dtype=dtype, device=dev).broadcast_to((n,))
    return xp, yp, noisep


def _has_nan_diagonal(l: torch.Tensor) -> bool:
    return bool(torch.isnan(l.diagonal()).any())


def _first_jitter(kernel, params, dtype, capacity: int) -> float:
    """4 eps n k(0): the first rung of the ladder (the JAX package's rule)."""
    return 4.0 * torch.finfo(dtype).eps * capacity * abs(float(kf.k_diag0(kernel, params)))


def fit(kernel: str, x, y, noise, params, *, block: int = 128, touch_capacity: int = 256,
        pad_noise: float = 1e10) -> GPModel:
    """GPModel from (x, y, per-point noise) in x's dtype: pad to capacity,
    then `fit_padded`, retrying with escalating diagonal jitter while the
    factor comes back NaN (f32 Grams of dense clouds with tiny noise are
    numerically indefinite)."""
    n0 = round_up(x.shape[0], block)
    capacity = align_capacity(n0 + round_up(touch_capacity, block))
    xp, yp, noisep = _pad_training(x, y, noise, capacity, pad_noise)
    jitter = _first_jitter(kernel, params, x.dtype, capacity)
    extra = 0.0
    for attempt in range(_MAX_JITTER_RETRIES + 1):
        model = fit_padded(kernel, xp, yp, noisep + extra, params, n0=n0, pad_noise=pad_noise)
        if not _has_nan_diagonal(model.chol):
            return model
        extra = jitter * (10.0**attempt)
    raise FloatingPointError(
        f"Cholesky failed even with jitter {extra:.2e}; the Gram matrix is "
        f"numerically indefinite (try larger noise or float64)"
    )


def fit_padded(kernel: str, xp, yp, noisep, params, *, n0: int,
               pad_noise: float = 1e10) -> GPModel:
    """Fit on already-padded capacity-C arrays."""
    params = _float_params(params)
    l = lin.cholesky(kg.gram(kernel, xp, params, noise=noisep))
    return GPModel(x=xp, y=yp, noise=noisep, params=params, chol=l,
                   alpha=lin.cho_solve(l, yp), n_touch=0, kernel=kernel, n0=n0,
                   pad_noise=pad_noise)


def fit_inference(kernel: str, x, y, noise, params, *, block: int = 128,
                  pad_noise: float = 1e10) -> GPModel:
    """Memory-lean fit for query-only workloads, in x's dtype: peak device
    memory is ONE capacity x capacity matrix.  Gram -> in-place factorization
    -> in-place W = L^{-1} -> alpha = W^T (W y).  The model's `chol` IS W, so
    it serves queries only.  Capacities that are not a multiple of 256 take
    `fit` + `with_linv` instead, as in the JAX package."""
    params = _float_params(params)
    n0 = align_capacity(round_up(x.shape[0], block))
    if n0 % _LINV_BLOCK:
        m = fit(kernel, x, y, noise, params, block=block, touch_capacity=0, pad_noise=pad_noise)
        return with_linv(m)
    xp, yp, noisep = _pad_training(x, y, noise, n0, pad_noise)
    jitter = _first_jitter(kernel, params, x.dtype, n0)
    extra = 0.0
    for attempt in range(_MAX_JITTER_RETRIES + 1):
        l = lin.cholesky(kg.gram(kernel, xp, params, noise=noisep + extra))
        if not _has_nan_diagonal(l):
            break
        del l  # only one C x C attempt is alive at a time
        extra = jitter * (10.0**attempt)
    else:
        raise FloatingPointError(f"Cholesky failed even with jitter {extra:.2e} (fit_inference)")
    w = blocked_linv(l, _LINV_BLOCK, inplace=True)
    del l
    alpha = w.T @ (w @ yp)
    return GPModel(x=xp, y=yp, noise=noisep + extra, params=params, chol=w, alpha=alpha,
                   n_touch=0, kernel=kernel, n0=n0, pad_noise=pad_noise, linv=w)


def with_linv(model: GPModel, *, block: int = _LINV_BLOCK) -> GPModel:
    """Attach W = L^{-1} (left-looking blocked TRSM, Kernel C) -- the
    dense-grid variance path."""
    c = model.capacity
    b = block if c % block == 0 else c
    return dataclasses.replace(model, linv=blocked_linv(model.chol, b))


def predict(model, q: torch.Tensor):
    """Posterior (mean, variance) at queries q (M,3).

    mean = K* alpha;  var = k(0) - |W K*^T|^2 column-wise with W = L^{-1}.
    A model carrying W runs the dense query (`cuda_query.fused_query`:
    Kernels A then D, or Kernel F when the staged kq would be too big); one
    carrying Kinv takes var = k(0) - sum(K* * (K* Kinv)); otherwise the
    triangular solve against the factor.  A joint model (`DerivGPModel`)
    goes to `gp.derivative.predict`, an out-of-core one to
    `outofcore.ooc_predict`, which streams each W panel once for all of q,
    and a sharded one (`gp.sharded_model`) to its `predict`, which every
    rank calls with the same q.
    The variance is not clamped (the conditionally-PD thin plate
    legitimately goes negative), except by the out-of-core query, which
    clamps it to [0, k0] as the JAX package does."""
    kind = model_kind(model)
    if kind in ("ooc", "ooc_joint"):
        return ooc.ooc_predict(model, q)
    if kind == "sharded":
        return model.predict(q)
    if kind == "joint":
        from gpis_tpu_torch.gp import derivative as gpd

        return gpd.predict(model, q)
    q = q.contiguous()
    k0 = kf.k_diag0(model.kernel, model.params)
    if model.linv is not None:
        mean, quad = fused_query(model.kernel, q, model.x, model.params, model.alpha,
                                 model.linv)
        return mean, k0 - quad
    kq = kg.cross_cov(model.kernel, q, model.x, model.params)  # (M, C)
    mean = kq @ model.alpha
    if model.kinv is not None:
        quad = torch.sum(kq * (kq @ model.kinv), dim=1)
    else:
        v = lin.solve_lower(model.chol, kq.T)
        quad = torch.sum(v * v, dim=0)
    return mean, k0 - quad


def predict_mean(model, q: torch.Tensor) -> torch.Tensor:
    """Posterior mean only; a joint model's cross-covariance mirrors alpha's
    layout [4C value + gradient columns | T touch columns]."""
    kind = model_kind(model)
    if kind in ("ooc", "ooc_joint"):
        return ooc.ooc_predict_mean(model, q)
    if kind == "joint":
        from gpis_tpu_torch.gp import derivative as gpd

        return gpd.joint_cross_value(model, q.contiguous()) @ model.alpha
    return kg.cross_cov(model.kernel, q.contiguous(), model.x, model.params) @ model.alpha
