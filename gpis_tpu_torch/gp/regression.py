"""Exact GP regression (port of gpis_tpu/gp/regression.py:50-503).

* ``fit`` / ``fit_padded`` -- Gram, Cholesky, alpha, with the NaN-jitter
  ladder.
* ``fit_inference`` -- the one-matrix-peak pipeline of query-only sessions:
  Gram (Kernel A) -> in-place blocked Cholesky (Kernel B) -> in-place
  W = L^{-1} (Kernel C) -> alpha = W^T (W y).
* ``with_linv`` -- attach W = L^{-1} (Kernel C) to a fitted model;
  ``with_inverse`` -- attach (K + diag(noise))^{-1}.
* ``predict`` / ``predict_mean`` -- posterior mean and variance; a model
  carrying W goes through the dense query (Kernels A and D staged, or
  Kernel F on the fly); a joint model is dispatched to ``gp.derivative``,
  an out-of-core one to ``linalg.outofcore`` and a sharded one to its own
  ``predict`` through ``gp.kinds.model_kind``.
* ``update`` / ``reset_touches`` -- tactile points written into the touch
  slots [n0, C) and the factor's trailing rows re-formed by bordering
  (K21 through Kernel A), carrying W through when the model has it.
* ``log_marginal_likelihood`` -- the config-3 objective, differentiable by
  torch.autograd: the Gram is `kernels.gram.gram_ad` (Kernel A as its
  primal), the factor `linalg.cholesky.blocked_cholesky_ad` (Kernel B) at
  C >= 4096 on a card, the library's differentiable factor otherwise.

Functions take tensors and work on the device the tensors are on.  The
ladder reacts only to a NaN factor diagonal (what `cholesky` returns for a
matrix that is not positive definite); a kernel failure raises through it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch

from gpis_tpu_torch.gp.kinds import model_kind
from gpis_tpu_torch.gp.model import GPModel, align_capacity, as_dtype, round_up
from gpis_tpu_torch.kernels import functions as kf
from gpis_tpu_torch.kernels import gram as kg
from gpis_tpu_torch.kernels.cuda_query import exact_fp32, fused_query, staged_quad_reference
from gpis_tpu_torch.linalg import cholesky as lin
from gpis_tpu_torch.linalg import outofcore as ooc
from gpis_tpu_torch.linalg.cuda_chol import blocked_linv

__all__ = ["fit", "fit_padded", "fit_inference", "with_inverse", "with_linv", "predict",
           "predict_mean", "update", "reset_touches", "log_marginal_likelihood"]

_LINV_BLOCK = 256
_MAX_JITTER_RETRIES = 6


def _float_params(params) -> dict:
    return {k: float(v) for k, v in params.items()}


def _pad_training(x, y, noise, capacity: int, pad_noise: float, dtype=None):
    """Pad to `capacity` with origin points, zero targets and `pad_noise`
    (see gp.model for why that is exact), in `dtype` (x's when None)."""
    n, dev = x.shape[0], x.device
    dtype = dtype or x.dtype
    xp = torch.zeros((capacity, 3), dtype=dtype, device=dev)
    xp[:n] = x
    yp = torch.zeros((capacity,), dtype=dtype, device=dev)
    yp[:n] = torch.as_tensor(y, dtype=dtype, device=dev)
    noisep = torch.full((capacity,), pad_noise, dtype=dtype, device=dev)
    noisep[:n] = torch.as_tensor(noise, dtype=dtype, device=dev).broadcast_to((n,))
    return xp, yp, noisep


def _has_nan_diagonal(l: torch.Tensor) -> bool:
    return bool(torch.isnan(l.diagonal()).any())


def _first_jitter(kernel, params, dtype, capacity: int) -> float:
    """4 eps n k(0): the first rung of the ladder (the JAX package's rule)."""
    return 4.0 * torch.finfo(dtype).eps * capacity * abs(float(kf.k_diag0(kernel, params)))


def fit(kernel: str, x, y, noise, params, *, block: int = 128, touch_capacity: int = 256,
        pad_noise: float = 1e10, dtype=None, chol_impl=lin.cholesky,
        max_jitter_retries: int = _MAX_JITTER_RETRIES) -> GPModel:
    """GPModel from (x, y, per-point noise) in `dtype` (x's when None): pad
    to capacity, then `fit_padded` (the factor by `chol_impl`), retrying up
    to `max_jitter_retries` times with escalating diagonal jitter while the
    factor comes back NaN (f32 Grams of dense clouds with tiny noise are
    numerically indefinite)."""
    dtype = as_dtype(dtype, x)
    n0 = round_up(x.shape[0], block)
    capacity = align_capacity(n0 + round_up(touch_capacity, block))
    xp, yp, noisep = _pad_training(x, y, noise, capacity, pad_noise, dtype)
    jitter = _first_jitter(kernel, params, dtype, capacity)
    extra = 0.0
    for attempt in range(max_jitter_retries + 1):
        model = fit_padded(kernel, xp, yp, noisep + extra, params, n0=n0, chol_impl=chol_impl,
                           pad_noise=pad_noise)
        if not _has_nan_diagonal(model.chol):
            return model
        extra = jitter * (10.0**attempt)
    raise FloatingPointError(
        f"Cholesky failed even with jitter {extra:.2e}; the Gram matrix is "
        f"numerically indefinite (try larger noise or float64)"
    )


def fit_padded(kernel: str, xp, yp, noisep, params, *, n0: int, chol_impl=lin.cholesky,
               pad_noise: float = 1e10) -> GPModel:
    """Fit on already-padded capacity-C arrays.  `chol_impl` factors the
    (C, C) Gram into its lower Cholesky factor: the port's own blocked
    factor by default (it may overwrite its argument), or any torch
    callable of the same contract, which marks a failure with NaN on the
    diagonal for the ladder of `fit`."""
    params = _float_params(params)
    l = chol_impl(kg.gram(kernel, xp, params, noise=noisep))
    return GPModel(x=xp, y=yp, noise=noisep, params=params, chol=l,
                   alpha=lin.cho_solve(l, yp), n_touch=0, kernel=kernel, n0=n0,
                   pad_noise=pad_noise)


def fit_inference(kernel: str, x, y, noise, params, *, block: int = 128,
                  pad_noise: float = 1e10, dtype=None,
                  max_jitter_retries: int = _MAX_JITTER_RETRIES) -> GPModel:
    """Memory-lean fit for query-only workloads, in `dtype` (x's when None):
    peak device memory is ONE capacity x capacity matrix.  Gram -> in-place
    factorization -> in-place W = L^{-1} -> alpha = W^T (W y).  The model's
    `chol` IS W, so it serves queries only.  Capacities that are not a
    multiple of 256 take `fit` + `with_linv` instead, as in the JAX
    package."""
    params = _float_params(params)
    dtype = as_dtype(dtype, x)
    n0 = align_capacity(round_up(x.shape[0], block))
    if n0 % _LINV_BLOCK:
        m = fit(kernel, x, y, noise, params, block=block, touch_capacity=0, pad_noise=pad_noise,
                dtype=dtype, max_jitter_retries=max_jitter_retries)
        return with_linv(m)
    xp, yp, noisep = _pad_training(x, y, noise, n0, pad_noise, dtype)
    jitter = _first_jitter(kernel, params, dtype, n0)
    extra = 0.0
    for attempt in range(max_jitter_retries + 1):
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


def with_inverse(model: GPModel) -> GPModel:
    """Attach (K + diag(noise))^{-1} = cho_solve(L, I), the two-GEMM variance
    path of `predict`."""
    eye = torch.eye(model.capacity, dtype=model.dtype, device=model.device)
    return dataclasses.replace(model, kinv=lin.cho_solve(model.chol, eye))


def with_linv(model: GPModel, *, block: int = _LINV_BLOCK) -> GPModel:
    """Attach W = L^{-1} (left-looking blocked TRSM, Kernel C) -- the
    dense-grid variance path."""
    c = model.capacity
    b = block if c % block == 0 else c
    return dataclasses.replace(model, linv=blocked_linv(model.chol, b))


def predict(model, q: torch.Tensor, *, precision=None):
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
    precision=None takes those routes.  For a dense value model, any other
    value (the JAX package passes `jax.lax.Precision.HIGHEST`; any non-None
    value is read the same way) computes the mean and the quad as plain
    PyTorch products in exact FP32 (`cuda_query.exact_fp32`), with no
    split-TF32 tile: kq is staged and W kq^T materialized, so this route is
    slow and memory-hungry, for checking the fast one.  As in the JAX
    package, the joint, out-of-core and sharded models ignore it here
    (`ShardedGPModel.predict` takes its own).
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
    # A registered kernel has no CUDA body: it takes the staged plain route.
    if model.linv is not None and precision is None and model.kernel in kf.KERNEL_NAMES:
        mean, quad = fused_query(model.kernel, q, model.x, model.params, model.alpha,
                                 model.linv)
        return mean, k0 - quad
    kq = kg.cross_cov(model.kernel, q, model.x, model.params)  # (M, C)
    with exact_fp32() if precision is not None else contextlib.nullcontext():
        if model.linv is not None:
            mean, quad = staged_quad_reference(kq, model.linv, model.alpha)
            return mean, k0 - quad
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


def update(model: GPModel, new_x, new_y, new_noise) -> GPModel:
    """Append tactile points to the touch slots and re-form only the
    trailing factor rows [n0, C) by bordering:

        L21 = K21 W11^T  (W attached)  or  (L11^{-1} K12)^T,
        L22 = chol(K22 - L21 L21^T);

    rows [0, n0) of K and of L are untouched.  With W attached it is
    carried through, W21 = -L22^{-1} L21 W11, W22 = L22^{-1}, W's block
    [:n0, n0:] zeroed, and alpha = W^T (W y); else alpha = cho_solve.  The
    products are exact FP32 (TF32 off), the JAX package's HIGHEST ones.
    new_y may be a scalar; the noise is floored at 4 eps C k(0).  A new
    model is returned and the caller's tensors are left as they were.  A
    batch larger than the slots, or one that would overflow them, raises:
    the occupancy `n_touch` is a host int here, so the JAX package's
    traced-occupancy NaN poison has no case.  A `fit_inference` model has
    no slots (its `chol` is W) and so raises before its factor is read."""
    c, n0 = model.capacity, model.n0
    t = c - n0
    dt, dev = model.dtype, model.device
    new_x = torch.as_tensor(new_x).to(dtype=dt, device=dev)
    k_new = new_x.shape[0]
    if k_new > t:
        raise ValueError(f"touch batch {k_new} exceeds touch capacity {t}")
    new_y = torch.as_tensor(new_y, dtype=dt, device=dev).broadcast_to((k_new,))
    total = model.n_touch + k_new
    if total > t:
        raise ValueError(
            f"cumulative touches {total} exceed touch capacity {t}; "
            f"refit with a larger touch_capacity (session.start does this)"
        )
    # Dtype-aware floor (as the fit's jitter): in float32 a touch noise of
    # 1e-6 can make the trailing block indefinite.
    floor = 4.0 * torch.finfo(dt).eps * c * float(kf.k_diag0(model.kernel, model.params))
    new_noise = torch.clamp(torch.as_tensor(new_noise, dtype=dt, device=dev), min=floor)

    start = n0 + model.n_touch
    x, y, noise = model.x.clone(), model.y.clone(), model.noise.clone()
    x[start:start + k_new] = new_x
    y[start:start + k_new] = new_y
    noise[start:start + k_new] = new_noise.broadcast_to((k_new,))

    xt = x[n0:]
    k21 = kg.cross_cov(model.kernel, xt, x[:n0], model.params)  # (T, n0)
    k22 = kg.gram(model.kernel, xt, model.params, noise=noise[n0:])  # (T, T)
    chol, linv, alpha = _border(model.chol, model.linv, k21, k22, y)
    return GPModel(x=x, y=y, noise=noise, params=model.params, chol=chol, alpha=alpha,
                   n_touch=total, kernel=model.kernel, n0=n0, pad_noise=model.pad_noise,
                   linv=linv)


def _border(chol, linv, k21, k22, y):
    """The bordering of `update` and `update_joint`: new copies of the
    factor and of W (when given) with their trailing rows [n, J) re-formed
    from K21 (T, n) and K22 (T, T), and alpha for the targets y (J,)."""
    n = k21.shape[1]
    if linv is not None:
        w11 = linv[:n, :n]
        l21 = k21 @ w11.T  # a GEMM in place of an n-wide triangular solve
    else:
        l21 = lin.solve_lower(chol[:n, :n], k21.T).T
    l22 = lin.cholesky(k22 - l21 @ l21.T)
    chol = chol.clone()
    chol[n:, :n] = l21
    chol[n:, n:] = l22
    if linv is None:
        return chol, None, lin.cho_solve(chol, y)
    linv = linv.clone()
    linv[n:, :n] = -torch.linalg.solve_triangular(l22, l21 @ w11, upper=False)
    linv[n:, n:] = torch.linalg.solve_triangular(
        l22, torch.eye(l22.shape[0], dtype=l22.dtype, device=l22.device), upper=False)
    linv[:n, n:] = 0.0
    return chol, linv, linv.T @ (linv @ y)


def reset_touches(model: GPModel) -> GPModel:
    """Clear every touch slot back to padding: origin points, zero targets
    and the fit's `pad_noise` (not max(noise), which once every slot holds a
    touch is a real observation's), then re-form the trailing rows.  As in
    the JAX package the result carries no W."""
    n0 = model.n0
    x, y, noise = model.x.clone(), model.y.clone(), model.noise.clone()
    x[n0:] = 0.0
    y[n0:] = 0.0
    noise[n0:] = model.pad_noise
    m = GPModel(x=x, y=y, noise=noise, params=model.params, chol=model.chol, alpha=model.alpha,
                n_touch=0, kernel=model.kernel, n0=n0, pad_noise=model.pad_noise)
    empty = torch.zeros((0,), dtype=model.dtype, device=model.device)
    return update(m, empty.reshape(0, 3), empty, empty)


def _mll_chol(c: int, device: torch.device):
    """The marginal likelihood's factor: on a card at C >= 4096 tiling into
    256 blocks, Kernel B's in-place factor under `blocked_cholesky_ad`
    (its pullback two triangular solves, O(C^2) memory); otherwise the
    library's differentiable factor, a NaN factor (not an exception) where
    the matrix is not positive definite, as `jnp.linalg.cholesky` gives."""
    if device.type == "cuda" and c >= 4096 and c % 256 == 0:
        return lambda k: lin.blocked_cholesky_ad(k, 256)
    return _library_chol


def _library_chol(k: torch.Tensor) -> torch.Tensor:
    l, info = torch.linalg.cholesky_ex(k)
    return torch.where(info == 0, l, torch.full_like(l, float("nan")))


def log_marginal_likelihood(kernel, xp, yp, noisep, params, *, n_real=None, chol_impl=None):
    """log p(y | X, theta) on padded arrays (config 3), differentiable by
    torch.autograd in xp, the params (floats or tensors) and noisep.

    The padding rows add a theta-independent constant (their diagonal is
    pad_noise-dominated), so the gradients match the unpadded MLL to
    O(k^2 / pad_noise); with `n_real`, their 0.5 log(2 pi noise_i) each is
    taken back out so that the value matches an unpadded oracle too.
    `chol_impl` overrides the factor (`_mll_chol` by default); it may
    overwrite its argument.  The Gram is `gram_ad`: no (C, C, 3) temporary
    in the graph."""
    k = kg.gram_ad(kernel, xp, params, noisep)
    c = xp.shape[0]
    l = (chol_impl or _mll_chol(c, xp.device))(k)
    alpha = lin.cho_solve(l, yp)
    mll = (-0.5 * torch.dot(yp, alpha) - torch.sum(torch.log(torch.diagonal(l)))
           - 0.5 * c * math.log(2.0 * math.pi))
    if n_real is not None:
        noise = torch.as_tensor(noisep, dtype=xp.dtype, device=xp.device).broadcast_to((c,))
        mll = mll + torch.sum(0.5 * torch.log(2.0 * math.pi * noise[n_real:]))
    return mll
