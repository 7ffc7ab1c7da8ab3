"""Local-expert GP committee, the expert-parallel axis (port of
gpis_tpu/gp/experts.py).

* The cloud is split into E balanced spatial experts (`partition_cloud`:
  k-means centroids, then a capacity-capped greedy assignment; host NumPy,
  branch for branch the JAX package's, so a seed gives the same groups).
  Every expert also sees the shared GPIS label rows, so each local implicit
  function is anchored.  `n_halo` adds foreign boundary points.
* Each expert is an exact GP of one shared capacity B, stacked (E, B, ...).
  The fit is a Python loop over the experts through the port's own pieces,
  as the JAX package's `lax.map` runs them one after another: the Gram
  (Kernel A, or E for a joint committee), the factor (`linalg.cholesky`:
  Kernel B at B >= 4,096), W = L^{-1} (Kernel C), then one Newton step
  W <- tril(W + W (I - L W)) and alpha = W^T (W y) (TF32 off; the residual
  I - L W in float64, `_newton_w`): the step removes W's O(eps kappa) quad
  error, which the committee weights cannot tolerate.  W and L are written into stacks
  allocated once; one expert's Gram is alive at a time.
* The (robust) Bayesian committee machine combines the experts:

      beta_e = 1 (BCM) or 1/2 (log k0 - log var_e) (rBCM)
      var*^-1 = sum_e beta_e / var_e + (1 - sum_e beta_e) / k0
      mean*   = var* sum_e beta_e mean_e / var_e

  A dense query is chunked and gated on the host: each chunk meets only
  its `gate` nearest experts by centroid, each (chunk, expert) pair through
  the port's query routes (`cuda_query.fused_query`: Kernel A then D, or F;
  `cuda_joint.fused_joint_query` for a joint committee).  Small queries
  (M B E < 2^24) take every expert at once, each W read once a call.
* `mean_and_gradient` gives the committee mean and its gradient in q for
  the Newton projection: each expert's mean and variance gradients by the
  chain rule through the analytic cross-covariance gradient (plain
  exact-FP32 products), and the combine's through torch.autograd over the
  (E, M) stacks -- the JAX package takes `jax.grad` of `predict_mean`.
* `predict_sharded` runs the combine on a `torch.distributed` group: each
  rank its contiguous share of the experts (`shard_experts`), one
  all-reduce of the three partial sums.
* `optimize_experts` maximizes the product-of-experts likelihood
  sum_e log p(y_e | X_e, theta) with one backward an expert.
* `update` routes each touch to its nearest centroid and borders it into
  that expert through `regression.update` or `derivative.update_joint`.
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch

from gpis_tpu_torch.gp import regression as gpr
from gpis_tpu_torch.gp.hyperopt import HyperoptResult, _as_scalar, _minimize
from gpis_tpu_torch.gp.model import GPModel, align_capacity, as_dtype, round_up
from gpis_tpu_torch.kernels import cuda_joint
from gpis_tpu_torch.kernels import derivative as kd
from gpis_tpu_torch.kernels import functions as kf
from gpis_tpu_torch.kernels import gram as kg
from gpis_tpu_torch.kernels.cuda_query import exact_fp32, fused_query
from gpis_tpu_torch.linalg import cholesky as lin

__all__ = [
    "ExpertGPModel",
    "partition_cloud",
    "fit_experts",
    "fit_experts_joint",
    "optimize_experts",
    "predict",
    "predict_mean",
    "predict_all",
    "mean_and_gradient",
    "predict_sharded",
    "shard_experts",
    "update",
    "expert_view",
    "expert_chol",
]


@dataclasses.dataclass(frozen=True)
class ExpertGPModel:
    """Committee of E local exact GPs with stacked (E, B, ...) state.
    `params` holds Python floats; `n_touch` is a host int32 array."""

    x: torch.Tensor  # (E, B, 3) expert training positions (normalized frame)
    y: torch.Tensor  # (E, B) targets
    noise: torch.Tensor  # (E, B) observation variances (pad rows: pad_noise)
    params: dict  # shared kernel hyperparameters
    # (E, B, B) lower factors, or None for a large committee (`retain_chol`):
    # queries read only W, and a touch refactors its expert (`expert_chol`).
    chol: torch.Tensor | None
    alpha: torch.Tensor  # (E, B), or (E, J) for a joint committee
    linv: torch.Tensor | None  # (E, B, B) W = L^{-1}, lower-triangular
    n_touch: np.ndarray  # (E,) touch-slot occupancy of each expert
    centroids: torch.Tensor  # (E, 3) gating and touch routing
    kernel: str
    n0: int  # touch boundary (value) or core capacity C (joint)
    pad_noise: float = 1e10
    beta: str = "rbcm"
    gate: int = 0
    # Joint (config-2) committee: normals as gradient observations, the
    # factors over J = 4C + T rows, tactile slots at the joint tail.
    normals: torch.Tensor | None = None  # (E, C, 3)
    noise_g: torch.Tensor | None = None  # (E, C)
    touch_x: torch.Tensor | None = None  # (E, T, 3)
    touch_y: torch.Tensor | None = None  # (E, T)
    touch_noise: torch.Tensor | None = None  # (E, T)

    @property
    def n_experts(self) -> int:
        return self.x.shape[0]

    @property
    def capacity(self) -> int:  # per-expert capacity B
        return self.x.shape[1]

    @property
    def joint(self) -> bool:
        return self.normals is not None

    @property
    def touch_capacity(self) -> int:
        if self.joint:
            return 0 if self.touch_x is None else self.touch_x.shape[1]
        return self.capacity - self.n0

    @property
    def dtype(self) -> torch.dtype:
        return self.x.dtype

    @property
    def device(self) -> torch.device:
        return self.x.device

    def predict(self, q, **kw):
        return predict(self, q, **kw)


# --------------------------------------------------------------- partition


def partition_cloud(points, n_experts: int, *, iters: int = 8, seed: int = 0):
    """Balanced spatial partition of an (N, 3) cloud into `n_experts` groups:
    k-means centroids, then each (point, expert) pair in order of distance,
    a point taking its nearest expert with room (cap = ceil(N / E)).  Host
    NumPy.  Returns (centroids (E, 3), groups: E index arrays)."""
    pts = np.asarray(points, np.float64)
    n = pts.shape[0]
    e = int(n_experts)
    if e < 1:
        raise ValueError(f"n_experts must be >= 1, got {e}")
    if e == 1:
        return pts.mean(0, keepdims=True), [np.arange(n)]
    if e > n:
        raise ValueError(f"n_experts {e} exceeds point count {n}")
    rng = np.random.default_rng(seed)
    cent = pts[rng.choice(n, e, replace=False)]
    for _ in range(iters):
        d = ((pts[:, None, :] - cent[None, :, :]) ** 2).sum(-1)  # (N, E)
        a = d.argmin(1)
        for k in range(e):
            sel = pts[a == k]
            if len(sel):
                cent[k] = sel.mean(0)
    d = ((pts[:, None, :] - cent[None, :, :]) ** 2).sum(-1)
    cap = -(-n // e)
    order = np.argsort(d, axis=None, kind="stable")
    assign = np.full(n, -1, np.int64)
    counts = np.zeros(e, np.int64)
    placed = 0
    for flat in order:
        i, k = divmod(int(flat), e)
        if assign[i] >= 0 or counts[k] >= cap:
            continue
        assign[i] = k
        counts[k] += 1
        placed += 1
        if placed == n:
            break
    groups = [np.nonzero(assign == k)[0] for k in range(e)]
    # The final centroids are the balanced groups' means (for gating).
    cent = np.stack([pts[g].mean(0) if len(g) else cent[k] for k, g in enumerate(groups)])
    return cent, groups


def _partition_with_halo(pts_own, n_experts: int, *, n_halo: int = 0, seed: int = 0):
    """`partition_cloud` plus, for each expert, the `n_halo` points nearest
    its centroid that the partition gave to another expert."""
    centroids, groups = partition_cloud(pts_own, n_experts, seed=seed)
    e = len(groups)
    n_own = pts_own.shape[0]
    if n_halo > 0 and e > 1:
        own = np.asarray(pts_own, np.float64)
        member = np.zeros((n_own, e), bool)
        for k, g in enumerate(groups):
            member[g, k] = True
        d = ((own[:, None, :] - centroids[None, :, :]) ** 2).sum(-1)
        halo_groups = []
        for k, g in enumerate(groups):
            dk = np.where(member[:, k], np.inf, d[:, k])
            take = min(int(n_halo), n_own - len(g))
            halo = np.argpartition(dk, take - 1)[:take] if take > 0 else \
                np.empty((0,), np.int64)
            halo_groups.append(np.concatenate([g, np.sort(halo)]))
        groups = halo_groups
    return centroids, groups


# --------------------------------------------------------------------- fit


def _inputs(x, y, n_shared_tail: int, n_experts: int, n_halo: int, seed: int, dtype):
    """x and y in `dtype` on x's device, the partition of the non-shared
    rows, and each expert's row indices (its group, then the shared tail)."""
    x = torch.as_tensor(x).to(dtype=dtype)
    y = _as(y, x, (x.shape[0],))
    n_own = x.shape[0] - n_shared_tail
    if n_own <= 0:
        raise ValueError("no partitionable rows (n_shared_tail >= N)")
    centroids, groups = _partition_with_halo(x[:n_own].cpu().numpy(), n_experts, n_halo=n_halo,
                                             seed=seed)
    shared = np.arange(n_own, x.shape[0])
    idx = [torch.as_tensor(np.concatenate([g, shared]), device=x.device) for g in groups]
    return x, y, centroids, groups, idx


def _as(v, like: torch.Tensor, shape) -> torch.Tensor:
    return torch.as_tensor(v).to(dtype=like.dtype, device=like.device).broadcast_to(shape)


def _retain(retain_chol: bool | None, want_linv: bool, e: int, j: int, dtype) -> bool:
    """Keep the stacked L: always without W; by default only while L and W
    together stay under 4e9 bytes."""
    if not want_linv:
        return True
    if retain_chol is None:
        return 2 * e * j * j * torch.finfo(dtype).bits // 8 <= 4_000_000_000
    return bool(retain_chol)


_NEWTON_PANEL = 1024  # the float64 residual's block width (8 MB a block at 1,024)


def _newton_w(l: torch.Tensor, w: torch.Tensor, out: torch.Tensor) -> None:
    """out = tril(W + W R), R = I - L W: one Newton step toward L^{-1}.  R
    is formed in float64 and rounded back: L W is I up to W's error, and a
    float32 product's rounding of it (eps |L||W|) is as large as that error,
    so a float32 R would add about as much as it removes.  R is lower
    triangular (L and W are), so it is formed a block at a time from
    float64 copies of one row panel of L and one column panel of W
    (`_NEWTON_PANEL` wide): the float64 transient is two panels, not three
    J x J matrices.  W R and the sum are exact FP32 (TF32 off).  In float64
    every product is float64, the JAX package's arithmetic.  The tril keeps
    W's upper triangle exactly zero, which the query kernels' plans skip."""
    j, panel = w.shape[-1], _NEWTON_PANEL
    r = torch.zeros_like(w)
    with exact_fp32():
        for c0 in range(0, j, panel):
            c1 = min(c0 + panel, j)
            w64 = w[c0:, c0:c1].to(torch.float64)
            for r0 in range(c0, j, panel):
                r1 = min(r0 + panel, j)
                blk = l[r0:r1, c0:r1].to(torch.float64) @ w64[:r1 - c0]
                blk.neg_()
                if r0 == c0:
                    blk.diagonal().add_(1.0)
                r[r0:r1, c0:c1] = blk
        r = w @ r
        r += w
        torch.tril(r, out=out)


def _fit_stack(e: int, j: int, gram_of, target_of, *, want_linv: bool, retain: bool,
               jitter: float, max_jitter_retries: int, dtype, dev, what: str):
    """Factor E experts of size j into preallocated stacks, with the
    per-expert NaN-jitter ladder: `gram_of(i, extra)` is expert i's Gram
    with `extra` on its noise, `target_of(i)` its targets.  An expert is
    refit only while its own factor is NaN, at 4 eps j k0 10^attempt, the
    JAX package's rungs; the ladder reads the diagonals once an attempt.
    Returns (chol stack or None, W stack or None, alpha, extra)."""
    chol = torch.empty((e, j, j), dtype=dtype, device=dev) if retain else None
    linv = torch.empty((e, j, j), dtype=dtype, device=dev) if want_linv else None
    alpha = torch.empty((e, j), dtype=dtype, device=dev)
    diag = torch.empty((e, j), dtype=dtype, device=dev)
    extra = np.zeros((e,), np.float64)
    todo = range(e)
    for attempt in range(max_jitter_retries + 1):
        for i in todo:
            l = lin.cholesky(gram_of(i, float(extra[i])))  # Kernel A or E, then B
            diag[i] = l.diagonal()
            if chol is not None:
                chol[i] = l
            if not want_linv:
                alpha[i] = lin.cho_solve(l, target_of(i))
                continue
            w = lin.blocked_linv(l, 512 if j % 512 == 0 else j)  # Kernel C
            _newton_w(l, w, linv[i])
            del l, w
            with exact_fp32():
                alpha[i] = linv[i].T @ (linv[i] @ target_of(i))
        bad = torch.isnan(diag).any(dim=1).cpu().numpy()
        if not bad.any():
            return chol, linv, alpha, extra
        extra[bad] = jitter * (10.0**attempt)
        todo = np.nonzero(bad)[0].tolist()
    raise FloatingPointError(f"{what} failed even with jitter {extra.max():.2e}")


def fit_experts(kernel: str, x, y, noise, params, *, n_experts: int, n_shared_tail: int = 0,
                block: int = 128, touch_capacity: int = 64, pad_noise: float = 1e10, dtype=None,
                beta: str = "rbcm", gate: int = 0, seed: int = 0, max_jitter_retries: int = 6,
                n_halo: int = 0, retain_chol: bool | None = None) -> ExpertGPModel:
    """Partition rows [0, N - n_shared_tail) into `n_experts` local GPs; the
    trailing `n_shared_tail` rows (the GPIS label points) join every expert.
    Each expert gets `touch_capacity` tactile slots at rows [n0, B), with
    n0 = round_up(largest group + shared, block) and
    B = align_capacity(n0 + round_up(touch_capacity, block)).  W is formed
    at B >= 512; `retain_chol=None` keeps the stacked L only while L and W
    together take at most 4e9 bytes (else the model carries W alone)."""
    dtype = as_dtype(dtype, x)
    x, y, centroids, groups, idx = _inputs(x, y, n_shared_tail, n_experts, n_halo, seed, dtype)
    noise = _as(noise, x, y.shape)
    dev, e = x.device, len(groups)
    n0 = round_up(max(len(g) for g in groups) + n_shared_tail, block)
    b_tot = align_capacity(n0 + round_up(touch_capacity, block))
    padded = [gpr.pad_training(x[i], y[i], noise[i], b_tot, pad_noise, dtype) for i in idx]
    xs, ys, ns = (torch.stack(v) for v in zip(*padded))
    del padded
    params = gpr._float_params(params)
    k0 = float(kf.k_diag0(kernel, params))
    want_linv = b_tot >= 512
    chol, linv, alpha, extra = _fit_stack(
        e, b_tot, lambda i, ex: kg.gram(kernel, xs[i], params, noise=ns[i] + ex),
        lambda i: ys[i], want_linv=want_linv,
        retain=_retain(retain_chol, want_linv, e, b_tot, dtype),
        jitter=4.0 * torch.finfo(dtype).eps * b_tot * abs(k0),
        max_jitter_retries=max_jitter_retries, dtype=dtype, dev=dev,
        what="expert Cholesky")
    return ExpertGPModel(
        x=xs, y=ys, noise=ns + torch.as_tensor(extra, dtype=dtype, device=dev)[:, None],
        params=params, chol=chol, alpha=alpha, linv=linv, n_touch=np.zeros((e,), np.int32),
        centroids=torch.as_tensor(centroids, dtype=dtype, device=dev), kernel=kernel, n0=n0,
        pad_noise=pad_noise, beta=beta, gate=int(gate))


def fit_experts_joint(kernel: str, x, y, normals, noise_f, noise_g, params, *, n_experts: int,
                      n_shared_tail: int = 0, block: int = 128, touch_capacity: int = 64,
                      pad_noise: float = 1e10, dtype=None, beta: str = "rbcm", gate: int = 0,
                      seed: int = 0, max_jitter_retries: int = 6, n_halo: int = 0,
                      retain_chol: bool | None = None) -> ExpertGPModel:
    """Config 2 x EP: a committee of local joint GPs, each observing its
    points' values and unit normals (the gp.derivative layout, J = 4C + T).
    C = round_up(largest group + shared, block); T = round_up(touch_capacity,
    block); where 4C + T >= 4,096, C goes up to a multiple of 256 and T to
    align_capacity(4C + T) - 4C.  The shared anchor rows should carry zero
    normals and pad-noise gradients (the session's `_joint_obs` does), so
    they stay value observations.  The jitter ladder adds to the value and
    gradient noise, not to the empty touch slots'."""
    dtype = as_dtype(dtype, x)
    x, y, centroids, groups, idx = _inputs(x, y, n_shared_tail, n_experts, n_halo, seed, dtype)
    noise_f, noise_g, normals = _as(noise_f, x, y.shape), _as(noise_g, x, y.shape), _as(
        normals, x, x.shape)
    dev, e = x.device, len(groups)
    c = round_up(max(len(g) for g in groups) + n_shared_tail, block)
    t = round_up(touch_capacity, block) if touch_capacity else 0
    if 4 * c + t >= 4096:
        c = round_up(c, 256)
        if t:
            t = align_capacity(4 * c + t) - 4 * c
    j_tot = 4 * c + t

    def stack(v, fill, shape):
        out = torch.full((e,) + shape, fill, dtype=dtype, device=dev)
        for k, i in enumerate(idx):
            out[k, :len(i)] = v[i]
        return out

    xs, ys = stack(x, 0.0, (c, 3)), stack(y, 0.0, (c,))
    nfs, ngs = stack(noise_f, pad_noise, (c,)), stack(noise_g, pad_noise, (c,))
    nrms = stack(normals, 0.0, (c, 3))
    params = gpr._float_params(params)
    k0 = float(kf.k_diag0(kernel, params))
    tx0 = torch.zeros((t, 3), dtype=dtype, device=dev) if t else None
    tn0 = torch.full((t,), pad_noise, dtype=dtype, device=dev) if t else None
    zeros_t = torch.zeros((t,), dtype=dtype, device=dev)

    def gram_of(i, ex):
        return kd.joint_gram(kernel, xs[i], params, noise_f=nfs[i] + ex, noise_g=ngs[i] + ex,
                             touch_x=tx0, touch_noise=tn0)

    want_linv = j_tot >= 512
    chol, linv, alpha, extra = _fit_stack(
        e, j_tot, gram_of, lambda i: torch.cat([kd.joint_targets(ys[i], nrms[i]), zeros_t]),
        want_linv=want_linv, retain=_retain(retain_chol, want_linv, e, j_tot, dtype),
        jitter=4.0 * torch.finfo(dtype).eps * j_tot * abs(k0),
        max_jitter_retries=max_jitter_retries, dtype=dtype, dev=dev,
        what="joint expert Cholesky")
    ej = torch.as_tensor(extra, dtype=dtype, device=dev)[:, None]
    return ExpertGPModel(
        x=xs, y=ys, noise=nfs + ej, params=params, chol=chol, alpha=alpha, linv=linv,
        n_touch=np.zeros((e,), np.int32),
        centroids=torch.as_tensor(centroids, dtype=dtype, device=dev), kernel=kernel, n0=c,
        pad_noise=pad_noise, beta=beta, gate=int(gate), normals=nrms, noise_g=ngs + ej,
        touch_x=torch.zeros((e, t, 3), dtype=dtype, device=dev) if t else None,
        touch_y=torch.zeros((e, t), dtype=dtype, device=dev) if t else None,
        touch_noise=torch.full((e, t), pad_noise, dtype=dtype, device=dev) if t else None)


def _touch(model: ExpertGPModel, e: int):
    return None if model.touch_x is None else model.touch_x[e]


def expert_chol(model: ExpertGPModel, e: int) -> torch.Tensor:
    """Expert e's Cholesky factor: the stored one, or one refactor from its
    Gram (Kernel A or E, then B) for a committee that keeps W alone."""
    if model.chol is not None:
        return model.chol[e]
    if model.joint:
        k = kd.joint_gram(model.kernel, model.x[e], model.params, noise_f=model.noise[e],
                          noise_g=model.noise_g[e], touch_x=_touch(model, e),
                          touch_noise=(None if model.touch_noise is None
                                       else model.touch_noise[e]))
    else:
        k = kg.gram(model.kernel, model.x[e], model.params, noise=model.noise[e])
    return lin.cholesky(k)


def expert_view(model: ExpertGPModel, e: int):
    """Expert e as a single model (GPModel, or DerivGPModel for a joint
    committee), whose tensors are views of the stacks."""
    linv = None if model.linv is None else model.linv[e]
    if model.joint:
        from gpis_tpu_torch.gp.derivative import DerivGPModel

        return DerivGPModel(
            x=model.x[e], y=model.y[e], normals=model.normals[e], noise_f=model.noise[e],
            noise_g=model.noise_g[e], params=model.params, chol=expert_chol(model, e),
            alpha=model.alpha[e], kernel=model.kernel, n0=model.n0, linv=linv,
            touch_x=_touch(model, e),
            touch_y=None if model.touch_y is None else model.touch_y[e],
            touch_noise=None if model.touch_noise is None else model.touch_noise[e],
            n_touch=None if model.touch_x is None else int(model.n_touch[e]))
    return GPModel(x=model.x[e], y=model.y[e], noise=model.noise[e], params=model.params,
                   chol=expert_chol(model, e), alpha=model.alpha[e],
                   n_touch=int(model.n_touch[e]), kernel=model.kernel, n0=model.n0,
                   pad_noise=model.pad_noise, linv=linv)


# ----------------------------------------------------------------- combine


_FLOOR_SCALE = float(os.environ.get("GPIS_EXPERT_FLOOR_SCALE", "0.5"))


def _beta_weights(var, k0, mode: str, dt, capacity: int = 4):
    """Committee weights from clamped expert variances: (beta, clamped var).
    The lower clamp is the quad-noise floor eps max(16, _FLOOR_SCALE B) k0
    (the JAX package's; GPIS_EXPERT_FLOOR_SCALE sets the scale, 0.5 by
    default): an expert variance below it is float32 quad noise, and the
    committee sums precisions, so a floor too low makes it overconfident."""
    eps = torch.finfo(dt).eps
    vc = torch.clamp(var, k0 * eps * max(16.0, _FLOOR_SCALE * capacity), k0)
    if mode == "bcm":
        return torch.ones_like(vc), vc
    if mode == "rbcm":
        return 0.5 * (math.log(k0) - torch.log(vc)), vc
    raise ValueError(f"unknown committee rule {mode!r} (use 'rbcm' or 'bcm')")


def _combine(means, varis, k0, mode: str, capacity: int = 4):
    """(G, M) expert posteriors -> the (M,) committee posterior."""
    beta, vc = _beta_weights(varis, k0, mode, means.dtype, capacity)
    prec = torch.sum(beta / vc, dim=0) + (1.0 - torch.sum(beta, dim=0)) / k0
    mean = torch.sum(beta * means / vc, dim=0) / prec
    return mean, 1.0 / prec


def _expert_cross(model: ExpertGPModel, e: int, q: torch.Tensor) -> torch.Tensor:
    """cov(f(q), expert e's observations): K(q, x_e) (Kernel A), or the
    joint value rows and touch columns (Kernel E)."""
    if model.joint:
        return cuda_joint.joint_cross_value(model.kernel, q, model.x[e], model.params,
                                            _touch(model, e))
    return kg.cross_cov(model.kernel, q, model.x[e], model.params)


def _expert_cross_grad(model: ExpertGPModel, e: int, q: torch.Tensor) -> torch.Tensor:
    """d/dq of `_expert_cross`: (3M, J), dimension-major rows."""
    if not model.joint:
        return kd.cross_cov_grad_value(model.kernel, q, model.x[e], model.params)
    g = kd.cross_cov_grad(model.kernel, q, model.x[e], model.params)
    if model.touch_x is not None:
        g = torch.cat([g, kd.cross_cov_grad_value(model.kernel, q, model.touch_x[e],
                                                  model.params)], dim=1)
    return g


def _expert_posterior(model: ExpertGPModel, e: int, q: torch.Tensor):
    """Expert e's (mean, variance) at q: with W, the port's query route
    (Kernel A then D, or F; Kernel E then D, or F for a joint committee);
    without, the cross-covariance and a triangular solve against L."""
    k0 = kf.k_diag0(model.kernel, model.params)
    if model.linv is not None and model.joint:
        mean, quad = cuda_joint.fused_joint_query(model.kernel, q, model.x[e], model.params,
                                                  model.alpha[e], model.linv[e],
                                                  _touch(model, e))
        return mean, k0 - quad
    if model.linv is not None and model.kernel in kf.KERNEL_NAMES:
        mean, quad = fused_query(model.kernel, q, model.x[e], model.params, model.alpha[e],
                                 model.linv[e])
        return mean, k0 - quad
    kq = _expert_cross(model, e, q)
    v = (model.linv[e] @ kq.T if model.linv is not None
         else lin.solve_lower(model.chol[e], kq.T))
    return kq @ model.alpha[e], k0 - torch.sum(v * v, dim=0)


def _stats(model: ExpertGPModel, q: torch.Tensor, experts):
    """(G, M) means and variances of the listed experts at q."""
    means, varis = zip(*(_expert_posterior(model, int(e), q) for e in experts))
    return torch.stack(means), torch.stack(varis)


def _stats_all(model: ExpertGPModel, q: torch.Tensor):
    """All experts' (means, variances), (E, M) each, ungated."""
    return _stats(model, q.contiguous(), range(model.n_experts))


def predict(model: ExpertGPModel, q: torch.Tensor, *, gate: int | None = None,
            chunk: int = 8192):
    """Committee posterior (mean, variance) at queries q (M, 3).

    Gate G (the model's when None; 0 = every expert): unless G covers every
    expert and M B E < 2^24 (the ungated all-expert route), q is taken in
    chunks of min(chunk, max(256, M)) and each chunk meets only the G
    experts nearest it by centroid (min squared distance over its points,
    on the host); the experts it skips are the prior term of the BCM
    precision.  With every expert gated in, the experts are taken in order
    0..E-1, else nearest first."""
    gate = model.gate if gate is None else gate
    e = model.n_experts
    k0 = kf.k_diag0(model.kernel, model.params)
    g = e if gate <= 0 else min(gate, e)
    q = q.contiguous()
    m = q.shape[0]
    if m == 0:
        return q.new_zeros((0,)), q.new_zeros((0,))
    if g == e and m * model.capacity * e < 1 << 24:
        return predict_all(model, q)
    q_host = q.cpu().numpy()
    cent = model.centroids.cpu().numpy()
    chunk = min(chunk, max(256, m))
    n_chunks = -(-m // chunk)
    d = ((q_host[:, None, :] - cent[None, :, :]) ** 2).sum(-1)  # (M, E)
    d = np.pad(d, ((0, n_chunks * chunk - m), (0, 0)), constant_values=np.inf)
    sel = np.argsort(d.reshape(n_chunks, chunk, e).min(1), axis=1, kind="stable")[:, :g]
    means, varis = [], []
    for c in range(n_chunks):
        experts = sel[c] if g < e else range(e)
        mean, var = _combine(*_stats(model, q[c * chunk:(c + 1) * chunk], experts), k0,
                             model.beta, model.capacity)
        means.append(mean)
        varis.append(var)
    return torch.cat(means), torch.cat(varis)


def predict_all(model: ExpertGPModel, q: torch.Tensor):
    """Committee posterior from every expert whatever the gate or the size:
    the JAX package's route for a traced q (inside `jax.jit`, as its
    planner's chart expansion runs)."""
    k0 = kf.k_diag0(model.kernel, model.params)
    return _combine(*_stats_all(model, q), k0, model.beta, model.capacity)


def predict_mean(model: ExpertGPModel, q: torch.Tensor) -> torch.Tensor:
    """Committee posterior mean (all experts: the weights need every
    expert's variance)."""
    return predict_all(model, q)[0]


def mean_and_gradient(model: ExpertGPModel, q: torch.Tensor):
    """Committee mean (M,) and its gradient in q (M, 3), through every
    expert's mean AND variance (the weights depend on q).  Each expert's
    d mean = dK alpha and d var = -2 sum_j v_j (W dK^T)_j, v = W K^T (or
    triangular solves without W), are plain exact-FP32 products on the
    analytic cross-covariance gradient dK; the combine's derivative in the
    (E, M) stacks is torch.autograd's."""
    q = q.contiguous()
    m = q.shape[0]
    k0 = kf.k_diag0(model.kernel, model.params)
    means, varis, dmeans, dvars = [], [], [], []
    with exact_fp32():
        for e in range(model.n_experts):
            kq = _expert_cross(model, e, q)  # (M, J)
            dkq = _expert_cross_grad(model, e, q)  # (3M, J)
            rhs = torch.cat([kq, dkq]).T  # (J, 4M)
            v = (model.linv[e] @ rhs if model.linv is not None
                 else lin.solve_lower(model.chol[e], rhs))
            a = torch.cat([kq, dkq]) @ model.alpha[e]
            means.append(a[:m])
            dmeans.append(a[m:].reshape(3, m).T)
            v0 = v[:, :m]
            varis.append(k0 - torch.sum(v0 * v0, dim=0))
            dvars.append(-2.0 * torch.sum(v0.repeat(1, 3) * v[:, m:], dim=0).reshape(3, m).T)
            del kq, dkq, rhs, v, v0
    means = torch.stack(means).requires_grad_(True)
    varis = torch.stack(varis).requires_grad_(True)
    with torch.enable_grad():
        mean = _combine(means, varis, k0, model.beta, model.capacity)[0]
        gm, gv = torch.autograd.grad(mean.sum(), (means, varis))
    grad = torch.sum(gm[..., None] * torch.stack(dmeans) + gv[..., None] * torch.stack(dvars),
                     dim=0)
    return mean.detach(), grad


# ------------------------------------------------------------ sharded (EP)


def predict_sharded(model: ExpertGPModel, q: torch.Tensor, mesh, *, axis: str = "expert"):
    """Committee posterior on a `torch.distributed` group (`parallel.mesh`):
    each rank holds a contiguous share of the experts (`shard_experts`) and
    the same q, evaluates its experts' partial sums of beta/var,
    beta mean/var and beta, and one all-reduce of the stacked (3, M) sums
    completes the combine on every rank.  `axis` names the JAX mesh axis;
    the process group has none."""
    del axis
    q = q.to(device=mesh.device).contiguous()
    k0 = kf.k_diag0(model.kernel, model.params)
    means, varis = _stats_all(model, q)
    beta, vc = _beta_weights(varis, k0, model.beta, means.dtype, model.capacity)
    sums = torch.stack([torch.sum(beta / vc, dim=0), torch.sum(beta * means / vc, dim=0),
                        torch.sum(beta, dim=0)])
    torch.distributed.all_reduce(sums)
    prec = sums[0] + (1.0 - sums[2]) / k0
    return sums[1] / prec, 1.0 / prec


def shard_experts(model: ExpertGPModel, mesh, *, axis: str = "expert") -> ExpertGPModel:
    """This rank's contiguous share of the experts (E must divide by the
    group's size), copied onto its device; the centroids stay whole, as the
    JAX package leaves them replicated.  `axis` as in `predict_sharded`."""
    del axis
    row0, rows = mesh.band(model.n_experts)

    def put(a):
        return None if a is None else a[row0:row0 + rows].to(mesh.device).clone()

    return dataclasses.replace(
        model, x=put(model.x), y=put(model.y), noise=put(model.noise), chol=put(model.chol),
        alpha=put(model.alpha), linv=put(model.linv),
        n_touch=model.n_touch[row0:row0 + rows].copy(),
        centroids=model.centroids.to(mesh.device), normals=put(model.normals),
        noise_g=put(model.noise_g), touch_x=put(model.touch_x), touch_y=put(model.touch_y),
        touch_noise=put(model.touch_noise))


# ---------------------------------------------------------------- hyperopt


def optimize_experts(model: ExpertGPModel, *, learn_noise: bool = True,
                     learn_signal: bool = False, steps: int = 100,
                     learning_rate: float = 0.05) -> HyperoptResult:
    """Maximize the product-of-experts objective sum_e log p(y_e | X_e,
    theta) by Adam: each expert's `regression.log_marginal_likelihood`
    (Kernel A under `gram_ad`, Kernel B under `blocked_cholesky_ad` at
    B >= 4,096 on a card) differentiated on its own and the gradients
    summed, so one expert's graph is alive at a time; the loss handed to
    the optimizer carries the sum's value and that summed gradient.  The
    noise scale multiplies the real fit rows only (noise below
    pad_noise / 2 in [0, n0)): padding and occupied touch slots keep their
    noise.  The shared anchor rows count once an expert, as in the JAX
    package.  Returns the HyperoptResult of `gp.hyperopt` with noise None."""
    if model.joint:
        raise ValueError(
            "optimize_experts' PoE objective covers value-observation "
            "committees; for a joint (normals) committee use the session's "
            "subsample hyperopt (gp.hyperopt.optimize_joint on a core "
            "subsample), which pins the shared hyperparameters the same way"
        )
    xs, ys, ns = model.x, model.y, model.noise
    real = (ns < 0.5 * model.pad_noise) & (
        torch.arange(ns.shape[1], device=ns.device)[None, :] < model.n0)
    theta0 = {"log_ls": torch.log(_as_scalar(model.params["lengthscale"], xs))}
    if learn_signal:
        theta0["log_sv"] = torch.log(_as_scalar(model.params["signal_variance"], xs))
    if learn_noise:
        theta0["log_noise_scale"] = _as_scalar(0.0, xs)
    sv0 = _as_scalar(model.params["signal_variance"], xs)
    one = _as_scalar(1.0, xs)

    def unpack(theta):
        params = {"lengthscale": torch.exp(theta["log_ls"]),
                  "signal_variance": torch.exp(theta["log_sv"]) if learn_signal else sv0}
        return params, torch.exp(theta["log_noise_scale"]) if learn_noise else one

    def loss(theta):
        leaves = list(theta.values())
        total = torch.zeros((), dtype=xs.dtype, device=xs.device)
        grads = [torch.zeros_like(v) for v in leaves]
        for e in range(model.n_experts):
            # theta's graph is rebuilt for each expert: its gradient frees it.
            params, scale = unpack(theta)
            noise = torch.where(real[e], ns[e] * scale, ns[e])
            l_e = -gpr.log_marginal_likelihood(model.kernel, xs[e], ys[e], noise, params)
            for g, d in zip(grads, torch.autograd.grad(l_e, leaves)):
                g += d
            total += l_e.detach()
        # The sum's value, with the summed gradient as its own.
        lin = sum(v * g for v, g in zip(leaves, grads))
        return total + (lin - lin.detach())

    best, best_val, history, log_ls = _minimize(loss, theta0, steps=steps,
                                                learning_rate=learning_rate, optimizer="adam")
    params, scale = unpack(best)
    return HyperoptResult(params={k: float(v) for k, v in params.items()}, noise=None,
                          noise_scale=float(scale), history=history, mll=-float(best_val),
                          lengthscale_history=[math.exp(v) for v in log_ls])


# ------------------------------------------------------------------ update


def update(model: ExpertGPModel, new_x, new_y, new_noise, *,
           max_jitter_retries: int = 6) -> ExpertGPModel:
    """Tactile update: each touch is routed to its nearest centroid and
    bordered into that expert alone (`regression.update`, or
    `derivative.update_joint` for a joint committee; a committee without L
    refactors the expert first, `expert_chol`).  The touch noise, floored
    at 4 eps B k0, rides a ladder of 10x rungs until the bordered factor is
    accepted: no NaN on the touched diagonal, and each new pivot d with
    d^2 >= noise / 4 (the true Schur complement is at least the row's
    noise; float32 quad error can leave it barely positive).  A joint
    expert's slots overflowing raises ValueError.  A new model is returned;
    the stacks it changes are copied once a call."""
    new_x = np.asarray(torch.as_tensor(new_x).cpu())
    if new_x.shape[0] == 0:
        return model
    dt, dev = model.dtype, model.device
    np_dt = torch.empty((), dtype=dt).numpy().dtype
    new_y = np.broadcast_to(np.asarray(torch.as_tensor(new_y).cpu(), np_dt), (new_x.shape[0],))
    new_noise = np.broadcast_to(np.asarray(torch.as_tensor(new_noise).cpu(), np_dt),
                                (new_x.shape[0],))
    cent = model.centroids.cpu().numpy()
    route = ((new_x[:, None, :] - cent[None, :, :]) ** 2).sum(-1).argmin(1)

    k0 = float(kf.k_diag0(model.kernel, model.params))
    floor = 4.0 * torch.finfo(dt).eps * model.capacity * abs(k0)
    joint = model.joint
    if joint and model.touch_x is None:
        raise ValueError(
            "this joint committee was fitted with touch_capacity=0; refit "
            "with tactile slots to take touch updates"
        )
    t0 = 4 * model.n0 if joint else model.n0  # the first touch row of a factor
    keys = (("chol", "alpha", "linv", "touch_x", "touch_y", "touch_noise") if joint
            else ("chol", "alpha", "linv", "x", "y", "noise"))
    new = {k: getattr(model, k) for k in keys}
    copied: set = set()
    n_touch = model.n_touch.copy()
    for e in np.unique(route):
        ei = int(e)
        sel = route == e
        base = np.maximum(new_noise[sel], floor)
        ev = expert_view(dataclasses.replace(model, **new), ei)
        prev = int(n_touch[ei])
        if joint and prev + int(sel.sum()) > model.touch_capacity:
            raise ValueError(
                f"expert {ei}'s joint tactile slots would overflow "
                f"({prev}+{int(sel.sum())} > {model.touch_capacity}); refit "
                "the committee folding the accumulated touches (session "
                "hyperopt refit does this) or raise touch_capacity"
            )
        for attempt in range(max_jitter_retries + 1):
            noise_a = base * (10.0**attempt)
            args = (ev, torch.as_tensor(new_x[sel], dtype=dt, device=dev),
                    torch.as_tensor(new_y[sel], dtype=dt, device=dev),
                    torch.as_tensor(noise_a, dtype=dt, device=dev))
            if joint:
                from gpis_tpu_torch.gp import derivative as gpd

                m_e = gpd.update_joint(*args)
            else:
                m_e = gpr.update(*args)
            occ = int(m_e.n_touch)
            d = m_e.chol.diagonal()[t0:t0 + occ].cpu().numpy()
            d_new = d[prev:]
            if not np.isnan(d).any() and (d_new * d_new >= 0.25 * noise_a.min()).all():
                break
        else:
            raise FloatingPointError(
                f"expert {ei} touch bordering failed even with noise "
                f"{float(base.max()) * 10.0**max_jitter_retries:.2e}"
            )
        for k in keys:
            if new[k] is None:
                continue
            if k not in copied:
                new[k] = new[k].clone()
                copied.add(k)
            new[k][ei] = getattr(m_e, k)
        n_touch[ei] = occ
    return dataclasses.replace(model, n_touch=n_touch, **new)
