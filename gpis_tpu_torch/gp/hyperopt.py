"""Marginal-likelihood hyperparameter optimization, BASELINE config 3 (port
of gpis_tpu/gp/hyperopt.py).

Maximizes log p(y | X, theta) over the lengthscale, an observation-noise
scale and optionally the signal variance, in log-parameter space, by
torch.autograd through `regression.log_marginal_likelihood` (Kernel A as
the Gram's primal, Kernel B as the factor's at C >= 4096 on a card) or, for
the joint system, through `kernels.derivative.joint_gram_reference`.  Each
step evaluates the loss at the incoming iterate and pairs that value with
it; the best iterate is returned.

* Adam is `torch.optim.Adam` (b1 0.9, b2 0.999, eps 1e-8), optax.adam's
  update.
* L-BFGS (`optimizer="lbfgs"`) is a plain port of what
  `optax.lbfgs(learning_rate=None)` does, since optax imports jax: memory
  10, the two-loop recursion with optax's initial scaling, and optax's zoom
  line search with its defaults (20 steps, initial step 1).  Its state is
  float64 NumPy on the host (theta has at most three entries), where the
  JAX package keeps it in the problem's dtype.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gpis_tpu_torch.gp import regression as gpr
from gpis_tpu_torch.kernels import derivative as kd
from gpis_tpu_torch.linalg import cholesky as lin
from gpis_tpu_torch.utils import profiling

__all__ = ["optimize", "optimize_joint", "HyperoptResult"]


class HyperoptResult(dict):
    """dict with attribute access: params, noise, history (the MLL at each
    iterate), mll (the best), and beyond the JAX package's keys
    lengthscale_history (each iterate's lengthscale)."""

    __getattr__ = dict.__getitem__


# --------------------------------------------------------------- L-BFGS


class _LBFGS:
    """optax.scale_by_lbfgs(memory_size=10, scale_init_precond=True): the
    preconditioned gradient P_k g_k, its memory updated from the previous
    call's (params, gradient)."""

    def __init__(self, n: int, memory: int = 10):
        self.m = memory
        self.count = 0
        self.params = np.zeros(n)
        self.grad = np.zeros(n)
        self.s = np.zeros((memory, n))
        self.y = np.zeros((memory, n))
        self.rho = np.zeros(memory)

    def precondition(self, g: np.ndarray, theta: np.ndarray) -> np.ndarray:
        m, idx, prev = self.m, self.count % self.m, (self.count - 1) % self.m
        if self.count:
            ds, dy = theta - self.params, g - self.grad
            vd = float(dy @ ds)
            weight = 0.0 if vd == 0.0 else 1.0 / vd
            den = float(dy @ dy)
            scale = vd / den if den > 0.0 else 1.0
        else:
            ds = dy = np.zeros_like(g)
            weight = 0.0
            norm = float(np.sqrt(g @ g))
            scale = min(1.0, 1.0 / norm) if norm > 0.0 else 1.0
        self.s[prev], self.y[prev], self.rho[prev] = ds, dy, weight
        order = [(idx + i) % m for i in range(m)]
        vec, alphas = g.copy(), {}
        for i in reversed(order):
            alphas[i] = self.rho[i] * float(self.s[i] @ vec)
            vec = vec - alphas[i] * self.y[i]
        vec = scale * vec
        for i in order:
            beta = self.rho[i] * float(self.y[i] @ vec)
            vec = vec + (alphas[i] - beta) * self.s[i]
        self.count += 1
        self.params, self.grad = theta.copy(), g.copy()
        return vec


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    a, fa, fpa, b, fb, c, fc = map(np.float64, (a, fa, fpa, b, fb, c, fc))
    db, dc = b - a, c - a
    denom = (db * dc) ** 2 * (db - dc)
    d1 = np.array([[dc**2, -(db**2)], [-(dc**3), db**3]])
    aa, bb = d1 @ np.array([fb - fa - fpa * db, fc - fa - fpa * dc]) / denom
    return a + (-bb + np.sqrt(bb * bb - 3.0 * aa * fpa)) / (3.0 * aa)


def _quadmin(a, fa, fpa, b, fb):
    a, fa, fpa, b, fb = map(np.float64, (a, fa, fpa, b, fb))
    db = b - a
    bb = (fb - fa - fpa * db) / (db**2)
    return a - fpa / (2.0 * bb)


def _zoom_linesearch(value_and_grad, params, updates, value, grad, *, max_steps: int = 20,
                     tol: float = 0.0, increase_factor: float = 2.0, slope_rtol: float = 1e-4,
                     curv_rtol: float = 0.9, approx_dec_rtol: float = 1e-6,
                     interval_threshold: float = 1e-5) -> float:
    """The step size optax.scale_by_zoom_linesearch(max_linesearch_steps=20,
    initial_guess_strategy="one") takes along `updates` (a strong-Wolfe
    search: bracket by doubling from 1, then zoom by cubic, quadratic or
    bisection steps, falling back to the best safe decrease)."""

    def on_line(step):
        v, g = value_and_grad(params + step * updates)
        return v, g, float(g @ updates)

    def decrease_error(step, v, slope):
        err = v - value_init - slope_rtol * step * slope_init
        approx = np.maximum(slope - (2 * slope_rtol - 1.0) * slope_init,
                            v - value_init - approx_dec_rtol * np.abs(value_init))
        err = np.maximum(np.minimum(approx, err), 0.0)
        return np.inf if np.isnan(err) else float(err)

    def curvature_error(slope):
        err = np.maximum(np.abs(slope) - curv_rtol * np.abs(slope_init), 0.0)
        return np.inf if np.isnan(err) else float(err)

    value_init = value
    slope_init = float(updates @ grad)
    count, stepsize, cur_v, cur_slope = 0, 0.0, value, slope_init
    dec_err = np.inf
    interval_found = done = failed = False
    low, v_low, s_low = 0.0, value, slope_init
    high, v_high, s_high = 0.0, value, slope_init
    cubic_ref, v_cubic_ref = 0.0, value
    safe_step, safe_v = 0.0, value
    while not (done or failed):
        if not interval_found:
            new = 1.0 if count == 0 else increase_factor * stepsize
            nv, _, ns = on_line(new)
            dec_err = decrease_error(new, nv, ns)
            err = max(dec_err, curvature_error(ns))
            if dec_err <= tol:
                safe_step, safe_v = new, nv
            set_high = dec_err > 0.0 or (nv >= cur_v and count > 0)
            set_low = ns >= 0.0 and not set_high
            if set_low:
                low, v_low, s_low, high, v_high, s_high = new, nv, ns, stepsize, cur_v, cur_slope
            else:
                low, v_low, s_low, high, v_high, s_high = stepsize, cur_v, cur_slope, new, nv, ns
            interval_found = set_high or set_low or err <= tol
            done = err <= tol
            failed = count + 1 >= max_steps and not done
            cubic_ref, v_cubic_ref = low, v_low
            stepsize, cur_v, cur_slope = new, nv, ns
        else:
            delta = abs(high - low)
            left, right = min(high, low), max(high, low)
            with np.errstate(all="ignore"):
                mc = _cubicmin(low, v_low, s_low, high, v_high, cubic_ref, v_cubic_ref)
                mq = _quadmin(low, v_low, s_low, high, v_high)
            if left + 0.2 * delta < mc < right - 0.2 * delta:
                middle = float(mc)
            elif left + 0.1 * delta < mq < right - 0.1 * delta:
                middle = float(mq)
            else:
                middle = (low + high) / 2.0
            mv, _, ms = on_line(middle)
            dec_err = decrease_error(middle, mv, ms)
            err = max(dec_err, curvature_error(ms))
            if dec_err <= tol and mv < safe_v:
                safe_step, safe_v = middle, mv
            done = err <= tol
            set_high_mid = dec_err > 0.0 or mv >= v_low
            set_high_low = ms * (high - low) >= 0.0 and not set_high_mid
            new_high = (middle, mv, ms) if set_high_mid else (high, v_high, s_high)
            if set_high_low:
                new_high = (low, v_low, s_low)
            new_low = (low, v_low, s_low) if set_high_mid else (middle, mv, ms)
            if set_high_mid or set_high_low:
                cubic_ref, v_cubic_ref = high, v_high
            else:
                cubic_ref, v_cubic_ref = low, v_low
            (high, v_high, s_high), (low, v_low, s_low) = new_high, new_low
            failed = (count + 1 >= max_steps or (delta <= interval_threshold and safe_step > 0.0)
                      ) and not done
            stepsize, cur_v, cur_slope = middle, mv, ms
        count += 1
        if failed and (safe_step > 0.0 or np.isinf(dec_err)):
            stepsize = safe_step
    return stepsize


# --------------------------------------------------------------- the loop


def _minimize(loss, theta0: dict, *, steps: int, learning_rate: float, optimizer: str):
    """Minimize loss(theta dict of 0-d tensors) from theta0 by Adam or
    L-BFGS.  Returns (best theta, its loss, history of -loss, the iterates'
    log lengthscales), each loss paired with the iterate it was evaluated
    at."""
    keys = sorted(theta0)
    t0 = torch.stack([theta0[k] for k in keys])

    def unflat(t):
        return {k: t[i] for i, k in enumerate(keys)}

    history, log_ls, best, best_val = [], [], t0.detach().clone(), math.inf
    i_ls = keys.index("log_ls")
    dev = t0.device
    if optimizer == "lbfgs":
        def value_and_grad(t_np):
            t = torch.as_tensor(t_np, dtype=t0.dtype, device=dev).requires_grad_(True)
            with profiling.span("hyperopt.forward", device=dev):
                v = loss(unflat(t))
            with profiling.span("hyperopt.pullback", device=dev):
                (g,) = torch.autograd.grad(v, t)
            with profiling.wait("hyperopt.value", 2):
                return float(v.detach()), g.detach().cpu().numpy().astype(np.float64)

        lbfgs = _LBFGS(len(keys))
        with profiling.wait("hyperopt.theta"):
            theta = t0.detach().cpu().numpy().astype(np.float64)
        for _ in range(steps):
            with profiling.span("hyperopt.step"):
                v, g = value_and_grad(theta)
                history.append(-v)
                log_ls.append(float(theta[i_ls]))
                if v < best_val:
                    best, best_val = torch.as_tensor(theta, dtype=t0.dtype, device=dev), v
                direction = -lbfgs.precondition(g, theta)
                theta = theta + _zoom_linesearch(value_and_grad, theta, direction, v,
                                                 g) * direction
    else:
        theta = t0.detach().clone().requires_grad_(True)
        opt = torch.optim.Adam([theta], lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
        for _ in range(steps):
            with profiling.span("hyperopt.step"):
                opt.zero_grad()
                with profiling.span("hyperopt.forward", device=dev):
                    val = loss(unflat(theta))
                with profiling.span("hyperopt.pullback", device=dev):
                    val.backward()
                with profiling.wait("hyperopt.value", 2):
                    v = val.item()
                    ls = float(theta.detach()[i_ls])
                history.append(-v)
                log_ls.append(ls)
                if v < best_val:
                    best, best_val = theta.detach().clone(), v
                opt.step()
    return unflat(best), best_val, history, log_ls


def _as_scalar(v, like: torch.Tensor) -> torch.Tensor:
    with profiling.wait("hyperopt.scalar"):
        return torch.as_tensor(v, dtype=like.dtype, device=like.device).detach().clone()


def optimize(kernel: str, xp, yp, noisep, init_params, *, n_real: int, learn_signal: bool = False,
             learn_noise: bool = True, steps: int = 150, learning_rate: float = 0.05,
             optimizer: str = "adam") -> HyperoptResult:
    """Optimize hyperparameters on padded training arrays (C rows).  The
    noise scale multiplies the real rows (< n_real) only: padding keeps its
    huge variance and stays inert.  Returns the best params (Python
    floats), the scaled noise vector, the noise scale, the MLL history and
    the best MLL."""
    real = torch.arange(xp.shape[0], device=xp.device) < n_real
    theta0 = {"log_ls": torch.log(_as_scalar(init_params["lengthscale"], xp))}
    if learn_signal:
        theta0["log_sv"] = torch.log(_as_scalar(init_params["signal_variance"], xp))
    if learn_noise:
        theta0["log_noise_scale"] = _as_scalar(0.0, xp)
    sv0 = _as_scalar(init_params["signal_variance"], xp)

    def unpack(theta):
        params = {"lengthscale": torch.exp(theta["log_ls"]),
                  "signal_variance": torch.exp(theta["log_sv"]) if learn_signal else sv0}
        scale = torch.exp(theta["log_noise_scale"]) if learn_noise else _as_scalar(1.0, xp)
        return params, torch.where(real, noisep * scale, noisep), scale

    def loss(theta):
        params, noise, _ = unpack(theta)
        return -gpr.log_marginal_likelihood(kernel, xp, yp, noise, params)

    best, best_val, history, log_ls = _minimize(loss, theta0, steps=steps,
                                                learning_rate=learning_rate, optimizer=optimizer)
    params, noise, scale = unpack(best)
    with profiling.wait("hyperopt.result", len(params) + 1):
        params, scale = {k: float(v) for k, v in params.items()}, float(scale)
    return HyperoptResult(params=params, noise=noise.detach(), noise_scale=scale,
                          history=history, mll=-float(best_val),
                          lengthscale_history=[math.exp(v) for v in log_ls])


def optimize_joint(kernel: str, xp, yp, normals, noise_f, noise_g, init_params, *, n_real: int,
                   steps: int = 100, learning_rate: float = 0.05, learn_noise: bool = False,
                   learn_noise_g: bool = False, learn_signal: bool = False) -> HyperoptResult:
    """MLL optimization of the joint (value + normals) system, config 3 on
    config 2's model, by Adam: the lengthscale, and with `learn_noise` one
    scale on the real rows' value noise, with `learn_noise_g` one on their
    gradient noise, with `learn_signal` the signal variance.  The (4C, 4C)
    Gram is `joint_gram_reference` under autograd, as in the JAX package;
    its factor is `regression._mll_chol`'s."""
    yj = kd.joint_targets(yp, normals)
    real = torch.arange(xp.shape[0], device=xp.device) < n_real
    theta0 = {"log_ls": torch.log(_as_scalar(init_params["lengthscale"], xp))}
    if learn_noise:
        theta0["log_noise_scale"] = _as_scalar(0.0, xp)
    if learn_noise_g:
        theta0["log_noise_scale_g"] = _as_scalar(0.0, xp)
    if learn_signal:
        theta0["log_sv"] = torch.log(_as_scalar(init_params["signal_variance"], xp))
    sv0 = _as_scalar(init_params["signal_variance"], xp)
    one = _as_scalar(1.0, xp)

    def unpack(theta):
        params = {"lengthscale": torch.exp(theta["log_ls"]),
                  "signal_variance": torch.exp(theta["log_sv"]) if learn_signal else sv0}
        scale = torch.exp(theta["log_noise_scale"]) if learn_noise else one
        scale_g = torch.exp(theta["log_noise_scale_g"]) if learn_noise_g else one
        return (params, torch.where(real, noise_f * scale, noise_f),
                torch.where(real, noise_g * scale_g, noise_g), scale, scale_g)

    def loss(theta):
        params, nf, ng, _, _ = unpack(theta)
        k = kd.joint_gram_reference(kernel, xp, params, noise_f=nf, noise_g=ng)
        l = gpr._mll_chol(k.shape[0], k.device)(k)
        alpha = lin.cho_solve(l, yj)
        return (0.5 * torch.dot(yj, alpha) + torch.sum(torch.log(torch.diagonal(l)))
                + 0.5 * yj.shape[0] * math.log(2.0 * math.pi))

    best, best_val, history, log_ls = _minimize(loss, theta0, steps=steps,
                                                learning_rate=learning_rate, optimizer="adam")
    params, nf, ng, scale, scale_g = unpack(best)
    return HyperoptResult(params={k: float(v) for k, v in params.items()}, noise=nf.detach(),
                          noise_scale=float(scale), noise_g=ng.detach(),
                          noise_scale_g=float(scale_g), history=history, mll=-float(best_val),
                          lengthscale_history=[math.exp(v) for v in log_ls])
