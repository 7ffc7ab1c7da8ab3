"""Derivative-observation covariance blocks (port of
gpis_tpu/kernels/derivative.py), BASELINE config 2.

A GP over f observed through f(x_i) and grad f(x_i) has, for k(r2):

    cov(f(x),  f(x'))        = k
    cov(f(x),  d_e f(x'))    = -2 dk_dr2 (x - x')_e
    cov(d_d f(x), f(x'))     = +2 dk_dr2 (x - x')_d
    cov(d_d f(x), d_e f(x')) = -2 dk_dr2 delta_de - 4 d2k_dr2 (x-x')_d (x-x')_e

in the dimension-major layout [f(1..C) | d1(1..C) | d2(1..C) | d3(1..C)],
which the targets, alpha, W and checkpoints all share.

`joint_gram` and `cross_cov_value` go through Kernel E (`cuda_joint`): the
kernel on a CUDA tensor, its plain twin on a CPU one.  `joint_gram_reference`
is the dense block assembly, kept as the independent form the tests hold
Kernel E's twin to.  The gradient-query blocks (`cross_cov_grad`,
`cross_cov_grad_value`) are plain PyTorch, as in the JAX package.
"""

from __future__ import annotations

import torch

from gpis_tpu_torch.kernels import cuda_joint
from gpis_tpu_torch.kernels import functions as kf

__all__ = ["joint_gram", "joint_gram_reference", "cross_cov_value", "cross_cov_grad",
           "cross_cov_grad_value", "joint_targets"]


def _diff_r2(x, z):
    d = x[:, None, :] - z[None, :, :]  # (N, M, 3)
    return d, torch.sum(d * d, dim=-1)


def joint_gram(name: str, x, params, noise_f=None, noise_g=None, touch_x=None,
               touch_noise=None) -> torch.Tensor:
    """(J, J) joint Gram over values and gradients at x (C, 3), J = 4C + T
    with optional trailing value-only touch slots touch_x (T, 3) of noise
    touch_noise (T,).  noise_f: value noise, noise_g: gradient noise (shared
    by the three dimensions), scalars or (C,); None adds none.  Kernel E
    refuses a covariance without derivatives (laplace)."""
    if noise_f is None and noise_g is None and touch_noise is None:
        meta = cuda_joint.joint_meta(x, touch_x)
        return cuda_joint.joint_rows(name, meta, meta, params)
    return cuda_joint.joint_gram_fused(name, x, params, 0.0 if noise_f is None else noise_f,
                                       0.0 if noise_g is None else noise_g, touch_x, touch_noise)


def joint_gram_reference(name: str, x, params, noise_f=None, noise_g=None) -> torch.Tensor:
    """Dense block assembly of the (4C, 4C) joint Gram (no touch slots);
    `d2k_dr2` refuses a covariance without second derivatives."""
    c = x.shape[0]
    d, r2 = _diff_r2(x, x)
    eye = torch.eye(c, dtype=torch.bool, device=x.device)
    kff = torch.where(eye, torch.as_tensor(float(kf.k_diag0(name, params)), dtype=x.dtype,
                                           device=x.device), kf.k_r2(name, r2, params))
    dk = kf.dk_dr2(name, r2, params)
    d2k = kf.d2k_dr2(name, r2, params)
    kfg = torch.cat([-2.0 * dk * d[:, :, e] for e in range(3)], dim=1)  # (C, 3C)
    rows = []
    for di in range(3):
        blocks = []
        for e in range(3):
            # d2k multiplies diff products that vanish at r = 0: zero the
            # diagonal of the term (thin plate's d2k is singular there).
            term = -4.0 * torch.where(eye, torch.zeros_like(r2), d2k * d[:, :, di] * d[:, :, e])
            if di == e:
                term = term - 2.0 * dk
            blocks.append(term)
        rows.append(torch.cat(blocks, dim=1))
    k = torch.cat([torch.cat([kff, kfg], dim=1), torch.cat([kfg.T, torch.cat(rows)], dim=1)])
    if noise_f is not None:
        k = k + torch.diag(cuda_joint.joint_noise(c, noise_f, noise_g, None, x))
    return k


def cross_cov_value(name: str, q, x, params) -> torch.Tensor:
    """cov(f(q), [f(x); grad f(x)]): (M, 4C), the query rows of a value
    posterior."""
    return cuda_joint.joint_cross_value(name, q, x, params)


def cross_cov_grad(name: str, q, x, params) -> torch.Tensor:
    """cov(grad f(q), [f(x); grad f(x)]): (3M, 4C) dimension-major, the rows
    of a posterior-gradient (surface normal) query."""
    d, r2 = _diff_r2(q, x)
    dk = kf.dk_dr2(name, r2, params)
    d2k = kf.d2k_dr2(name, r2, params)
    zero = r2 <= 1e-24
    rows = []
    for di in range(3):
        blocks = [2.0 * dk * d[:, :, di]]  # cov(d_d f(q), f(x))
        for e in range(3):
            term = -4.0 * torch.where(zero, torch.zeros_like(r2), d2k * d[:, :, di] * d[:, :, e])
            if di == e:
                term = term - 2.0 * dk
            blocks.append(term)
        rows.append(torch.cat(blocks, dim=1))
    return torch.cat(rows)


def cross_cov_grad_value(name: str, q, t, params) -> torch.Tensor:
    """cov(grad f(q), f(t)): (3M, T) dimension-major, the gradient-query
    rows against value-only columns (touch slots)."""
    d, r2 = _diff_r2(q, t)
    dk = kf.dk_dr2(name, r2, params)
    return torch.cat([2.0 * dk * d[:, :, e] for e in range(3)])


def joint_targets(y_f, normals) -> torch.Tensor:
    """Observation vector [y_f; n_x(1..C); n_y(1..C); n_z(1..C)]."""
    return torch.cat([y_f, normals[:, 0], normals[:, 1], normals[:, 2]])
