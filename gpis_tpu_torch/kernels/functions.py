"""Covariance functions of squared distance (port of
gpis_tpu/kernels/functions.py).

The four built-in kernels -- rbf, laplace, inverse_multiquadric and the
compactified thin plate `2r^3 - 3Rr^2 + R^3` -- as elementwise torch math on
r2.  The CUDA tile kernels (csrc/common.cuh `k_r2`, `k_diag0`, `dk_dr2`,
`d2k_dr2`) compute the same expressions in the same order.  Hyperparameters
are a plain dict {"lengthscale", "signal_variance"} of Python floats or 0-d
tensors; for the thin plate the lengthscale is the scale R.

Derivative (surface-normal) observations need dk/dr2 and d2k/dr2^2:
grad_x k = 2 dk (x - x'), and d2k/dx dx'^T = -2 dk I - 4 d2k (x-x')(x-x')^T.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

__all__ = ["KERNEL_NAMES", "kernel_params", "k_r2", "k_diag0", "dk_dr2", "d2k_dr2",
           "supports_derivatives"]

KERNEL_NAMES = ("rbf", "thin_plate", "laplace", "inverse_multiquadric")

Params = Mapping[str, Any]


def kernel_params(lengthscale=1.0, signal_variance=1.0) -> dict:
    """The hyperparameter dict shared by all kernels."""
    return {"lengthscale": float(lengthscale), "signal_variance": float(signal_variance)}


def _safe_sqrt(r2):
    # Same clamp as the JAX package: keeps the sqrt's gradient finite at 0.
    return torch.sqrt(torch.clamp(r2, min=1e-30))


def k_r2(name: str, r2: torch.Tensor, params: Params) -> torch.Tensor:
    """Covariance k as a function of squared distance r2. Elementwise."""
    ls = params["lengthscale"]
    sv = params["signal_variance"]
    if name == "rbf":
        return sv * torch.exp(-0.5 * r2 / (ls * ls))
    if name == "laplace":
        return sv * torch.exp(-_safe_sqrt(r2) / ls)
    if name == "inverse_multiquadric":
        return sv / torch.sqrt(r2 + ls * ls)
    if name == "thin_plate":
        r = _safe_sqrt(r2)
        return sv * (2.0 * r * r2 - 3.0 * ls * r2 + ls * ls * ls)
    raise ValueError(f"unknown kernel {name!r}")


def k_diag0(name: str, params: Params):
    """k(0), the prior variance at a point (the Gram diagonal)."""
    ls = params["lengthscale"]
    sv = params["signal_variance"]
    if name in ("rbf", "laplace"):
        return sv
    if name == "inverse_multiquadric":
        return sv / ls
    if name == "thin_plate":
        return sv * ls * ls * ls
    raise ValueError(f"unknown kernel {name!r}")


def supports_derivatives(name: str) -> bool:
    """Laplace is not differentiable at r = 0, so normal observations are
    refused for it (as in the JAX package)."""
    return name in ("rbf", "thin_plate", "inverse_multiquadric")


def dk_dr2(name: str, r2: torch.Tensor, params: Params) -> torch.Tensor:
    """dk/d(r2), elementwise; smooth at r2 = 0 for rbf, thin plate and IMQ."""
    ls = params["lengthscale"]
    sv = params["signal_variance"]
    if name == "rbf":
        inv2 = 1.0 / (ls * ls)
        return -0.5 * inv2 * sv * torch.exp(-0.5 * r2 * inv2)
    if name == "inverse_multiquadric":
        return -0.5 * sv * (r2 + ls * ls) ** (-1.5)
    if name == "thin_plate":
        # dk/dr = 6r^2 - 6Rr, so dk/dr2 = 3(r - R): smooth at r = 0.
        return sv * 3.0 * (_safe_sqrt(r2) - ls)
    if name == "laplace":
        r = _safe_sqrt(r2)
        return -0.5 * sv * torch.exp(-r / ls) / (ls * r)
    raise ValueError(f"unknown kernel {name!r}")


def d2k_dr2(name: str, r2: torch.Tensor, params: Params) -> torch.Tensor:
    """d2k/d(r2)^2, elementwise.  Thin plate's 1.5 sv / r is singular at
    r = 0; it only ever multiplies (x-x')(x-x')^T, and the callers mask the
    product there."""
    ls = params["lengthscale"]
    sv = params["signal_variance"]
    if name == "rbf":
        inv2 = 1.0 / (ls * ls)
        return 0.25 * inv2 * inv2 * sv * torch.exp(-0.5 * r2 * inv2)
    if name == "inverse_multiquadric":
        return 0.75 * sv * (r2 + ls * ls) ** (-2.5)
    if name == "thin_plate":
        return sv * 1.5 / _safe_sqrt(r2)
    raise ValueError(f"kernel {name!r} does not support second derivatives")
