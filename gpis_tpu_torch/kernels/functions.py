"""Covariance functions of squared distance (port of
gpis_tpu/kernels/functions.py).

The four built-in kernels -- rbf, laplace, inverse_multiquadric and the
compactified thin plate `2r^3 - 3Rr^2 + R^3` -- as elementwise torch math on
r2.  The CUDA tile kernels (csrc/common.cuh `k_r2`, `k_diag0`) compute the
same expressions in the same order.  Hyperparameters are a plain dict
{"lengthscale", "signal_variance"} of Python floats or 0-d tensors; for the
thin plate the lengthscale is the scale R.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

__all__ = ["KERNEL_NAMES", "kernel_params", "k_r2", "k_diag0"]

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
