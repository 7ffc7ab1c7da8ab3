"""Gram and cross-covariance assembly (port of gpis_tpu/kernels/gram.py).

`gram` and `cross_cov` go through Kernel A (`cuda_gram.cov`): on a CUDA
tensor the kernel runs, on a CPU tensor its plain twin.  Unlike the JAX
package, nothing here catches a failed kernel and quietly takes the plain
form instead: a kernel error raises.
"""

from __future__ import annotations

import torch

from gpis_tpu_torch.kernels import cuda_gram
from gpis_tpu_torch.kernels.cuda_gram import pairwise_r2

__all__ = ["pairwise_r2", "gram", "gram_reference", "cross_cov", "add_noise_diag"]


def _noise_vector(noise, n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(noise, dtype=like.dtype, device=like.device).broadcast_to((n,)).contiguous()


def gram(name: str, x: torch.Tensor, params, noise=None) -> torch.Tensor:
    """Symmetric Gram K(X,X) [+ diag(noise)]; noise is a scalar or (N,)."""
    if noise is not None:
        noise = _noise_vector(noise, x.shape[0], x)
    return cuda_gram.cov(name, x, x, params, noise=noise, sym=True)


def gram_reference(name: str, x: torch.Tensor, params, noise=None) -> torch.Tensor:
    """Plain-PyTorch Gram on any device (exact k(0) on the diagonal)."""
    if noise is not None:
        noise = _noise_vector(noise, x.shape[0], x)
    return cuda_gram.cov_reference(name, x, x, params, noise=noise, sym=True)


def cross_cov(name: str, q: torch.Tensor, x: torch.Tensor, params) -> torch.Tensor:
    """Cross-covariance K(Q, X): q (M,3) queries against x (N,3)."""
    return cuda_gram.cov(name, q, x, params)


def add_noise_diag(k: torch.Tensor, noise) -> torch.Tensor:
    return k + torch.diag(_noise_vector(noise, k.shape[0], k))
