"""Cholesky dispatch and triangular solves (port of
gpis_tpu/linalg/cholesky.py:37-66, 210-230).

`cholesky` factors IN PLACE: on a CUDA matrix of n >= 4096 it runs the
blocked factorization whose trailing updates are Kernel B
(`cuda_chol.blocked_cholesky`), identity-padded to the 256 block when n does
not tile (chol([[A,0],[0,I]]) = [[L,0],[0,I]], whose top-left n x n block
is copied out); otherwise the library
factorization.  Either way a matrix that is not positive definite comes back
with a NaN diagonal rather than an exception -- the signal of
`jnp.linalg.cholesky` that the jitter ladder in `gp.regression` checks.
The solves are `torch.linalg.solve_triangular`, as the JAX package leaves
them to XLA.
"""

from __future__ import annotations

import torch

from gpis_tpu_torch.linalg import cuda_chol

__all__ = ["cholesky", "solve_lower", "solve_lower_t", "cho_solve"]

_BLOCK = 256
_BLOCKED_MIN = 4096


def cholesky(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of SPD `a`.  The blocked path overwrites `a`,
    so the caller must not use `a` afterwards."""
    n = a.shape[0]
    if a.device.type == "cuda" and n >= _BLOCKED_MIN:
        if n % _BLOCK == 0:
            return cuda_chol.blocked_cholesky(a, _BLOCK)
        m = -(-n // _BLOCK) * _BLOCK
        ap = torch.zeros((m, m), dtype=a.dtype, device=a.device)
        ap[:n, :n] = a
        ap.diagonal()[n:] = 1.0
        del a
        # A row-major copy of the n x n factor: the row-band kernels take
        # no strided view.
        return cuda_chol.blocked_cholesky(ap, _BLOCK)[:n, :n].contiguous()
    l, info = torch.linalg.cholesky_ex(a)
    if int(info):
        l.diagonal().fill_(float("nan"))
    return l.contiguous()  # row-major, as the row-band kernels take it


def _as_matrix(b: torch.Tensor):
    return (b[:, None], True) if b.ndim == 1 else (b, False)


def solve_lower(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve L x = b with L lower-triangular. b: (n,) or (n, k)."""
    bm, vec = _as_matrix(b)
    x = torch.linalg.solve_triangular(l, bm, upper=False)
    return x[:, 0] if vec else x


def solve_lower_t(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve L^T x = b."""
    bm, vec = _as_matrix(b)
    x = torch.linalg.solve_triangular(l.T, bm, upper=True)
    return x[:, 0] if vec else x


def cho_solve(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve (L L^T) x = b."""
    return solve_lower_t(l, solve_lower(l, b))
