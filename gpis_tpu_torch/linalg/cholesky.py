"""Cholesky dispatch, the blocked factor and TRSM under the JAX names, the
differentiable blocked factor of the marginal likelihood, and triangular
solves (port of gpis_tpu/linalg/cholesky.py).

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

`blocked_cholesky` and `blocked_linv` are the JAX package's names for the
left-looking loops of `cuda_chol` (Kernels B and C on a card, their twins on
the CPU), returning new matrices as the JAX ones do.  `blocked_cholesky_ad`
is the factor the marginal likelihood differentiates at C >= 4096 on a
card: a `torch.autograd.Function` whose forward is Kernel B's in-place
factor and whose backward is the standard pullback by two triangular solves
(`Abar = sym(L^-T Phi(L^T Lbar) L^-1)`), so the graph holds L alone.
"""

from __future__ import annotations

import torch

from gpis_tpu_torch.linalg import cuda_chol
from gpis_tpu_torch.utils import profiling

__all__ = ["cholesky", "blocked_cholesky", "blocked_cholesky_ad", "blocked_linv", "solve_lower",
           "solve_lower_t", "cho_solve"]

_BLOCK = 256
_BLOCKED_MIN = 4096


def cholesky(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of SPD `a`.  The blocked path overwrites `a`,
    so the caller must not use `a` afterwards."""
    with profiling.span("chol.factor", device=a.device):
        return _cholesky(a)


def _cholesky(a: torch.Tensor) -> torch.Tensor:
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
    with profiling.wait("chol.info"):
        failed = int(info)
    if failed:
        l.diagonal().fill_(float("nan"))
    return l.contiguous()  # row-major, as the row-band kernels take it


def blocked_cholesky(a: torch.Tensor, block: int = 256, *, precision=None) -> torch.Tensor:
    """Lower Cholesky factor of `a` by the left-looking blocked loop
    (`cuda_chol.blocked_cholesky`: Kernel B's trailing updates on a card),
    into a new matrix; `a` is left as it was.  A block that is not positive
    definite leaves a NaN diagonal.  `precision` is the JAX package's XLA
    product precision; every value takes the same route here (float32
    products are the split-TF32 tile's, TF32 off elsewhere)."""
    if a.shape[0] % block:
        raise ValueError(f"matrix size {a.shape[0]} must be a multiple of block {block}")
    return cuda_chol.blocked_cholesky(a.clone(memory_format=torch.contiguous_format), block)


def blocked_linv(l: torch.Tensor, block: int = 512, *, precision=None) -> torch.Tensor:
    """W = L^{-1} by the left-looking blocked TRSM (`cuda_chol.blocked_linv`:
    Kernel C's row updates on a card) into a new matrix.  `precision` as in
    `blocked_cholesky`."""
    if l.shape[0] % block:
        raise ValueError(f"matrix size {l.shape[0]} must be a multiple of block {block}")
    return cuda_chol.blocked_linv(l.contiguous(), block)


class _BlockedCholeskyAD(torch.autograd.Function):
    """Kernel B's in-place factor with the Cholesky pullback
    (gpis_tpu/linalg/cholesky.py:146-178)."""

    @staticmethod
    def forward(ctx, a, block):
        # The factor overwrites a: the graph keeps only L, and the Gram's own
        # backward (`gram_ad`) never reads the Gram it produced.
        with profiling.span("chol.factor", device=a.device):
            l = cuda_chol.blocked_cholesky(a, block)
        ctx.mark_dirty(a)
        ctx.save_for_backward(l)
        return l

    @staticmethod
    def backward(ctx, lbar):
        (l,) = ctx.saved_tensors
        p = l.T @ lbar
        phi = torch.tril(p) - 0.5 * torch.diag(torch.diagonal(p))
        del p
        x1 = torch.linalg.solve_triangular(l.T, phi, upper=True)  # L^-T Phi
        del phi
        abar = torch.linalg.solve_triangular(l.T, x1.T, upper=True).T  # (L^-T x1^T)^T
        del x1
        return 0.5 * (abar + abar.T), None


def blocked_cholesky_ad(a: torch.Tensor, block: int = 256) -> torch.Tensor:
    """Differentiable blocked Cholesky, IN PLACE on `a` (a non-leaf tensor,
    such as `gram_ad`'s output, whose storage becomes L).  The forward is
    `cuda_chol.blocked_cholesky` (Kernel B on a card, its twin on the CPU);
    a matrix that is not positive definite comes back with a NaN diagonal,
    as `jnp.linalg.cholesky` does, not with an exception.  The backward
    needs L alone: O(n^2) memory where the library factor's AD keeps its
    own workspace."""
    n = a.shape[0]
    if n % block:
        raise ValueError(f"matrix size {n} must be a multiple of block {block}")
    return _BlockedCholeskyAD.apply(a, block)


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
