"""Kernels B and C (csrc/chol.cu) and the left-looking blocked Cholesky and
TRSM that loop them (port of gpis_tpu/linalg/pallas_chol.py:87-185, 502-687).

* `panel_update(m, j0, block)` -- Kernel B, replacing `panel_update_pallas`:
  m[j0:, j0:j0+B] -= m[j0:, :j0] @ m[j0:j0+B, :j0]^T, in place.
* `row_update(w, l_row, j0)` -- Kernel C, replacing `row_update_pallas`:
  l_row[:, :j0] @ w[:j0, :], columns >= j0 zero.

Both are bound by FP32 arithmetic on the card; csrc/chol.cu says how their
loops skip the dead half of each product.  Around them, as in the JAX
package, the B x B potrf (`torch.linalg.cholesky_ex`) and the panel and row
triangular solves (`torch.linalg.solve_triangular`) stay library calls.

Each wrapper takes a CPU tensor to its plain twin (`*_reference`) and a CUDA
tensor to its kernel, and raises on anything the kernel does not take.
"""

from __future__ import annotations

import torch

from gpis_tpu_torch import _build

__all__ = ["panel_update", "panel_update_reference", "row_update", "row_update_reference",
           "blocked_cholesky", "blocked_linv"]


def _check_square(what: str, m: torch.Tensor) -> int:
    if m.ndim != 2 or m.shape[0] != m.shape[1]:
        raise ValueError(f"{what}: expected a square matrix, got {tuple(m.shape)}")
    return m.shape[0]


def panel_update_reference(m: torch.Tensor, j0: int, block: int) -> torch.Tensor:
    """Plain twin of Kernel B (in place on m; returns m)."""
    if j0 > 0:
        m[j0:, j0:j0 + block] -= m[j0:, :j0] @ m[j0:j0 + block, :j0].T
    return m


def panel_update(m: torch.Tensor, j0: int, block: int) -> torch.Tensor:
    """Trailing update of column panel [j0, j0+block) from the finished
    columns < j0, in place on m for rows >= j0 (rows above j0 untouched)."""
    n = _check_square("panel_update", m)
    if not 0 <= j0 < n or block <= 0 or j0 + block > n:
        raise ValueError(f"panel_update: panel [{j0}, {j0 + block}) outside {n}")
    if m.device.type == "cpu":
        return panel_update_reference(m, j0, block)
    _build.check_cuda_args("panel_update", m)
    if j0 == 0:  # no finished columns: nothing to subtract, nothing launched
        return m
    _build.call("gpis_panel_update", m, m.data_ptr(), n, j0, block)
    _build.LAUNCHES["panel_update"] += 1
    return m


def row_update_reference(w: torch.Tensor, l_row: torch.Tensor, j0: int) -> torch.Tensor:
    """Plain twin of Kernel C."""
    out = torch.zeros_like(l_row)
    if j0 > 0:
        out[:, :j0] = l_row[:, :j0] @ w[:j0, :j0]
    return out


def row_update(w: torch.Tensor, l_row: torch.Tensor, j0: int) -> torch.Tensor:
    """L_row[:, :j0] @ W[:j0, :] for a W whose rows < j0 are finished and
    lower-triangular; columns >= j0 of the (B, n) result are zero.  l_row
    may be a row band of w itself (the in-place TRSM)."""
    n = _check_square("row_update", w)
    if l_row.ndim != 2 or l_row.shape[1] != n:
        raise ValueError(f"row_update: l_row must be (B, {n}), got {tuple(l_row.shape)}")
    if not 0 <= j0 <= n:
        raise ValueError(f"row_update: j0={j0} outside [0, {n}]")
    if w.device.type == "cpu":
        return row_update_reference(w, l_row, j0)
    _build.check_cuda_args("row_update", w, l_row)
    if j0 == 0:  # W[:0] is empty: the update is zero, nothing launched
        return torch.zeros_like(l_row)
    out = torch.empty_like(l_row)
    _build.call("gpis_row_update", w, l_row.data_ptr(), w.data_ptr(), n, j0,
                l_row.shape[0], out.data_ptr())
    _build.LAUNCHES["row_update"] += 1
    return out


def _potrf(d: torch.Tensor):
    """Lower factor of a B x B block and whether it is positive definite."""
    ld, info = torch.linalg.cholesky_ex(d)
    return ld, int(info) == 0


def blocked_cholesky(a: torch.Tensor, block: int = 256) -> torch.Tensor:
    """Left-looking blocked Cholesky, IN PLACE: a is overwritten by its lower
    factor L (strict upper triangle zero) and returned -- peak memory is the
    one matrix.  A non-positive-definite panel leaves a NaN diagonal, the
    signal the jitter ladder checks (`jnp.linalg.cholesky` returns NaN where
    `torch.linalg.cholesky` would raise)."""
    n = _check_square("blocked_cholesky", a)
    if n % block:
        raise ValueError(f"matrix size {n} must be a multiple of block {block}")
    for j0 in range(0, n, block):
        j1 = j0 + block
        panel_update(a, j0, block)
        ld, ok = _potrf(a[j0:j1, j0:j1])
        if not ok:
            a.diagonal().fill_(float("nan"))
            return a
        if j1 < n:
            # X ld^T = A_below  ->  X = A_below ld^{-T}
            a[j1:, j0:j1] = torch.linalg.solve_triangular(ld.T, a[j1:, j0:j1], upper=True,
                                                          left=False)
        a[j0:j1, j0:j1] = ld
        a[:j0, j0:j1] = 0.0
    return a


def blocked_linv(l: torch.Tensor, block: int = 256, *, inplace: bool = False) -> torch.Tensor:
    """W = L^{-1} by the left-looking blocked TRSM

        for block row j:  W[j, :] = Ljj^{-1} (I[j, :] - L[j, :j0] W[:j0, :])

    whose row update is Kernel C.  W comes out lower-triangular.
    inplace=True overwrites L with W row band by row band (step j reads L's
    row panel j and the finished W rows < j0 from the same buffer), so peak
    memory is one matrix; the caller loses L."""
    n = _check_square("blocked_linv", l)
    if n % block:
        raise ValueError(f"matrix size {n} must be a multiple of block {block}")
    w = l if inplace else torch.zeros_like(l)
    for j0 in range(0, n, block):
        j1 = j0 + block
        l_row = l[j0:j1]  # L's row panel (still L in the in-place buffer)
        upd = row_update(w, l_row, j0)
        rhs = -upd[:, :j1]
        rhs[:, j0:j1] += torch.eye(block, dtype=l.dtype, device=l.device)
        wj = torch.linalg.solve_triangular(l_row[:, j0:j1], rhs, upper=False)
        w[j0:j1, :j1] = wj
        w[j0:j1, j1:] = 0.0
    return w
