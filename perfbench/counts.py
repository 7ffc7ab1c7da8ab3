"""The algorithm's operations and bytes, and the card's published peaks.

These count the work the mathematics needs, not what an implementation
does, so a share reads the same whatever computes it: a triangular factor
is multiplied by its triangle, a symmetric Gram is written as its lower
triangle, and every input byte is read once and every output byte written
once.  A share of a roofline is then at most 100 %.

Sizes: c value observations, j = c + 3 n_s joint observations (gradients
at the n_s surface points), m queries; float32 (4 bytes).
"""

from __future__ import annotations

__all__ = ["PEAKS", "cholesky_flops", "trinv_flops", "alpha_flops", "quad_flops", "quad_bytes",
           "mean_flops", "cov_flops", "cov_bytes", "gram_flops", "gram_bytes", "bound_s",
           "surface_flops"]

# NVIDIA H100 SXM (80 GB HBM3) data sheet, dense rates: TF32 tensor-core
# products (the highest rate at which the card takes float32 inputs to a
# product), float32 outside the tensor cores, HBM bandwidth.
PEAKS = {"product_flops": 495e12, "fp32_flops": 67e12, "hbm_bytes": 3.35e12}

F32 = 4
# Squared distance (3 subtractions, 3 multiplications, 2 additions) and the
# exponent's scaling: the least arithmetic a covariance entry needs.
COV_ENTRY_FLOPS = 9


def cholesky_flops(c: int) -> float:
    """L L^T = K (c x c): c^3 / 3."""
    return c**3 / 3.0


def trinv_flops(c: int) -> float:
    """W = L^{-1} of a lower triangle: c^3 / 3."""
    return c**3 / 3.0


def alpha_flops(c: int) -> float:
    """alpha = W^T (W y): two triangular products, 2 c^2."""
    return 2.0 * c**2


def quad_flops(m: int, c: int) -> float:
    """|W k_q|^2 for m queries, W lower triangular: row i of W has i + 1
    entries, a multiply and an add each, so c (c + 1) a query (the squares
    and their sum, 2 c more, are left out: they are not products)."""
    return float(m) * c * (c + 1)


def quad_bytes(m: int, c: int) -> float:
    """W's triangle and the m x c cross-covariance read once, m variances
    written."""
    return F32 * (c * (c + 1) / 2.0 + m * c + m)


def mean_flops(m: int, c: int) -> float:
    """k_q alpha for m queries: 2 m c."""
    return 2.0 * m * c


def cov_flops(m: int, n: int) -> float:
    """An m x n cross-covariance's entries."""
    return float(COV_ENTRY_FLOPS) * m * n


def cov_bytes(m: int, n: int) -> float:
    """Both point sets read (3 coordinates each), the m x n block written."""
    return F32 * (3.0 * (m + n) + m * n)


def gram_flops(c: int) -> float:
    """A symmetric c x c Gram's lower triangle."""
    return float(COV_ENTRY_FLOPS) * c * (c + 1) / 2.0


def gram_bytes(c: int) -> float:
    """The points and the noise read, the lower triangle written."""
    return F32 * (4.0 * c + c * (c + 1) / 2.0)


def bound_s(product_flops: float = 0.0, fp32_flops: float = 0.0, nbytes: float = 0.0):
    """The least time on the card and what binds it: (seconds, "products" |
    "fp32" | "bytes")."""
    parts = {"products": product_flops / PEAKS["product_flops"],
             "fp32": fp32_flops / PEAKS["fp32_flops"], "bytes": nbytes / PEAKS["hbm_bytes"]}
    binds = max(parts, key=parts.get)
    return parts[binds], binds


def surface_flops(c: int, m: int) -> float:
    """The products of one surface: factor, W, alpha, the m-query quad and
    mean, over c (value) or j (joint) observations."""
    return (cholesky_flops(c) + trinv_flops(c) + alpha_flops(c) + quad_flops(m, c)
            + mean_flops(m, c))
