"""The algorithm's operations and bytes on one rank of the row-sharded
pipeline: the rank's band, global rows [r0, r1) of a lower-triangular
c x c factor L and of W = L^{-1}, block columns `block` wide.

As in `perfbench.counts`, these count the work the mathematics needs for
that band, each input byte read once and each output byte written once,
so that a share of a roofline is at most 100 %.  Sizes as there (float32).
"""

from __future__ import annotations

from perfbench.counts import F32

__all__ = ["band_quad_flops", "band_quad_bytes", "panel_flops", "panel_bytes"]


def _tri(r0: int, r1: int) -> float:
    """Entries of rows [r0, r1) of a lower triangle, diagonal included:
    row i has i + 1."""
    return (r1 * (r1 + 1) - r0 * (r0 + 1)) / 2.0


def band_quad_flops(m: int, r0: int, r1: int) -> float:
    """The band's share of |W k_q|^2 for m queries: rows [r0, r1) of W
    against each k_q, a multiply and an add an entry of W's triangle."""
    return 2.0 * m * _tri(r0, r1)


def band_quad_bytes(m: int, r0: int, r1: int) -> float:
    """The band's triangle and the m x r1 cross-covariance it meets read
    once, m partial sums written."""
    return F32 * (_tri(r0, r1) + m * r1 + m)


def panel_flops(r0: int, r1: int, block: int) -> float:
    """The left-looking factor's panel updates on the band: at block column
    j0, the band's rows at or below j0 take the product of their first j0
    columns with the block row's, 2 j0 a multiply and an add an entry of
    the block column."""
    total = 0.0
    for j0 in range(0, r1, block):
        total += 2.0 * j0 * min(block, r1 - j0) * (r1 - max(r0, j0))
    return total


def panel_bytes(r0: int, r1: int) -> float:
    """The band's triangle read and written once."""
    return 2.0 * F32 * _tri(r0, r1)
