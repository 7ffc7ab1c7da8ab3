"""The operation and byte counts at small shapes, counted by hand."""

import pytest

from perfbench import counts


def test_factor_and_solve_counts():
    # c = 6: c^3 / 3 = 72 for the factor and for W; alpha 2 c^2 = 72.
    assert counts.cholesky_flops(6) == 72.0
    assert counts.trinv_flops(6) == 72.0
    assert counts.alpha_flops(6) == 72.0


@pytest.mark.parametrize("m,c,flops,nbytes", [
    # Value quad, c = 3: W's rows hold 1, 2, 3 entries, a multiply and an add
    # each: 12 a query; W's triangle (6) + k_q (2 x 3) + 2 outputs = 14 floats.
    (2, 3, 24.0, 56.0),
    # Joint quad, j = 4 + 3 * 2 = 10 observed rows, one query: 10 * 11 = 110;
    # triangle 55 + k_q 10 + 1 output = 66 floats.
    (1, 10, 110.0, 264.0),
])
def test_quad_counts(m, c, flops, nbytes):
    assert counts.quad_flops(m, c) == flops
    assert counts.quad_bytes(m, c) == nbytes


def test_mean_and_covariance_counts():
    assert counts.mean_flops(2, 3) == 12.0  # 2 queries x 3 columns, multiply and add
    # A 2 x 3 cross-covariance: 9 flops an entry; 5 points x 3 coordinates
    # read and 6 entries written: 21 floats.
    assert counts.cov_flops(2, 3) == 54.0
    assert counts.cov_bytes(2, 3) == 84.0
    # A 3 x 3 Gram's lower triangle: 6 entries; 3 points x (3 + 1 noise) read.
    assert counts.gram_flops(3) == 54.0
    assert counts.gram_bytes(3) == 72.0


def test_surface_flops_sum():
    c, m = 4, 5
    want = 64 / 3 + 64 / 3 + 32 + 5 * 4 * 5 + 2 * 5 * 4
    assert counts.surface_flops(c, m) == pytest.approx(want)


def test_bound_names_what_binds():
    t, binds = counts.bound_s(product_flops=495e12, nbytes=3.35e12 / 2)
    assert (t, binds) == (1.0, "products")
    t, binds = counts.bound_s(fp32_flops=67e12 / 4, nbytes=3.35e12)
    assert (t, binds) == (1.0, "bytes")
