"""The work plan of float32 Kernels B, C, G and H (`cuda_chol._tc_plan`) on
the CPU: the plan covers C's live triangle, H's k range, B's panel across
j0 and every shape G is called at exactly once, on k-chunk bounds, and a
product taken unit by unit along the plan, with the partials summed in slot
order, equals the plain twin in float64 (for NT at k0 = 0, and in place,
too).
"""

import numpy as np
import pytest
import torch
import torch_exp_warm  # noqa: F401 -- warms torch.exp before any test (see the module)

from gpis_tpu_torch.linalg import cuda_chol
from torch_tc_model import TILE, _check_plan, _planned_product


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """One intra-op thread for the module: the suite's workers share the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------- (b) the plan


@pytest.mark.parametrize("j0", [256, 4096, 8192, 16128])
def test_nn_plan_covers_the_row_update_triangle_once(j0):
    # The in-core TRSM at C = 16,384, B = 256: rows 256, k and columns < j0.
    units, finish, n_slots = _check_plan(256, j0, j0, triangle=True, width=16384)
    live_depth = sum(ke - kb for _, _, kb, ke, _ in units)
    assert live_depth == 2 * sum(j0 - n0 for n0 in range(0, j0, TILE))
    if j0 == 8192:  # 128 tiles, under one wave: split into 1,024-deep units
        assert n_slots > 0 and max(ke - kb for _, _, kb, ke, _ in units) == 1024


@pytest.mark.parametrize("rows, j0, r0", [(8192, 24576, 7936), (8192, 24576, 256),
                                          (8192, 0, 4096), (4096, 16384, 3840),
                                          (1024, 19456, 768)])
def test_nn_plan_covers_the_trsm_finish_k_range_once(rows, j0, r0):
    # `_trsm_finish`: 256 rows at r0 of a sweep of `rows`, width j0 + rows,
    # k over the solved rows < r0.
    _check_plan(256, j0 + rows, r0)


@pytest.mark.parametrize("r, k, w", [(8192, 4096, 4096), (8192, 4096, 32768),
                                     (1024, 1024, 20480), (200, 384, 300)])
def test_nn_plan_covers_the_trsm_kstep_once(r, k, w):
    units, finish, n_slots = _check_plan(r, w, k)
    tiles = -(-r // TILE) * -(-w // TILE)
    if tiles >= 2 * 132:  # two waves of tiles or more: no split
        assert n_slots == 0 and not finish and len(units) == tiles


# ------------------------------------- (c) the plan's fixed-order split twin


@pytest.mark.parametrize("j0", [256, 700, 1024, 1536])
def test_planned_row_update_equals_the_twin_in_float64(j0):
    rng = np.random.default_rng(j0)
    n, bw = 2048, 200
    w = torch.as_tensor(np.tril(rng.normal(size=(n, n))))
    l_row = torch.as_tensor(rng.normal(size=(bw, n)))
    out = torch.full((bw, n), float("nan"), dtype=torch.float64)
    got = _planned_product(l_row, w, out, bw, j0, j0, triangle=True, width=n)
    want = cuda_chol.row_update_reference(w, l_row, j0)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("r, k, w, width", [(200, 384, 300, 640), (2048, 256, 2304, 2304),
                                            (256, 1000, 1024, 1280), (256, 768, 2560, 2816)])
def test_planned_gemm_nn_acc_masked_equals_the_twin_in_float64(r, k, w, width):
    rng = np.random.default_rng(r + k + w)
    a = torch.as_tensor(rng.normal(size=(r, k)))
    b = torch.as_tensor(rng.normal(size=(k, width)))
    u = torch.as_tensor(rng.normal(size=(r, width)))
    got = _planned_product(a, b, u.clone()[:, :w], r, w, k, add=True)
    want = cuda_chol.gemm_nn_acc_masked_reference(u.clone(), a, b, w)[:, :w]
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("j0, bw", [(256, 256), (700, 200), (1024, 256), (1792, 256)])
def test_planned_panel_update_in_place_equals_the_twin_in_float64(j0, bw):
    # B: G in place on the one matrix, S = out = m[j0:, j0:j0+bw]; the units
    # read m as it stands, so a write at columns < j0 would show.
    rng = np.random.default_rng(j0 + bw)
    n = 2048
    m = torch.as_tensor(rng.normal(size=(n, n))) / j0**0.5  # products O(1), as in chip_smoke
    want = cuda_chol.panel_update_reference(m.clone(), j0, bw)
    got = m.clone()
    panel = got[j0:, j0:j0 + bw]
    _planned_product(got[j0:, :j0], got[j0:j0 + bw, :j0], panel, n - j0, bw, j0, nt=True,
                     s=panel)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("r, p, k0, lead", [(320, 200, 0, 1000), (320, 200, 300, 1000),
                                            (2048, 256, 1536, 2048), (200, 384, 896, 1024)])
def test_planned_gemm_nt_masked_equals_the_twin_in_float64(r, p, k0, lead):
    # G's k-step operands: the band, a trimmed panel, a stripe of the band as
    # S; k0 0: no unit, the finish tiles copy S.
    rng = np.random.default_rng(r + p + k0)
    cur = torch.as_tensor(rng.normal(size=(r, lead)))
    lk = torch.as_tensor(rng.normal(size=(p, lead)))
    s = cur[:, lead - p:]
    out = torch.full((r, p), float("nan"), dtype=torch.float64)
    got = _planned_product(cur, lk, out, r, p, k0, nt=True, s=s)
    want = cuda_chol.gemm_nt_masked_reference(cur, lk, s, k0)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
    if k0 == 0:
        assert torch.equal(got, s)


def test_planned_gemm_nt_masked_at_chol_diag_equals_the_twin_in_float64():
    # `_chol_diag`: a = b = the band, S its columns [j0, j0 + R).
    rng = np.random.default_rng(31)
    r, j0 = 512, 1536
    cur = torch.as_tensor(rng.normal(size=(r, j0 + r))) / j0**0.5
    s = cur[:, j0:]
    out = torch.full((r, r), float("nan"), dtype=torch.float64)
    got = _planned_product(cur, cur, out, r, r, j0, nt=True, s=s)
    torch.testing.assert_close(got, cuda_chol.gemm_nt_masked_reference(cur, cur, s, j0),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("j0", [256, 4096, 8192, 12288, 16128])
def test_tc_plan_covers_the_panel_update_once(j0):
    # B in the in-core factor at C = 16,384, B = 256: rows n - j0, k < j0.
    n, bw = 16384, 256
    units, finish, n_slots = _check_plan(n - j0, bw, j0)
    assert sum(ke - kb for _, _, kb, ke, _ in units) == -(-(n - j0) // TILE) * 2 * j0
    if j0 == 8192:  # 128 tiles, under one wave: split into 2,048-deep units
        assert n_slots == 512 and max(ke - kb for _, _, kb, ke, _ in units) == 2048


@pytest.mark.parametrize("rows, cols, k0", [
    (8192, 4096, 0), (8192, 4096, 4096), (8192, 4096, 28672),  # `_chol_kstep`, phase 7
    (8192, 256, 0), (8192, 256, 256), (8192, 256, 3840),      # `_trsm_right_blocked`
    (8192, 8192, 24576), (1024, 1024, 19456), (256, 256, 768),  # `_chol_diag`
    (16128, 256, 256), (8192, 256, 8192), (256, 256, 16128)])   # `sharded_cholesky`, P = 1
def test_tc_plan_covers_every_gemm_nt_masked_shape_once(rows, cols, k0):
    units, finish, n_slots = _check_plan(rows, cols, k0)
    tiles = -(-rows // TILE) * -(-cols // TILE)
    if k0 == 0:  # no unit: every tile's finish copies S
        assert not units and len(finish) == tiles and n_slots == 0
    elif tiles >= 2 * 132:
        assert n_slots == 0 and len(units) == tiles
