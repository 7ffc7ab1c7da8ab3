"""Float32 Kernels D and F (the QUAD epilogue of the tensor-core tile) on
the CPU: the planned quad against `staged_quad_reference` and
`quad_band_reference` at bands off the chunk, the plan's coverage unsplit
and deepest first, the modelled quad in the `_QSPLIT` regime, and one
running sum at C = 16,384 deep.
"""

import numpy as np
import pytest
import torch
import torch_exp_warm  # noqa: F401 -- warms torch.exp before any test (see the module)

from gpis_tpu_torch.gp import regression
from gpis_tpu_torch.kernels import cuda_query
from gpis_tpu_torch.kernels import functions as kf
from gpis_tpu_torch.linalg import cuda_chol
from torch_tc_model import (TILE, CHUNK, tc_nt_product, N_QS, PARAMS, _qsplit_problem,
                            _oracle_var, _check_plan, _box)


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """One intra-op thread for the module: the suite's workers share the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------- (g) Kernels D and F (QUAD)
# D (staged_quad) and F (fused_quad, quad_band) are the tile's NT layout with
# the QUAD epilogue: A = W (or a row band of it at global row row0), B = kq
# (F: generated), each 128-row tile of W over k up to its last global row + 1
# (`_tc_plan(upper="rows", k_offset=row0, whole=True)`), its product squared
# and summed over its rows into partial[m0 / 128, q], the partials then
# summed over the row tiles in order.


def _quad_plan(rows, m, width, row0):
    return cuda_chol._tc_plan(rows, m, width, upper="rows", k_offset=row0, whole=True)


def _planned_quad(w, kq, row0, product=None):
    """colsum((W kq^T)^2) as the kernel takes it: unit by unit along the
    QUAD plan, each unit reading W's and kq's boxes over its chunks (32 deep
    from k 0, so the last chunk runs past the tile's bound into W's zeros;
    zeros past W's width and past the rows and queries, as the tensor maps'
    extents), its tile squared and summed over its 128 rows into its
    partial row, the partials summed in row order.  `product(a, b)` is
    a @ b^T of a unit's boxes: exact in W's dtype by default."""
    rows, width = w.shape
    m = kq.shape[0]
    product = product or (lambda a, b: a @ b.T)
    units, finish, n_slots = _quad_plan(rows, m, width, row0)
    assert not finish and n_slots == 0
    partial = torch.full((-(-rows // TILE), m), float("nan"), dtype=w.dtype)
    for m0, n0, kb, ke, slot in units:
        assert slot == -1
        read = min(kb + CHUNK * -(-(ke - kb) // CHUNK), width)
        tile = product(_box(w, m0, kb, TILE, read - kb), _box(kq[:, :width], n0, kb, TILE,
                                                              read - kb))
        partial[m0 // TILE, n0:n0 + TILE] = (tile * tile).sum(0)[:m - n0]
    quad = torch.zeros((m,), dtype=w.dtype)
    for row in partial:
        quad = quad + row
    return quad


def _band_problem(rng, r, row0, m, c=None):
    """Rows [row0, row0 + r) of a lower-triangular W (zero past each row's
    global index), row i scaled by 1/sqrt(row0 + i + 1), stored trimmed to
    width row0 + r, and a kq (m, c >= width) from random points, float64."""
    width = row0 + r
    c = c or width
    w = np.tril(rng.normal(size=(r, width)), k=row0)
    w /= np.sqrt(np.arange(row0 + 1, row0 + r + 1))[:, None]
    cols = torch.as_tensor(rng.normal(size=(c, 3)))
    q = torch.as_tensor(rng.normal(size=(m, 3)))
    return torch.as_tensor(w), cols, q


# (R, row0): the D shape (a whole triangle, C 1,000 off the 128 tile) and
# bands at row0 0, 256 and 700 (off the 32-deep chunk), R 300 off the tile.
_QUAD_SHAPES = [(1000, 0), (256, 0), (300, 256), (300, 700), (128, 700)]


@pytest.mark.parametrize("r, row0", _QUAD_SHAPES)
def test_planned_quad_equals_the_twins_in_float64(r, row0):
    rng = np.random.default_rng(r + row0)
    w, cols, q = _band_problem(rng, r, row0, 300)
    params = kf.kernel_params(0.8, 1.0)
    kq = cuda_query.generated_kq("value", "rbf", q, cols, params)
    got = _planned_quad(w, kq, row0)
    want = cuda_query.quad_band_reference("value", "rbf", q, cols, params, w, row0)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=0)
    if row0 == 0:  # the whole triangle: Kernel D's twin
        alpha = torch.as_tensor(rng.normal(size=r))
        torch.testing.assert_close(got, cuda_query.staged_quad_reference(kq, w, alpha)[1],
                                   rtol=1e-12, atol=0)


def test_planned_quad_band_without_k_offset_misses_the_band():
    """The band's offset is what its bound leans on: planned with the
    in-core bound (k_offset 0) a band at row0 700 keeps only k < its row
    tile's local end, and loses most of every query's quad."""
    rng = np.random.default_rng(35)
    w, cols, q = _band_problem(rng, 300, 700, 200)
    kq = cuda_query.generated_kq("value", "rbf", q, cols, kf.kernel_params(0.8, 1.0))
    want = _planned_quad(w, kq, 700)
    units, _, _ = _quad_plan(300, 200, 1000, 0)
    assert max(ke for *_, ke, _ in units) == 384  # the in-core bound of rows [256, 300)
    got = torch.zeros_like(want)
    for m0, n0, kb, ke, _ in units:
        tile = w[m0:m0 + TILE, kb:ke] @ kq[n0:n0 + TILE, kb:ke].T
        got[n0:n0 + TILE] += (tile * tile).sum(0)
    assert ((want - got) / want).min() > 0.5


@pytest.mark.parametrize("rows, m, width, row0", [
    (16384, 8192, 16384, 0), (16384, 128, 16384, 0), (1000, 300, 1000, 0), (21504, 8192, 21504, 0),
    (4096, 8192, 32768, 28672), (1024, 8192, 20480, 19456), (1024, 8192, 16384, 15360),
    (300, 1000, 1000, 700), (128, 129, 384, 256), (16384, 4096, 16384, 0)])
def test_tc_plan_quad_covers_each_tile_once_unsplit_deepest_first(rows, m, width, row0):
    """D's (C x M at k_hi C) and F band's (R x M at width, k_offset row0)
    plans, at the session's shapes and ragged ones: every live (row tile,
    query tile, k) covered once (`_check_plan`), k never reaching row0 +
    m0 + 128, one unit a tile from k 0 at every shape -- no partial, no
    finish tile, whatever the count of tiles -- and the units deepest
    first."""
    units, finish, n_slots = _check_plan(rows, m, width, upper="rows", k_offset=row0,
                                         whole=True)
    assert n_slots == 0 and not finish
    assert len(units) == -(-rows // TILE) * -(-m // TILE)
    for m0, n0, kb, ke, slot in units:
        assert kb == 0 and slot == -1 and ke == min(row0 + m0 + TILE, width)
    depths = [ke - kb for *_, kb, ke, _ in units]
    assert depths == sorted(depths, reverse=True)
    # The live k summed over the plan: each row tile's triangle, per query tile.
    assert sum(depths) == -(-m // TILE) * sum(min(row0 + m0 + TILE, width)
                                             for m0 in range(0, rows, TILE))


def _model_quad(w, kq, **kw):
    """The float32 quad as the tile computes it: v = W kq^T through the
    model (`tc_nt_product` with one running sum, STORE: -(0 - v)), squared,
    summed over each 128-row tile and the tiles' partials summed in order,
    all in float32.  Steps past a tile's bound would add W's zeros, so the
    whole k range is taken at once."""
    v = -tc_nt_product(w, kq.T, torch.zeros((w.shape[0], kq.shape[0])), **kw)
    sq = v * v
    quad = torch.zeros((kq.shape[0],))
    for m0 in range(0, w.shape[0], TILE):
        quad = quad + sq[m0:m0 + TILE].sum(0)
    return quad


def test_tc_model_quad_in_the_qsplit_regime():
    """The quad through the modelled tile in the `_QSPLIT` regime: the
    float32 in-core fit's W and kq (C = 1,024, noise 1e-3), the variance
    k(0) - quad within 2e-3 of the float64 oracle and within 4x the float32
    twin's own error + 1e-6."""
    x, y, q = _qsplit_problem()
    torch.exp(torch.zeros(64))  # a process's first float32 exp can be ~1e-4 off on the CPU
    m = regression.fit_inference("rbf", x, y, torch.full((N_QS,), 1e-3), PARAMS)  # linv: W
    oracle = _oracle_var(x, m.noise, q)
    kq = cuda_query.stage_kq("rbf", q, m.x, m.params)
    twin = cuda_query.staged_quad_reference(kq, m.linv, m.alpha)[1]
    err_twin = np.abs((1.0 - twin).double().numpy() - oracle).max()
    errs = {}
    for name, kw in (("rounded", {}), ("truncated", {"round_steps": False}),
                     ("1xTF32", {"products": 1})):
        errs[name] = np.abs((1.0 - _model_quad(m.linv, kq, **kw)).double().numpy()
                            - oracle).max()
    print(f"\nQSPLIT max |var - f64 oracle|: f32 twin {err_twin:.3e}, "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    assert errs["rounded"] <= 2e-3
    assert errs["rounded"] <= 4.0 * err_twin + 1e-6, (errs, err_twin)
    assert errs["1xTF32"] > 2e-3  # the trap the split avoids


def test_tc_model_quad_one_running_sum_holds_at_c_16384():
    """The deepest tiles of D at C = 16,384 (rows 15,872 ... 16,383: k over
    all 16,384 columns, 2,048 steps), nonnegative W and kq: the quad of one
    running float32 sum (the kernel's QUAD) within 1e-4 of the float64 quad
    per query and within 2e-8 in the mean, as the 2,048-deep segments of
    NT's other epilogues; with the steps unrounded the mean reads low past
    2e-8.  So QUAD keeps one running sum and no second register tile."""
    gen = torch.Generator().manual_seed(36)
    k = 16384
    w = torch.rand((4 * TILE, k), generator=gen)
    kq = torch.rand((TILE, k), generator=gen)
    want = ((w.double() @ kq.double().T) ** 2).sum(0)
    stats = {}
    for name, kw in (("one running sum", {"segment": 0}), ("segments", {}),
                     ("one sum, truncated", {"segment": 0, "round_steps": False})):
        rel = (_model_quad(w, kq, **kw).double() - want) / want
        stats[name] = (rel.abs().max().item(), rel.mean().item())
    print("\nC 16,384 tile (max |rel|, mean rel): "
          + ", ".join(f"{n} {a:.3e} {b:.3e}" for n, (a, b) in stats.items()))
    for name in ("one running sum", "segments"):
        assert stats[name][0] <= 1e-4 and abs(stats[name][1]) <= 2e-8
    assert stats["one sum, truncated"][1] < -2e-8
