"""Float32 Kernels J and K (the `panel_solve="inv"` route) on the CPU:
`_tc_plan`'s per-tile upper bound (V's triangle) at every step of the
C = 16,384 factor and TRSM and at ragged B, the plans of B, C, G and H
unchanged by it, the planned products against the twins, the model's bias
with and without the step rounding, the inv route through the model in
the `_QSPLIT` regime, and `_check_tma` on every J and K view.
"""

import numpy as np
import pytest
import torch
import torch_exp_warm  # noqa: F401 -- warms torch.exp before any test (see the module)

from gpis_tpu_torch.gp import regression
from gpis_tpu_torch.kernels import functions as kf
from gpis_tpu_torch.linalg import cuda_chol
from gpis_tpu_torch.linalg import outofcore as ooc
from torch_tc_model import (TILE, CHUNK, tc_product, _model_routes, _model_nt_routes, N_QS,
                            PARAMS, _qsplit_problem, _oracle_var, _fit_var, _check_plan,
                            _planned_product)


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """One intra-op thread for the module: the suite's workers share the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------ (e) Kernels J and K
# J (panel_scale, acc V^T) is the tile's NT layout with STORE, K (row_scale,
# V rhs) its NN layout with STORE; V = Ljj^{-1} is lower-triangular, and each
# tile's k range ends after its last column (J) or row (K).


C_FIT, B_INV = 16384, 256


# The plans of C, H, B and G at every shape the tests above cover (in their
# order: C's triangle, H's TRSM finish and k-step, B across j0, G's
# shapes), before the per-tile upper bound came in: the bound must not move
# them (C's and H's bits are held on the card by chip_smoke's sha256).
_EARLIER_PLANS = (
    [((256, j0, j0), dict(triangle=True, width=16384))
     for j0 in (256, 4096, 8192, 16128, 700, 1024, 1536)]
    + [((256, j0 + rows, r0), {}) for rows, j0, r0 in
       ((8192, 24576, 7936), (8192, 24576, 256), (8192, 0, 4096), (4096, 16384, 3840),
        (1024, 19456, 768))]
    + [((r, w, k), {}) for r, k, w in
       ((8192, 4096, 4096), (8192, 4096, 32768), (1024, 1024, 20480), (200, 384, 300))]
    + [((16384 - j0, 256, j0), {}) for j0 in (256, 4096, 8192, 12288, 16128)]
    + [(shape, {}) for shape in
       ((8192, 4096, 0), (8192, 4096, 4096), (8192, 4096, 28672), (8192, 256, 0),
        (8192, 256, 256), (8192, 256, 3840), (8192, 8192, 24576), (1024, 1024, 19456),
        (256, 256, 768), (16128, 256, 256), (8192, 256, 8192), (256, 256, 16128))])


_EARLIER_PLANS_SHA256 = "ff0bc6be9aee143724ac12f45f95e3223602af88c02d4244d173ed6038e948ad"


def test_tc_plans_of_c_h_b_and_g_are_unchanged_by_the_upper_bound():
    import hashlib

    h = hashlib.sha256()
    for args, kw in _EARLIER_PLANS:
        h.update(repr(cuda_chol._tc_plan(*args, **kw)).encode())
    assert h.hexdigest() == _EARLIER_PLANS_SHA256


def _check_inv_plan(rows, cols, b, upper):
    """J's or K's plan: V's live triangle covered exactly once (`_check_plan`
    with the per-tile bound), each tile one unit over [0, its bound) -- no
    unit cut, no partials, no finish tile -- and every output's own k range
    [0, its column (J) or row (K) + 1) inside its tile's."""
    units, finish, n_slots = _check_plan(rows, cols, b, upper=upper)
    assert n_slots == 0 and not finish
    assert len(units) == -(-rows // TILE) * -(-cols // TILE)
    for m0, n0, kb, ke, slot in units:
        assert kb == 0 and slot == -1 and ke <= b
        last = min(n0 if upper == "cols" else m0, b) + TILE - 1  # the tile's last column / row
        assert ke >= min(last, b - 1) + 1
    return units


@pytest.mark.parametrize("kernel", ["J", "K"])
def test_tc_plan_upper_bound_covers_v_once_at_every_step(kernel):
    """J at every step of the C = 16,384 factor (R = 16,128 ... 256) and K
    at every step of its TRSM (N = j1 = 256 ... 16,384): the live k of the
    triangle is summed once; the depth is one 256 block, so no unit is cut,
    whatever the count of tiles."""
    live = 0
    for j1 in range(B_INV, C_FIT + 1, B_INV):
        if kernel == "J" and j1 < C_FIT:
            units = _check_inv_plan(C_FIT - j1, B_INV, B_INV, "cols")
        elif kernel == "K":
            units = _check_inv_plan(B_INV, j1, B_INV, "rows")
        else:
            continue
        live += sum(ke - kb for *_, kb, ke, _ in units)
    # J: per 128-row tile, the column tiles read 128 + 256 deep; K: per
    # 128-column tile, the row tiles read the same.
    tiles = (sum(-(-(C_FIT - j1) // TILE) for j1 in range(B_INV, C_FIT, B_INV)) if kernel == "J"
             else sum(j1 // TILE for j1 in range(B_INV, C_FIT + 1, B_INV)))
    assert live == tiles * (TILE + 2 * TILE)


@pytest.mark.parametrize("rows, cols, b, upper", [
    (16128, 200, 200, "cols"), (300, 200, 200, "cols"), (192, 1000, 192, "rows"),
    (192, 16384, 192, "rows"), (100, 96, 96, "cols"), (64, 300, 64, "rows")])
def test_tc_plan_upper_bound_at_ragged_b_stops_at_the_last_live_column(rows, cols, b, upper):
    # B 200 (J) and 192 (K): not multiples of 128 or of the 32-deep chunk;
    # the tile holding column (row) b - 1 ends at b, not at the next chunk.
    units = _check_inv_plan(rows, cols, b, upper)
    assert max(ke for *_, ke, _ in units) == b


@pytest.mark.parametrize("k_hi", [32, 200, 256])
@pytest.mark.parametrize("upper", [None, "cols", "rows"])
def test_tc_plan_cuts_no_unit_at_depth_256_or_less(k_hi, upper):
    # One tile, four tiles, many tiles: under two waves the plan splits only
    # what is deeper than TC_DEPTH.
    for rows, cols in ((128, 128), (256, 256), (4096, 256), (256, 4096)):
        units, finish, n_slots = cuda_chol._tc_plan(rows, cols, k_hi, upper=upper)
        assert n_slots == 0 and all(slot == -1 for *_, slot in units)
    assert cuda_chol.TC_DEPTH == 256


def test_tc_plan_refuses_an_unknown_upper_bound():
    with pytest.raises(ValueError, match="upper"):
        cuda_chol._tc_plan(256, 256, 256, upper="diag")


def _lower_inv(rng, b):
    g = rng.normal(size=(b, b))
    ld = np.linalg.cholesky(g @ g.T / b + np.eye(b))
    return torch.as_tensor(np.linalg.solve(ld, np.eye(b)) * np.tri(b))


@pytest.mark.parametrize("n, j0, b", [(1024, 0, 256), (1024, 512, 256), (1000, 200, 200),
                                      (600, 0, 200), (768, 256, 256)])
def test_planned_panel_scale_equals_the_twin_in_float64(n, j0, b):
    # J at the factor's views: the strided panel below block j0; B 200 ragged.
    rng = np.random.default_rng(n + j0 + b)
    a = torch.as_tensor(rng.normal(size=(n, n)))
    v = _lower_inv(rng, b)
    acc = a[j0 + b:, j0:j0 + b]
    out = torch.full(acc.shape, float("nan"), dtype=torch.float64)
    got = _planned_product(acc, v, out, acc.shape[0], b, b, nt=True, upper="cols")
    torch.testing.assert_close(got, cuda_chol.panel_scale_reference(acc, v), rtol=0, atol=1e-12)


@pytest.mark.parametrize("b, n", [(256, 1024), (256, 256), (192, 1000), (192, 64), (256, 4096)])
def test_planned_row_scale_equals_the_twin_in_float64(b, n):
    # K: B 192 ragged; N from a step's j1.
    rng = np.random.default_rng(b + n)
    v = _lower_inv(rng, b)
    rhs = torch.as_tensor(rng.normal(size=(b, n + 100)))[:, 50:50 + n]
    out = torch.full((b, n), float("nan"), dtype=torch.float64)
    got = _planned_product(v, rhs, out, b, n, b, upper="rows")
    torch.testing.assert_close(got, cuda_chol.row_scale_reference(v, rhs), rtol=0, atol=1e-12)


def test_planned_panel_scale_with_a_short_bound_misses_the_triangle():
    """The bound is what the planned product leans on: one chunk short of
    the tile's last column, the sums of the last 32 columns of each tile
    lose their deepest terms."""
    rng = np.random.default_rng(33)
    acc, v = torch.as_tensor(rng.normal(size=(300, 256))), _lower_inv(rng, 256)
    want = cuda_chol.panel_scale_reference(acc, v)
    units, _, _ = cuda_chol._tc_plan(300, 256, 256, upper="cols")
    short = [(m0, n0, kb, ke - CHUNK, slot) for m0, n0, kb, ke, slot in units]
    out = torch.zeros_like(want)
    for m0, n0, kb, ke, _ in short:
        out[m0:m0 + TILE, n0:n0 + TILE] = acc[m0:m0 + TILE, kb:ke] @ v[n0:n0 + TILE, kb:ke].T
    wrong = (out - want).abs().amax(0)
    assert wrong[96:128].min() > 1e-3 and wrong[224:].min() > 1e-3
    assert wrong[:96].max() < 1e-12 and wrong[128:224].max() < 1e-12


def test_tc_model_inv_bias_needs_the_step_rounding():
    """Nonnegative operands (a nonnegative lower-triangular V): J's and K's
    truncated steps read low by ~4e-8, past chip_smoke's 2e-8 bias gate;
    the step rounding keeps them far inside it."""
    gen = torch.Generator().manual_seed(7)
    acc = torch.rand((1024, B_INV), generator=gen)
    v = torch.rand((B_INV, B_INV), generator=gen).tril_()
    rhs = torch.rand((B_INV, 1024), generator=gen)
    biases = {}
    for name, a, b in (("J", acc, v.T), ("K", v, rhs)):
        want = a.double() @ b.double()
        for rs in (True, False):
            got = tc_product(a, b, round_steps=rs)
            biases[name, rs] = ((got.double() - want) / want).mean().item()
    print("\nmean relative error: " + ", ".join(
        f"{k} {'rounded' if rs else 'truncated'} {v:.3e}" for (k, rs), v in biases.items()))
    for name in ("J", "K"):
        assert abs(biases[name, True]) <= 2e-9
        assert biases[name, False] < -2e-8


def _model_inv_routes(**kw):
    """J's and K's wrappers computing through `tc_product` (on the CPU): one
    running sum from zero, stored -- the NT layout's single segment (k <=
    256) is NN's sum; the steps past a tile's bound add zeros."""

    def panel_scale(acc, v):
        return tc_product(acc, v.T, **kw)

    def row_scale(v, rhs):
        return tc_product(v, rhs, **kw)

    return panel_scale, row_scale


@pytest.mark.parametrize("path", ["incore", "ooc"])
def test_tc_model_inv_route_variance_in_the_qsplit_regime(monkeypatch, path):
    """The inv route (`panel_solve="inv"`) with B, C, G, H, J and K through
    the model: in core `blocked_cholesky` (B and J) and `blocked_linv` (C
    and K); out of core the diagonal block's blocked factor (J, block 128).
    The posterior variance within 2e-3 of the float64 oracle and within 4x
    the float32 twins' own error + 1e-6, at their jitter rung."""
    from gpis_tpu_torch.linalg import cholesky as lin

    monkeypatch.setattr(cuda_chol, "PANEL_SOLVE", "inv")
    if path == "incore":
        monkeypatch.setattr(lin, "cholesky", lambda a: cuda_chol.blocked_cholesky(a, 256))
    x, y, q = _qsplit_problem()
    torch.exp(torch.zeros(64))  # a process's first float32 exp can be ~1e-4 off on the CPU
    var_twin, noise = _fit_var(path, x, y, q)
    oracle = _oracle_var(x, noise, q)
    err_twin = np.abs(var_twin - oracle).max()
    counts = dict.fromkeys("BCGHJK", 0)

    def counted(key, f):
        def call(*args):
            counts[key] += 1
            return f(*args)
        return call

    (c_model, h_model), (b_model, g_model) = _model_routes(), _model_nt_routes()
    j_model, k_model = _model_inv_routes()
    for name, key, f in (("panel_update", "B", b_model), ("row_update", "C", c_model),
                         ("gemm_nt_masked", "G", g_model), ("gemm_nn_acc_masked", "H", h_model),
                         ("panel_scale", "J", j_model), ("row_scale", "K", k_model)):
        monkeypatch.setattr(cuda_chol, name, counted(key, f))
    var, noise_m = _fit_var(path, x, y, q)
    assert counts["J"] > 0 and (path == "ooc" or counts["K"] > 0), counts
    assert torch.equal(noise_m, noise)  # the same rung of the jitter ladder
    err = np.abs(var - oracle).max()
    print(f"\n{path} inv: max |var - f64 oracle|: f32 twins {err_twin:.3e}, model {err:.3e}"
          f" ({counts})")
    assert err <= 2e-3
    assert err <= 4.0 * err_twin + 1e-6, (err, err_twin)


def test_check_tma_accepts_every_j_and_k_view(monkeypatch):
    """Every (acc, V) view the factor hands to J and every (V, rhs) the TRSM
    hands to K -- in core at capacity 1,024 (block 256), the out-of-core
    diagonal factor (block 128), `blocked_linv` in place and not, and
    `with_linv`'s one-block TRSM at a capacity off the 256 block -- starts
    on 16 bytes with rows a multiple of 4 floats; the loops run here in
    float32 through the twins, `_check_tma` applied to each call."""
    from gpis_tpu_torch.linalg import cholesky as lin

    seen = {"panel_scale": set(), "row_scale": set()}
    j_twin, k_twin = cuda_chol.panel_scale_reference, cuda_chol.row_scale_reference

    def panel_scale(acc, v):
        cuda_chol._check_tma("panel_scale", acc, v)
        seen["panel_scale"].add((tuple(acc.shape), acc.stride(0)))
        return j_twin(acc, v)

    def row_scale(v, rhs):
        cuda_chol._check_tma("row_scale", v, rhs)
        seen["row_scale"].add((tuple(rhs.shape), rhs.stride(0)))
        return k_twin(v, rhs)

    monkeypatch.setattr(cuda_chol, "PANEL_SOLVE", "inv")
    monkeypatch.setattr(cuda_chol, "panel_scale", panel_scale)
    monkeypatch.setattr(cuda_chol, "row_scale", row_scale)
    x, y, q = _qsplit_problem()
    noise = torch.full((N_QS,), 1e-3)
    model = regression.fit("rbf", x[:800], y[:800], noise[:800], PARAMS, touch_capacity=0)
    assert model.capacity % 256
    regression.with_linv(model)
    monkeypatch.setattr(lin, "cholesky", lambda a: cuda_chol.blocked_cholesky(a, 256))
    regression.fit_inference("rbf", x, y, noise, PARAMS)
    ooc.ooc_fit("rbf", x, y, noise, kf.kernel_params(0.8, 1.0), panel=256, block=128,
                store="tiered", device_budget=2 * 256 * N_QS * 4)
    l = torch.linalg.cholesky(torch.eye(768) * 2.0).contiguous()
    cuda_chol.blocked_linv(l.clone(), 256, inplace=False)
    # J's panels at R = 768 ... 256 in core and B 128 out of core; K's rhs at
    # N = 256 ... 1,024, and one (C, C) at with_linv's capacity.
    assert {r for (r, b), _ in seen["panel_scale"]} >= {768, 512, 256}
    assert any(b == 128 for (_, b), _ in seen["panel_scale"])
    assert {n for (_, n), _ in seen["row_scale"]} >= {256, 512, 768, 1024, model.capacity}
