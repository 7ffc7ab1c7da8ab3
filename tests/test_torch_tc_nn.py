"""The arithmetic and the work plan of float32 Kernels B, C, G, H, J, K and
L, the split-TF32 tensor-core product (gpis_tpu_torch/csrc/tc_nn.cuh: C, H,
K and L its NN layout, G and J its NT layout, B G and L in place), on the
CPU: no card is needed.

* A float64 plain-PyTorch model of the kernel's arithmetic -- the rna split
  of each operand into TF32 hi and lo, the four products of each 8-deep
  step added to a fresh tile and truncated to float32 (the tensor core's
  accumulator), the step rounded to the nearest 23-bit value and added to
  the float32 sum -- put in C's and H's place in the in-core TRSM
  (`blocked_linv`) and the out-of-core TRSM on a tiered store, and in B's
  and G's place in the factors as well, in the `_QSPLIT` regime of
  chip_smoke.py (C = 1,024, noise 1e-3), and held to a float64 oracle.  The
  NT layout changes only how B's operand reaches shared memory, not the
  arithmetic: the model takes B and G as `tc_product(a, b.T)`.
* `_tc_plan` covers C's live triangle, H's k range, B's panel across j0
  and every shape G is called at exactly once, on k-chunk bounds, and a
  product taken unit by unit along the plan, with the partials summed in
  slot order, equals the plain twin in float64 (for NT at k0 = 0, and in
  place, too).
* `_check_tma`, the rule the wrappers apply before TMA reads a view, on
  every view the factors and TRSMs hand to the kernel.
* J and K (section e): `_tc_plan`'s per-tile upper bound (V's triangle) at
  every step of the C = 16,384 factor and TRSM and at ragged B, the plans
  of B, C, G and H unchanged by it, the planned products against the
  twins, the model's bias with and without the step rounding, the inv
  route through the model in the `_QSPLIT` regime, and `_check_tma` on
  every J and K view.
* L (section f): the planned in-place product (NN, SUB_FROM) over the live
  block `_trail_ranges` trims, against the twin at P = 1 and P = 4 band
  geometries with nothing written outside the block; the plan covering the
  live block once at every step of the sharded TRSM, unsplit; the model's
  bias with and without the step rounding; `_check_tma` on every L view.
"""

import numpy as np
import pytest
import torch
import torch_exp_warm  # noqa: F401 -- warms torch.exp before any test (see the module)

from gpis_tpu_torch.gp import regression
from gpis_tpu_torch.kernels import functions as kf
from gpis_tpu_torch.linalg import cuda_chol
from gpis_tpu_torch.linalg import outofcore as ooc

TILE, CHUNK, STEP = cuda_chol.TC_TILE, cuda_chol.TC_CHUNK, 8
SEGMENT = 64 * CHUNK  # tc_nn.cuh SEG_CHUNKS x BK: the k depth of an NT running sum


# ---------------------------------------------------------------- the model


def _rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: float32 x to 10 stored mantissa bits, to nearest,
    ties away from zero (sign-magnitude: adding half an ulp of TF32 to the
    pattern rounds the magnitude)."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x: torch.Tensor):
    hi = _rna_tf32(x)
    return hi, _rna_tf32(x - hi)  # x - hi is exact in float32


def _trunc_f32(s: torch.Tensor) -> torch.Tensor:
    """float64 s to float32 toward zero, as the FP32 accumulator truncates."""
    f = s.float()
    over = f.double().abs() > s.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def _round23(t: torch.Tensor) -> torch.Tensor:
    """tc_nn.cuh `round23`: the truncated step to the nearest 23-bit value,
    ties away from zero, on its bit pattern."""
    return ((t.view(torch.int32) + 1) & ~1).view(torch.float32)


def tc_product(a: torch.Tensor, b: torch.Tensor, *, products: int = 4,
               round_steps: bool = True) -> torch.Tensor:
    """float32 a (M, K) @ b (K, N) as the kernel computes it: products 4
    (the kernel), 3 (3xTF32: lo*lo dropped) or 1 (1xTF32: hi*hi alone).
    Each 8-deep step starts a fresh tile and takes its products small first,
    as the kernel's wgmma issue them (lo*lo, lo*hi, hi*lo, hi*hi): each
    product's 8 terms are summed exactly (TF32 products are exact in
    float64), added to the tile and the tile truncated to float32, as the
    tensor core's accumulator truncates.  The step's tile is then rounded
    (round_steps) and added to the float32 sum.  The plan's split-K adds a
    few float32 partials to nearest, which the model leaves out: it takes
    the steps of the whole k range in order."""
    a_hi, a_lo = (t.double() for t in _split(a.float().contiguous()))
    b_hi, b_lo = (t.double() for t in _split(b.float().contiguous()))
    pairs = [(a_lo, b_lo), (a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)][4 - products:]
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
    for k in range(0, a.shape[1], STEP):
        t = torch.zeros_like(acc)
        for x, y in pairs:
            t = _trunc_f32(t.double() + x[:, k:k + STEP] @ y[k:k + STEP])
        acc += _round23(t) if round_steps else t
    return acc


def tc_nt_product(a: torch.Tensor, b: torch.Tensor, s: torch.Tensor, *,
                  segment: int = SEGMENT, **kw) -> torch.Tensor:
    """float32 s - a (M, K) @ b (K, N) as the NT kernel computes it: the
    steps of `tc_product`, summed in float32 over each `segment` of k, each
    segment's sum then subtracted from the output in float32 (the first
    from s).  segment 0: one running sum over all of k, as NN takes it."""
    out = s.float().clone()
    step = segment or a.shape[1]
    for k in range(0, a.shape[1], step):
        out = out - tc_product(a[:, k:k + step], b[k:k + step], **kw)
    return out


def _model_routes(**kw):
    """C's and H's wrappers computing through `tc_product` (on the CPU)."""

    def row_update(w, l_row, j0):
        out = torch.zeros_like(l_row)
        if j0 > 0:
            out[:, :j0] = tc_product(l_row[:, :j0], w[:j0, :j0], **kw)
        return out

    def gemm_nn_acc_masked(u, a, b, w):
        u[:, :w] += tc_product(a, b[:, :w], **kw)
        return u

    return row_update, gemm_nn_acc_masked


def _model_nt_routes(**kw):
    """B's and G's wrappers computing through `tc_nt_product` (on the CPU):
    the NT layout changes how b reaches the tensor cores, not the
    arithmetic, so b's transpose goes through the same model."""

    def panel_update(m, j0, block):
        m[j0:, j0:j0 + block] = tc_nt_product(m[j0:, :j0], m[j0:j0 + block, :j0].T,
                                              m[j0:, j0:j0 + block], **kw)
        return m

    def gemm_nt_masked(a, b, s, k0):
        return tc_nt_product(a[:, :k0], b[:, :k0].T, s, **kw)

    return panel_update, gemm_nt_masked


# ------------------------------------------- (a) the model in the QSPLIT regime

N_QS, N_Q = 1024, 512
PARAMS = {"lengthscale": 0.8, "signal_variance": 1.0}


def _qsplit_problem():
    """chip_smoke.py's `_QSPLIT` data: 1,024 normal points, noise 1e-3,
    targets 0.2 N(0, 1), rbf at lengthscale 0.8."""
    rng = np.random.default_rng(20260818)
    x = rng.normal(size=(N_QS, 3))
    q = rng.normal(size=(N_Q, 3))
    y = rng.normal(size=N_QS) * 0.2
    return (torch.as_tensor(t, dtype=torch.float32) for t in (x, y, q))


def _oracle_var(x, noise, q) -> np.ndarray:
    """Posterior variance in float64 by a dense Cholesky: the oracle, on
    the noise the float32 fit settled on (its jitter included), so that it
    measures the TRSM's rounding and not the ladder's rung."""
    x, q = x.double().numpy(), q.double().numpy()
    ls2 = PARAMS["lengthscale"] ** 2

    def k(a, b):
        d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
        return np.exp(-0.5 * d2 / ls2)

    l = np.linalg.cholesky(k(x, x) + np.diag(noise.double().numpy()[:len(x)]))
    v = np.linalg.solve(l, k(x, q))
    return 1.0 - (v * v).sum(0)


def _fit_var(path: str, x, y, q) -> tuple[np.ndarray, torch.Tensor]:
    noise = torch.full((N_QS,), 1e-3)
    if path == "incore":
        m = regression.fit_inference("rbf", x, y, noise, PARAMS)
        return regression.predict(m, q)[1].double().numpy(), m.noise
    m = ooc.ooc_fit("rbf", x, y, noise, kf.kernel_params(0.8, 1.0), panel=256, block=128,
                    store="tiered", device_budget=2 * 256 * N_QS * 4)
    assert m.wstore.spilled(), "the budget should spill W panels to the host"
    return ooc.ooc_predict(m, q)[1].double().numpy(), m.noise


@pytest.mark.parametrize("path", ["incore", "ooc"])
def test_tc_model_trsm_variance_in_the_qsplit_regime(monkeypatch, path):
    """C (in core) or H (out of core) through the model: the posterior
    variance within 2e-3 of the float64 oracle and within 4x the float32
    twin's own error + 1e-6; 3xTF32's and 1xTF32's errors printed beside."""
    x, y, q = _qsplit_problem()
    torch.exp(torch.zeros(64))  # a process's first float32 exp can be ~1e-4 off on the CPU
    var_twin, noise = _fit_var(path, x, y, q)
    oracle = _oracle_var(x, noise, q)
    err_twin = np.abs(var_twin - oracle).max()
    errs = {}
    for name, kw in (("4 products", {}), ("3xTF32", {"products": 3}),
                     ("1xTF32", {"products": 1})):
        row_update, gemm_nn = _model_routes(**kw)
        counts = {"C": 0, "H": 0}

        def c_counted(*args, _f=row_update):
            counts["C"] += 1
            return _f(*args)

        def h_counted(*args, _f=gemm_nn):
            counts["H"] += 1
            return _f(*args)

        monkeypatch.setattr(cuda_chol, "row_update", c_counted)
        monkeypatch.setattr(cuda_chol, "gemm_nn_acc_masked", h_counted)
        var, noise_m = _fit_var(path, x, y, q)
        monkeypatch.undo()
        assert counts["C" if path == "incore" else "H"] > 0, counts
        assert torch.equal(noise_m, noise)  # the same rung of the jitter ladder
        errs[name] = np.abs(var - oracle).max()
    print(f"\n{path}: max |var - f64 oracle|: f32 twin {err_twin:.3e}, "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    assert errs["4 products"] <= 2e-3
    assert errs["4 products"] <= 4.0 * err_twin + 1e-6, (errs, err_twin)


def test_tc_model_bias_needs_the_step_rounding():
    """On nonnegative operands the truncated steps sum low by ~2^-25 of the
    result; rounding each step to 23 bits removes that bias (chip_smoke's
    bias gate, 2e-8, is the bar)."""
    gen = torch.Generator().manual_seed(3)
    a = torch.rand((128, 4096), generator=gen)
    b = torch.rand((4096, 128), generator=gen)
    want = a.double() @ b.double()

    def bias(got):
        return ((got.double() - want) / want).mean().item()

    rounded, truncated = bias(tc_product(a, b)), bias(tc_product(a, b, round_steps=False))
    print(f"\nmean relative error: rounded steps {rounded:.3e}, truncated {truncated:.3e}")
    assert abs(rounded) <= 2e-8
    assert truncated < -2e-8


@pytest.mark.parametrize("path", ["incore", "ooc"])
def test_tc_model_factor_variance_in_the_qsplit_regime(monkeypatch, path):
    """B and G (the factors' NT products) through the model, with C and H:
    the posterior variance within 2e-3 of the float64 oracle and within 4x
    the float32 twins' own error + 1e-6, at the float32 twins' jitter rung.
    In core, the factor is the blocked one (`blocked_cholesky`, Kernel B's
    loop), which the card takes from n = 4,096 up."""
    from gpis_tpu_torch.linalg import cholesky as lin

    if path == "incore":
        monkeypatch.setattr(lin, "cholesky", lambda a: cuda_chol.blocked_cholesky(a, 256))
    x, y, q = _qsplit_problem()
    torch.exp(torch.zeros(64))  # a process's first float32 exp can be ~1e-4 off on the CPU
    var_twin, noise = _fit_var(path, x, y, q)
    oracle = _oracle_var(x, noise, q)
    err_twin = np.abs(var_twin - oracle).max()
    counts = {"B": 0, "C": 0, "G": 0, "H": 0}

    def counted(key, f):
        def call(*args):
            counts[key] += 1
            return f(*args)
        return call

    (c_model, h_model), (b_model, g_model) = _model_routes(), _model_nt_routes()
    for name, key, f in (("panel_update", "B", b_model), ("row_update", "C", c_model),
                         ("gemm_nt_masked", "G", g_model),
                         ("gemm_nn_acc_masked", "H", h_model)):
        monkeypatch.setattr(cuda_chol, name, counted(key, f))
    var, noise_m = _fit_var(path, x, y, q)
    assert counts["B" if path == "incore" else "G"] > 0, counts
    assert torch.equal(noise_m, noise)  # the same rung of the jitter ladder
    err = np.abs(var - oracle).max()
    print(f"\n{path}: max |var - f64 oracle|: f32 twins {err_twin:.3e}, B/C/G/H model {err:.3e}"
          f" ({counts})")
    assert err <= 2e-3
    assert err <= 4.0 * err_twin + 1e-6, (err, err_twin)


def test_tc_model_sum_of_squares_bias_needs_the_step_rounding():
    """a = b, nonnegative: every output of a a^T is a sum of nonnegative
    products and its diagonal a sum of squares, the Cholesky's diagonal
    blocks' case (B on a panel of one matrix, G at `_chol_diag`).  The
    truncated steps read low there; the step rounding keeps |bias| under
    chip_smoke's 2e-8.  The product's 128 x 128 diagonal blocks of a 4,096-
    row a at k 512: 4,096 sums of squares, so that float32's own rounding
    noise in the mean (~3e-9) sits well under the gate."""
    gen = torch.Generator().manual_seed(4)
    a = torch.rand((4096, 512), generator=gen)
    blocks = [a[i:i + TILE] for i in range(0, a.shape[0], TILE)]
    want = torch.stack([x.double() @ x.double().T for x in blocks])

    def bias(got, diag=False):
        rel = (got.double() - want) / want
        return (rel.diagonal(dim1=1, dim2=2) if diag else rel).mean().item()

    zero = torch.zeros((TILE, TILE))
    rounded = -torch.stack([tc_nt_product(x, x.T, zero) for x in blocks])
    truncated = -torch.stack([tc_nt_product(x, x.T, zero, round_steps=False) for x in blocks])
    biases = {"rounded": bias(rounded), "rounded diagonal": bias(rounded, True),
              "truncated": bias(truncated), "truncated diagonal": bias(truncated, True)}
    print("\nmean relative error: " + ", ".join(f"{k} {v:.3e}" for k, v in biases.items()))
    assert abs(biases["rounded"]) <= 2e-8 and abs(biases["rounded diagonal"]) <= 2e-8
    assert biases["truncated"] < -2e-8 and biases["truncated diagonal"] < -2e-8


def test_tc_model_deep_sums_of_squares_need_the_segments():
    """The out-of-core diagonal block's sums of squares at k 24,576 (phase
    7's last band): one running float32 sum of the 3,072 rounded steps
    drifts by ~sqrt(3,072) of its ulps, past chip_smoke's 2e-6 x sum|a||b|
    on some diagonal outputs; summed in 2,048-deep segments, NT's
    arithmetic, it stays far inside."""
    gen = torch.Generator().manual_seed(5)
    k = 24576
    a = torch.randn((TILE, k), generator=gen) / 28672**0.5
    want = -(a.double() @ a.double().T)
    tol = 2e-6 * (a.double().abs() @ a.double().abs().T).diagonal()
    zero = torch.zeros((TILE, TILE))
    errs = {}
    for name, segment in (("segments", SEGMENT), ("one running sum", 0)):
        got = tc_nt_product(a, a.T, zero, segment=segment)
        errs[name] = ((got.double() - want).diagonal().abs() / tol).max().item()
    print("\nworst diagonal error / (2e-6 x sum|a||b|): "
          + ", ".join(f"{n} {v:.3f}" for n, v in errs.items()))
    assert errs["segments"] <= 0.25
    assert errs["one running sum"] > 2 * errs["segments"]


# ---------------------------------------------------------- (b) the plan


def _tile_end(m0, n0, k_hi, upper, k_offset=0):
    """Where a tile's k range ends: k_hi, or with a triangular operand after
    the tile's last column (J, "cols") or last global row (K, D, F: "rows",
    row m0 being global row m0 + k_offset), never past k_hi."""
    if upper is None:
        return k_hi
    return min((n0 if upper == "cols" else m0 + k_offset) + TILE, k_hi)


def _check_plan(rows, cols, k_hi, *, triangle=False, width=0, upper=None, k_offset=0,
                whole=False, n_sm=132):
    """Every live 128 x 128 tile's k range [lo, hi) covered exactly once
    (hi = k_hi, or the tile's own bound with `upper`), in units on k-chunk
    bounds; split tiles' slots contiguous, in k order, and named by one
    finish entry each; cnt-0 finish tiles on the tiles with no live k and on
    [round_up(cols), width)."""
    units, finish, n_slots = cuda_chol._tc_plan(rows, cols, k_hi, triangle=triangle,
                                                width=width, upper=upper, k_offset=k_offset,
                                                whole=whole, n_sm=n_sm)
    per_tile = {}
    for m0, n0, kb, ke, slot in units:
        per_tile.setdefault((m0, n0), []).append((kb, ke, slot))
    live = {(m0, n0) for m0 in range(0, rows, TILE) for n0 in range(0, cols, TILE)
            if (n0 if triangle else 0) < _tile_end(m0, n0, k_hi, upper, k_offset)}
    assert set(per_tile) == live
    split = {}
    for (m0, n0), us in per_tile.items():
        lo = n0 if triangle else 0
        us.sort()
        assert us[0][0] == lo and us[-1][1] == _tile_end(m0, n0, k_hi, upper, k_offset)
        for (kb, ke, _), nxt in zip(us, us[1:] + [None]):
            assert kb < ke and (kb - lo) % CHUNK == 0
            assert nxt is None or nxt[0] == ke
        slots = [s for _, _, s in us]
        if len(us) == 1:
            assert slots == [-1]
        else:
            assert slots == list(range(slots[0], slots[0] + len(us)))
            split[(m0, n0)] = (slots[0], len(us))
    named = {(m0, n0): (s0, cnt) for m0, n0, s0, cnt in finish if cnt}
    assert named == split
    assert sorted(s for s0, cnt in split.values() for s in range(s0, s0 + cnt)) == \
        list(range(n_slots))
    zeros = sorted((m0, n0) for m0, n0, _, cnt in finish if cnt == 0)
    first = TILE * -(-cols // TILE)
    empty = {(m0, n0) for m0 in range(0, rows, TILE) for n0 in range(0, cols, TILE)} - live
    assert zeros == sorted(empty | {(m0, n0) for m0 in range(0, rows, TILE)
                                    for n0 in range(first, width, TILE)})
    return units, finish, n_slots


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


def _box(x, r0, c0, nrows, ncols):
    """x[r0:r0+nrows, c0:c0+ncols] as TMA loads it: zeros past x's edges."""
    out = torch.zeros((nrows, ncols), dtype=x.dtype)
    blk = x[r0:r0 + nrows, c0:c0 + ncols]
    out[:blk.shape[0], :blk.shape[1]] = blk
    return out


def _planned_product(a, b, out, rows, cols, k_hi, *, triangle=False, width=0, add=False,
                     nt=False, s=None, upper=None, n_sm=132):
    """out (=, or +=) a[:, :k_hi] @ b[:k_hi, :cols], or with s (SUB_FROM)
    out = s - the product -- with nt the same of a[:, :k_hi] @ b[:cols,
    :k_hi]^T -- taken as the two kernels take it: unit by unit along
    `_tc_plan`, each unit reading a and b as they stand when it runs (a and
    b cut to k < k_hi and B to its `cols` rows or columns, zeros past them,
    as the tensor maps' extents), split tiles' partials summed in slot
    order, cnt-0 tiles finished with a zero sum; outputs clipped to (rows,
    out's columns).  s may be out itself."""
    units, finish, n_slots = cuda_chol._tc_plan(rows, cols, k_hi, triangle=triangle,
                                                width=width, upper=upper, n_sm=n_sm)
    a_live = a[:rows, :k_hi]
    b_live = b[:cols, :k_hi] if nt else b[:k_hi, :cols]
    ws = torch.full((n_slots, TILE, TILE), float("nan"), dtype=a.dtype)

    def epilogue(m0, n0, tile):
        dst = out[m0:m0 + TILE, n0:n0 + TILE]
        t = tile[:dst.shape[0], :dst.shape[1]]
        if s is not None:
            dst.copy_(s[m0:m0 + TILE, n0:n0 + TILE] - t)
        else:
            dst.copy_(dst + t if add else t)

    for m0, n0, kb, ke, slot in units:
        bt = (_box(b_live, n0, kb, TILE, ke - kb).T if nt
              else _box(b_live, kb, n0, ke - kb, TILE))
        tile = _box(a_live, m0, kb, TILE, ke - kb) @ bt
        if slot < 0:
            epilogue(m0, n0, tile)
        else:
            ws[slot] = tile
    for m0, n0, slot0, cnt in finish:
        tile = torch.zeros((TILE, TILE), dtype=a.dtype)
        for i in range(cnt):
            tile = tile + ws[slot0 + i]
        epilogue(m0, n0, tile)
    return out


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


# ------------------------------------------------------ (d) the alignment rule


def test_check_tma_accepts_every_main_path_view(monkeypatch, tmp_path):
    n, panel, c = 1024, 256, 2048
    l = torch.zeros((n, n))
    for j0 in range(0, n, 256):  # blocked_linv: W and L's row panel j
        cuda_chol._check_tma("row_update", l[j0:j0 + 256], l)
    cur = torch.zeros((2 * panel, c))
    u = torch.zeros((2 * panel, c))
    for k0 in range(0, c - panel + 1, panel):  # _trsm_kstep: a column slice of L_j
        cuda_chol._check_tma("gemm_nn_acc_masked", cur[:, k0:k0 + panel], u[:panel])
    for r0 in range(256, 2 * panel, 256):  # _trsm_finish: -Ljj's rows, U's solved rows
        cuda_chol._check_tma("gemm_nn_acc_masked", -cur[r0:r0 + 256, :r0], u[:r0])
    _check_tma_on_query_views(monkeypatch, tmp_path)


def _check_tma_on_query_views(monkeypatch, tmp_path):
    """D's and F's views on the query paths, run here in float32 through the
    twins with `_check_tma` applied to what TMA would read: W and the staged
    kq (D), W (F), the W bands of `ooc_predict` (F band) and the sharded
    query's `w_loc` (F band), at a capacity the 256 block tiles and one it
    does not (`fit` + `with_linv`)."""
    import torch.distributed as dist

    from gpis_tpu_torch.linalg import sharded as sh
    from gpis_tpu_torch.parallel.mesh import make_row_mesh

    seen = {"staged_quad": 0, "fused_quad": 0, "quad_band": 0}
    d_twin, f_twin, b_twin = (cuda_query.staged_quad_reference, cuda_query.fused_quad_reference,
                              cuda_query.quad_band_reference)

    def staged_quad(kq, w, alpha):
        cuda_chol._check_tma("staged_quad", w, kq)
        seen["staged_quad"] += 1
        return d_twin(kq, w, alpha)

    def fused_quad(gen, name, q, cols, params, alpha, w):
        cuda_chol._check_tma("fused_quad", w)
        seen["fused_quad"] += 1
        return f_twin(gen, name, q, cols, params, alpha, w)

    def quad_band(gen, name, q, cols, params, w_band, row0):
        assert w_band.dtype == torch.float32
        cuda_chol._check_tma("quad_band", w_band)
        seen["quad_band"] += 1
        return b_twin(gen, name, q, cols, params, w_band, row0)

    monkeypatch.setattr(cuda_query, "staged_quad", staged_quad)
    monkeypatch.setattr(cuda_query, "fused_quad", fused_quad)
    monkeypatch.setattr(cuda_query, "quad_band", quad_band)
    x, y, q = _qsplit_problem()
    noise = torch.full((N_QS,), 1e-3)
    for model in (regression.fit_inference("rbf", x, y, noise, PARAMS),
                  regression.with_linv(regression.fit("rbf", x[:800], y[:800], noise[:800],
                                                      PARAMS, touch_capacity=0))):
        regression.predict(model, q)  # staged: D
        monkeypatch.setattr(cuda_query, "KQ_STAGE_MAX", 0)
        regression.predict(model, q)  # on the fly: F
        monkeypatch.setattr(cuda_query, "KQ_STAGE_MAX", 2 << 30)
    m = ooc.ooc_fit("rbf", x, y, noise, kf.kernel_params(0.8, 1.0), panel=256, block=128,
                    store="tiered", device_budget=2 * 256 * N_QS * 4)
    ooc.ooc_predict(m, q)
    n_ooc = seen["quad_band"]
    assert seen["staged_quad"] == 2 and seen["fused_quad"] == 2 and n_ooc == N_QS // 256
    model = regression.fit_inference("rbf", x, y, noise, PARAMS)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        sh.sharded_predict_linv("rbf", q, model.x, model.params, model.alpha, model.linv,
                                make_row_mesh(1, device="cpu"))
    finally:
        dist.destroy_process_group()
    assert seen["quad_band"] == n_ooc + 1
    # P = 4: each rank's w_loc, a row band of the one W.
    for r in range(4):
        cuda_chol._check_tma("quad_band", model.linv[r * N_QS // 4:(r + 1) * N_QS // 4])


def test_check_tma_accepts_every_factor_view_of_b_and_g(monkeypatch, tmp_path):
    """Every (a, b) view that the in-core factor (B), the out-of-core k-step,
    right-looking TRSM and diagonal block (G) and the sharded factor (G)
    hand to the float32 kernel starts on 16 bytes with a leading dimension
    of a multiple of 4 floats: the factors run here in float32 through the
    twins, with `_check_tma` applied to each call's operands."""
    import torch.distributed as dist

    from gpis_tpu_torch.linalg import sharded as sh
    from gpis_tpu_torch.parallel.mesh import make_row_mesh

    seen = {"panel_update": 0, "gemm_nt_masked": 0}
    panel_twin, gemm_twin = cuda_chol.panel_update_reference, cuda_chol.gemm_nt_masked_reference

    def panel_update(m, j0, block):
        if j0:
            cuda_chol._check_tma("panel_update", m[j0:, :j0], m[j0:j0 + block, :j0])
            seen["panel_update"] += 1
        return panel_twin(m, j0, block)

    def gemm_nt_masked(a, b, s, k0):
        assert a.dtype == torch.float32
        cuda_chol._check_tma("gemm_nt_masked", a, b)
        seen["gemm_nt_masked"] += 1
        return gemm_twin(a, b, s, k0)

    from gpis_tpu_torch.linalg import cholesky as lin

    monkeypatch.setattr(cuda_chol, "panel_update", panel_update)
    monkeypatch.setattr(cuda_chol, "gemm_nt_masked", gemm_nt_masked)
    monkeypatch.setattr(lin, "cholesky", lambda a: cuda_chol.blocked_cholesky(a, 256))
    x, y, _ = _qsplit_problem()
    noise = torch.full((N_QS,), 1e-3)
    regression.fit_inference("rbf", x, y, noise, PARAMS)
    assert seen["panel_update"] > 0
    ooc.ooc_fit("rbf", x, y, noise, kf.kernel_params(0.8, 1.0), panel=256, block=128,
                store="tiered", device_budget=2 * 256 * N_QS * 4)
    n_ooc = seen["gemm_nt_masked"]
    assert n_ooc > 0
    g = torch.as_tensor(np.random.default_rng(32).normal(size=(512, 512)), dtype=torch.float32)
    a = g @ g.T / 512 + torch.eye(512)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        sh.sharded_cholesky(a, make_row_mesh(1, device="cpu"), block=128, use_kernels=True)
    finally:
        dist.destroy_process_group()
    assert seen["gemm_nt_masked"] > n_ooc


@pytest.mark.parametrize("view", ["column", "leading_dimension"])
def test_check_tma_rejects_a_view_tma_cannot_address(view):
    m = torch.zeros((256, 516))
    bad = m[:, 1:257] if view == "column" else torch.zeros((256, 257))[:, :256]
    with pytest.raises(ValueError, match="TMA"):
        cuda_chol._check_tma("gemm_nn_acc_masked", m[:, :256], bad)


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


# ------------------------------------------------------------ (f) Kernel L
# L (band_trail, S -= Lcol Wj in place on a rank's row band) is the tile's NN
# layout with SUB_FROM, planned over the live block that `_trail_ranges`
# trims: rows from global row j0 + B on, columns below j0 + B, k < B.


def _planned_band_trail(s, l_col, wj, j0, row0):
    """`band_trail` as the wrapper hands it to the tile: the live block of
    `_trail_ranges`, its plan (live rows x columns, k < B), SUB_FROM in
    place on S's live block."""
    r, c = s.shape
    b = wj.shape[0]
    r_b, w = cuda_chol._trail_ranges(r, c, b, j0, row0)
    if r_b < r and w > 0:
        live = s[r_b:, :w]
        _planned_product(l_col[r_b:], wj, live, r - r_b, w, b, s=live)
    return s


# (C, R, B, j0, row0): P = 1 at chip_smoke's geometry scaled down (R = C,
# j0 = C / 2) and at the first and a late step; P = 4 bands (R = C / 4) at
# row0 > 0 with the live block from the band's first row, from inside it,
# and not at all (no live row); a ragged band (R 300, B 64).
_TRAIL_GEOMETRIES = [(2048, 2048, 256, 1024, 0), (2048, 2048, 256, 0, 0),
                     (2048, 2048, 256, 1792, 0), (2048, 512, 256, 256, 512),
                     (2048, 512, 256, 512, 512), (2048, 512, 256, 1536, 1536),
                     (2048, 512, 256, 768, 512), (1200, 300, 64, 320, 300)]


@pytest.mark.parametrize("c, r, b, j0, row0", _TRAIL_GEOMETRIES)
def test_planned_band_trail_in_place_equals_the_twin_in_float64(c, r, b, j0, row0):
    rng = np.random.default_rng(c + r + b + j0 + row0)
    s0 = torch.as_tensor(rng.normal(size=(r, c)))
    l_col = torch.as_tensor(rng.normal(size=(r, c)))[:, j0:j0 + b]  # a strided panel
    wj = torch.as_tensor(rng.normal(size=(b, c)))
    wj[:, j0 + b:] = 0.0
    got = _planned_band_trail(s0.clone(), l_col, wj, j0, row0)
    want = cuda_chol.band_trail_reference(s0.clone(), l_col, wj, j0, row0)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
    # Nothing written outside the live block (global rows >= j0 + B,
    # columns < j0 + B), counted here without `_trail_ranges`.
    dead_rows = min(max(j0 + b - row0, 0), r)
    assert torch.equal(got[:dead_rows], s0[:dead_rows])
    assert torch.equal(got[:, j0 + b:], s0[:, j0 + b:])
    if dead_rows == r:
        assert torch.equal(got, s0)


@pytest.mark.parametrize("c, p, b", [(16384, 1, 256), (16384, 4, 256), (4096, 4, 64)])
def test_tc_plan_covers_the_band_trail_live_block_once(c, p, b):
    """Every step of the sharded TRSM at C (P = 1: chip_smoke's phase 9;
    P = 4: each rank's band): the plan covers each live (row, column, k)
    exactly once (`_check_plan`), every tile in one unit over [0, B) -- at
    B <= 256 nothing is split, so no partial and no finish tile."""
    r = c // p
    live = 0
    for j0 in range(0, c, b):
        for row0 in range(0, c, r):
            r_b, w = cuda_chol._trail_ranges(r, c, b, j0, row0)
            if r_b >= r:
                continue
            units, finish, n_slots = _check_plan(r - r_b, w, b)
            assert n_slots == 0 and not finish
            assert all(kb == 0 and ke == b and slot == -1 for _, _, kb, ke, slot in units)
            live += len(units)
    # Every output tile of every live block, each once.
    assert live == sum(-(-(r - min(max(j0 + b - row0, 0), r)) // TILE) * -(-(j0 + b) // TILE)
                       for j0 in range(0, c, b) for row0 in range(0, c, r))


def test_tc_model_band_trail_bias_needs_the_step_rounding():
    """Nonnegative operands, S = 0: L's truncated steps read low by ~4e-8 of
    the product, past chip_smoke's 2e-8 bias gate; rounded, they keep far
    inside it.  L's arithmetic is NN's single running sum over B = 256,
    subtracted once from S (`tc_nt_product` with one segment)."""
    gen = torch.Generator().manual_seed(8)
    l_col = torch.rand((1024, 256), generator=gen)
    wj = torch.rand((256, 1024), generator=gen)
    want = l_col.double() @ wj.double()
    biases = {}
    for rs in (True, False):
        got = -tc_nt_product(l_col, wj, torch.zeros((1024, 1024)), segment=0, round_steps=rs)
        biases[rs] = ((got.double() - want) / want).mean().item()
    print(f"\nL mean relative error: rounded {biases[True]:.3e}, truncated {biases[False]:.3e}")
    assert abs(biases[True]) <= 2e-9
    assert biases[False] < -2e-8


def test_check_tma_accepts_every_band_trail_view(monkeypatch, tmp_path):
    """Every (live Lcol, Wj) pair that the sharded TRSM hands to float32 L
    (`sharded_linv(use_kernel=True)` on one gloo rank, C = 1,024, block 128)
    starts on 16 bytes with rows a multiple of 4 floats; the loop runs here
    through the twin, `_check_tma` applied to each call's live views."""
    import torch.distributed as dist

    from gpis_tpu_torch.linalg import sharded as sh
    from gpis_tpu_torch.parallel.mesh import make_row_mesh

    calls = []
    twin = cuda_chol.band_trail_reference

    def band_trail(s, l_col, wj, j0, row0):
        r_b, _ = cuda_chol._trail_ranges(s.shape[0], s.shape[1], wj.shape[0], j0, row0)
        if r_b < s.shape[0]:
            cuda_chol._check_tma("band_trail", l_col[r_b:], wj)
            calls.append(j0)
        return twin(s, l_col, wj, j0, row0)

    monkeypatch.setattr(cuda_chol, "band_trail", band_trail)
    g = torch.as_tensor(np.random.default_rng(34).normal(size=(1024, 1024)), dtype=torch.float32)
    l = torch.linalg.cholesky(g @ g.T / 1024 + torch.eye(1024)).contiguous()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        w = sh.sharded_linv(l, make_row_mesh(1, device="cpu"), block=128, use_kernel=True)
    finally:
        dist.destroy_process_group()
    assert calls == list(range(0, 1024 - 128, 128))  # every step with a live row
    assert (w.double() @ l.double() - torch.eye(1024, dtype=torch.float64)).abs().max() < 1e-4


# --------------------------------------------------- (g) Kernels D and F (QUAD)
# D (staged_quad) and F (fused_quad, quad_band) are the tile's NT layout with
# the QUAD epilogue: A = W (or a row band of it at global row row0), B = kq
# (F: generated), each 128-row tile of W over k up to its last global row + 1
# (`_tc_plan(upper="rows", k_offset=row0, whole=True)`), its product squared
# and summed over its rows into partial[m0 / 128, q], the partials then
# summed over the row tiles in order.

from gpis_tpu_torch.kernels import cuda_query  # noqa: E402


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
