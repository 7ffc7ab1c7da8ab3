"""The float64 model of the split-TF32 tensor-core product of float32
Kernels B, C, G, H, J, K, L, D and F (gpis_tpu_torch/csrc/tc_nn.cuh), and
the plan checks and problems its tests share.  The tests are one file a
kernel family: tests/test_torch_tc_nn.py (the model in B's, C's, G's and
H's place), test_torch_tc_plan.py (their plans), test_torch_tc_tma.py (the
alignment rule), test_torch_tc_inv.py (J and K), test_torch_tc_trail.py (L)
and test_torch_tc_quad.py (D and F).

The model (`tc_product`): the rna split of each operand into TF32 hi and
lo, the four products of each 8-deep step added to a fresh tile and
truncated to float32 (the tensor core's accumulator), the step rounded to
the nearest 23-bit value and added to the float32 sum; NT sums its steps
in 2,048-deep segments (`tc_nt_product`).
"""

import numpy as np
import torch

from gpis_tpu_torch.gp import regression
from gpis_tpu_torch.kernels import functions as kf
from gpis_tpu_torch.linalg import cuda_chol
from gpis_tpu_torch.linalg import outofcore as ooc


TILE, CHUNK, STEP = cuda_chol.TC_TILE, cuda_chol.TC_CHUNK, 8
SEGMENT = 64 * CHUNK  # tc_nn.cuh SEG_CHUNKS x BK: the k depth of an NT running sum


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
    as the kernel's wgmma instructions take them (lo*lo, lo*hi, hi*lo, hi*hi): each
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
