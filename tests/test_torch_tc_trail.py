"""Float32 Kernel L (the sharded TRSM's band trailing update) on the CPU:
the planned in-place product (NN, SUB_FROM) over the live block
`_trail_ranges` trims, against the twin at P = 1 and P = 4 band geometries
with nothing written outside the block; the plan covering the live block
once at every step of the sharded TRSM, unsplit; the model's bias with and
without the step rounding; `_check_tma` on every L view.
"""

import numpy as np
import pytest
import torch
import torch_exp_warm  # noqa: F401 -- warms torch.exp before any test (see the module)

from gpis_tpu_torch.linalg import cuda_chol
from torch_tc_model import TILE, tc_nt_product, _check_plan, _planned_product


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """One intra-op thread for the module: the suite's workers share the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
