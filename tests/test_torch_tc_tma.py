"""`_check_tma`, the rule the wrappers apply before TMA reads a view, on
every view the factors, TRSMs and queries hand to Kernels B, C, G, H, D and
F, and its refusal of a view TMA cannot address, on the CPU.
"""

import numpy as np
import pytest
import torch
import torch_exp_warm  # noqa: F401 -- warms torch.exp before any test (see the module)

from gpis_tpu_torch.gp import regression
from gpis_tpu_torch.kernels import cuda_query
from gpis_tpu_torch.kernels import functions as kf
from gpis_tpu_torch.linalg import cuda_chol
from gpis_tpu_torch.linalg import outofcore as ooc
from torch_tc_model import N_QS, PARAMS, _qsplit_problem


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """One intra-op thread for the module: the suite's workers share the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
        sh.sharded_cholesky(a, make_row_mesh(1, device="cpu"), block=128)
    finally:
        dist.destroy_process_group()
    assert seen["gemm_nt_masked"] > n_ooc


@pytest.mark.parametrize("view", ["column", "leading_dimension"])
def test_check_tma_rejects_a_view_tma_cannot_address(view):
    m = torch.zeros((256, 516))
    bad = m[:, 1:257] if view == "column" else torch.zeros((256, 257))[:, :256]
    with pytest.raises(ValueError, match="TMA"):
        cuda_chol._check_tma("gemm_nn_acc_masked", m[:, :256], bad)
