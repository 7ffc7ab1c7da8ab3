"""The split-TF32 arithmetic of float32 Kernels B, C, G and H (the tensor-core
product of gpis_tpu_torch/csrc/tc_nn.cuh: C and H its NN layout, B and G
its NT layout) on the CPU, no card needed: the float64 model of the
kernel's arithmetic (`torch_tc_model.tc_product`) put in C's and H's place
in the in-core TRSM (`blocked_linv`) and the out-of-core TRSM on a tiered
store, and in B's and G's place in the factors, in the `_QSPLIT` regime of
chip_smoke.py (C = 1,024, noise 1e-3), held to a float64 oracle; the bias
of sums of squares with and without the step rounding, and NT's segments.
The NT layout changes only how B's operand reaches shared memory, not the
arithmetic: the model takes B and G as `tc_product(a, b.T)`.  The other
kernel families' files are named in tests/torch_tc_model.py.
"""

import numpy as np
import pytest
import torch
import torch_exp_warm  # noqa: F401 -- warms torch.exp before any test (see the module)

from gpis_tpu_torch.linalg import cuda_chol
from torch_tc_model import (TILE, SEGMENT, tc_product, tc_nt_product, _model_routes,
                            _model_nt_routes, _qsplit_problem, _oracle_var, _fit_var)


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """One intra-op thread for the module: the suite's workers share the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------- (a) the model in the QSPLIT regime


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
