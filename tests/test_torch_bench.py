"""The port's headline benchmark (`gpis_tpu_torch.cli.bench`, the `bench`
verb) on the CPU, against a JAX pipeline built from the JAX package's own
functions the way the root bench.py builds it on the CPU (Gram, library
Cholesky, cho_solve, `with_linv(block=512)`, `predict` in 8,192-point
chunks); bench.py itself is not run: it attaches recorded results.

(a) The fit and the grid query in float64 on both of the port's routes
    (C = 512: W = L^{-1} in place, alpha = W^T (W y); C = 384: cho_solve
    and with_linv), mean and variance within 1e-6 (BASELINE.md row 2).
(b) The warm-up's noise ladder: a NaN factor multiplies each noise below 1
    by 10, the 1e10 pad rows stay, and the timed round fits at the
    escalated noise.
(c) `gpis-torch bench 256 --device cpu`: one stdout JSON line with
    bench.py's keys and the provenance stamp, and a surface RMSE within
    1e-4 of the float32 JAX pipeline's; the grid `--save-grid` writes.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_exp_warm  # noqa: F401 -- warms torch.exp before any test (see the module)
import torch_jax_native

from gpis_tpu.config import ModelConfig as JaxModelConfig
from gpis_tpu.data import gpis as jgpis
from gpis_tpu.gp import regression as jgpr
from gpis_tpu.gp.model import GPModel as JaxGPModel
from gpis_tpu.gp.model import round_up
from gpis_tpu.kernels import functions as jkf
from gpis_tpu.kernels import gram as jkg
from gpis_tpu.linalg import cholesky as jlin
from gpis_tpu.surface import grid as jgrid
from gpis_tpu.surface import marching as jmarching
from gpis_tpu_torch.cli import bench
from gpis_tpu_torch.cli.main import main as torch_main
from gpis_tpu_torch.linalg import cholesky as lin
from gpis_tpu_torch.surface import grid as grid_mod

TOL = 1e-6
BENCH_KEYS = {"metric", "hbm_peak_gb", "value", "unit", "vs_baseline", "fit_s", "query_s",
              "surface_rmse", "n_train", "n_query", "ok"}
STAMP_KEYS = {"date", "rev", "dirty"}  # utils/provenance: rev and dirty where git answers


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """One intra-op thread for the module: the suite's workers share the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_pipeline(n_surface: int, dtype, res: int, chunk: int):
    """bench.py's fit and chunked grid query on the JAX package's CPU route.
    Returns (mean, var, axis) as numpy arrays and C."""
    cfg = JaxModelConfig(kernel="rbf", lengthscale=0.4, noise_surface=1e-3, n_external=127,
                         n_internal=1, block=128, touch_capacity=0)
    pts = jgpis.fibonacci_sphere(n_surface, radius=1.0).astype(np.float32)
    ts = jgpis.build_training_set(pts, cfg)
    params = {k: v.astype(dtype) for k, v in
              jkf.kernel_params(cfg.lengthscale, cfg.signal_variance).items()}
    n = ts.x.shape[0]
    c = round_up(n, cfg.block)
    x = jnp.pad(ts.x.astype(dtype), ((0, c - n), (0, 0)))
    y = jnp.pad(ts.y.astype(dtype), (0, c - n))
    noise = jnp.pad(ts.noise.astype(dtype), (0, c - n), constant_values=1e10)
    l = jlin.cholesky(jkg.gram("rbf", x, params, noise=noise))
    m = JaxGPModel(x=x, y=y, noise=noise, params=params, chol=l, alpha=jlin.cho_solve(l, y),
                   n_touch=jnp.zeros((), jnp.int32), kernel="rbf", n0=c, pad_noise=1e10)
    m = jgpr.with_linv(m, block=512)
    coords, axis = jgrid.make_grid(res, 1.5, dtype=dtype)
    query_fn = jax.jit(lambda m, q: jgpr.predict(m, q))
    parts = [query_fn(m, coords[i:i + chunk]) for i in range(0, coords.shape[0], chunk)]
    mean = np.concatenate([np.asarray(p[0]) for p in parts])
    var = np.concatenate([np.asarray(p[1]) for p in parts])
    return mean, var, np.asarray(axis), c


@pytest.mark.parametrize("n_surface,c,w_route", [(384, 512, True), (256, 384, False)])
def test_bench_fit_and_query_match_jax_in_float64(n_surface, c, w_route):
    res, chunk = 16, 1024
    x, y, noise, params, n = bench.workload(n_surface, dtype=torch.float64, device="cpu")
    assert (x.shape[0], n) == (c, n_surface + 128)
    model = bench.fit_model(x, y, noise, params, check_nan=True)
    assert (model.linv is model.chol) == w_route
    coords, _ = grid_mod.make_grid(res, 1.5, dtype=torch.float64, device="cpu")
    mean, var = bench.query(model, coords, chunk)
    jmean, jvar, _, jc = jax_pipeline(n_surface, jnp.float64, res, chunk)
    assert jc == c
    np.testing.assert_allclose(mean.numpy(), jmean, rtol=0, atol=TOL)
    np.testing.assert_allclose(var.numpy(), jvar, rtol=0, atol=TOL)


def test_bench_ladder_escalates_noise_into_the_timed_round(monkeypatch):
    factor, grams = lin.cholesky, []

    def nan_first(a):
        l = factor(a)
        if len(grams) == 1:
            l.diagonal().fill_(float("nan"))
        return l

    gram = bench.kg.gram

    def spy_gram(name, x, params, noise=None):
        grams.append(noise.clone())
        return gram(name, x, params, noise=noise)

    monkeypatch.setattr(lin, "cholesky", nan_first)
    monkeypatch.setattr(bench.kg, "gram", spy_gram)
    x, y, noise0, params, n = bench.workload(256, dtype=torch.float64, device="cpu")
    coords, _ = grid_mod.make_grid(6, 1.5, dtype=torch.float64, device="cpu")
    model, mean, var, _, _ = bench.rounds(x, y, noise0, params, coords, 64)

    assert len(grams) == 3  # the NaN attempt, the warm-up's fit, the timed fit
    want = torch.where(noise0 < 1.0, noise0 * 10.0, noise0)
    assert torch.equal(grams[0], noise0)
    assert torch.equal(grams[1], want) and torch.equal(grams[2], want)
    assert torch.equal(model.noise, want)
    assert torch.all(want[n:] == 1e10) and torch.all(want[:256] == noise0[:256] * 10.0)
    assert torch.isfinite(mean).all() and torch.isfinite(var).all()

    def always_nan(a):
        l = factor(a)
        l.diagonal().fill_(float("nan"))
        return l

    grams.clear()
    monkeypatch.setattr(lin, "cholesky", always_nan)
    with pytest.raises(FloatingPointError, match="all 4 warm-up attempts"):
        bench.rounds(x, y, noise0, params, coords, 64)
    assert len(grams) == bench.LADDER


def test_bench_verb_prints_one_json_line(capsys, tmp_path):
    torch_jax_native.require()
    path = tmp_path / "grid.npz"
    assert torch_main(["bench", "256", "--device", "cpu", "--save-grid", str(path)]) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1
    result = json.loads(out[0])
    assert BENCH_KEYS <= set(result) <= BENCH_KEYS | STAMP_KEYS and "date" in result
    assert not any(k.endswith("_recorded") for k in result)
    assert result["ok"] is True and result["hbm_peak_gb"] is None
    assert (result["n_train"], result["n_query"]) == (384, 64**3)
    assert abs(result["value"] - (result["fit_s"] + result["query_s"])) <= 1.5e-3

    mean, var, axis, _ = jax_pipeline(256, jnp.float32, 64, 8192)
    verts, _ = jmarching.marching_tetrahedra(mean.reshape(64, 64, 64), axis)
    rmse = float(np.sqrt(np.mean((np.linalg.norm(verts, axis=1) - 1.0) ** 2)))
    assert abs(result["surface_rmse"] - rmse) <= 1e-4

    # --save-grid: the timed round's float32 grid, near the JAX pipeline's.
    with np.load(path) as saved:
        assert saved["mean"].shape == saved["var"].shape == (64, 64, 64)
        assert saved["mean"].dtype == saved["var"].dtype == np.float32
        gaps = [float(np.abs(saved[k].ravel() - want).max()) for k, want in
                (("mean", mean), ("var", var))]
    print("saved grid against the float32 JAX pipeline, max |gap| mean, var:", gaps)
    assert max(gaps) <= 5e-5


def test_bench_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal is for machines without one")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        bench.main(["256"])
