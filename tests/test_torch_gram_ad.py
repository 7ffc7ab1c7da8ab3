"""The port's differentiable marginal-likelihood pieces against the JAX
package, on the CPU in float64: `kernels.gram.gram_ad` (its VJP held to
JAX's `gram_ad` and to torch.autograd through `gram_reference` at 1e-9
relative, over rbf, the thin plate and a registered kernel without
dk_dr2, banded and not, scalar and vector noise), `blocked_cholesky_ad`
(`torch.autograd.gradcheck`, the composition with `gram_ad` included, and
a NaN diagonal for a matrix that is not positive definite),
`regression.log_marginal_likelihood` (value and gradient against JAX's at
1e-9, with and without n_real, on both factor routes), and the JAX names
the port gained beside them: `register_kernel`, `blocked_cholesky`,
`blocked_linv` and `with_inverse` (1e-6, BASELINE.md row 2)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_exp_warm  # noqa: F401 -- warms torch.exp before any test (see the module)

from gpis_tpu import config as jconfig
from gpis_tpu.gp import regression as jgpr
from gpis_tpu.kernels import functions as jkf
from gpis_tpu.kernels import gram as jkg
from gpis_tpu.linalg import cholesky as jlin
from gpis_tpu_torch import config
from gpis_tpu_torch.gp import regression as gpr
from gpis_tpu_torch.kernels import functions as kf
from gpis_tpu_torch.kernels import gram as kg
from gpis_tpu_torch.linalg import cholesky as lin

N = 96
LS, SV = 0.8, 1.2
RQ = "rational_quadratic_2"  # registered in both packages, no dk_dr2


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    """One intra-op thread a test: these sizes gain nothing from more, and
    the suite's workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def registered():
    """A rational-quadratic kernel (alpha 2) registered in both packages
    without a derivative: gram_ad's pullback takes dk/dr2 by forward AD."""
    kf.register_kernel(RQ, k_r2=lambda r2, p: p["signal_variance"] * (
        1.0 + r2 / (4.0 * p["lengthscale"] ** 2)) ** -2.0,
        k_diag0=lambda p: p["signal_variance"])
    jkf.register_kernel(RQ, k_r2=lambda r2, p: p["signal_variance"] * (
        1.0 + r2 / (4.0 * p["lengthscale"] ** 2)) ** -2.0,
        k_diag0=lambda p: p["signal_variance"])
    yield
    kf.unregister_kernel(RQ)
    jkf.unregister_kernel(RQ)


@pytest.fixture(scope="module")
def prob():
    rng = np.random.default_rng(11)
    return dict(x=rng.normal(size=(N, 3)), noise=rng.uniform(1e-3, 1e-2, size=N),
                kbar=rng.normal(size=(N, N)), y=rng.normal(size=N) * 0.2)


def _leaf(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64, requires_grad=True)


def _port_grads(fn, name, x, noise, band):
    """(x, noise, lengthscale, signal variance) cotangents of <fn(...), Kbar>."""
    xt, nt = _leaf(x), _leaf(noise)
    ls, sv = _leaf(LS), _leaf(SV)
    kw = {} if band is None else {"band": band}
    out = fn(name, xt, {"lengthscale": ls, "signal_variance": sv}, nt, **kw)
    return out, (xt, nt, ls, sv)


@pytest.mark.parametrize("name", ["rbf", "thin_plate", RQ])
@pytest.mark.parametrize("band", [32, N])
@pytest.mark.parametrize("scalar_noise", [False, True])
def test_gram_ad_vjp_matches_jax_and_autograd(prob, name, band, scalar_noise):
    noise = 3e-3 if scalar_noise else prob["noise"]
    kbar = torch.tensor(prob["kbar"])
    k, leaves = _port_grads(kg.gram_ad, name, prob["x"], noise, band)
    got = torch.autograd.grad(torch.sum(k * kbar), leaves)
    k_ref, leaves_ref = _port_grads(kg.gram_reference, name, prob["x"], noise, None)
    want = torch.autograd.grad(torch.sum(k_ref * kbar), leaves_ref)
    np.testing.assert_allclose(k.detach().numpy(), k_ref.detach().numpy(), rtol=1e-12)

    def via_ad(x_, p_, n_):
        return jnp.sum(jkg.gram_ad(name, x_, p_, n_, band=band) * prob["kbar"])

    jg = jax.grad(via_ad, argnums=(0, 1, 2))(jnp.asarray(prob["x"]), jkf.kernel_params(LS, SV),
                                             jnp.asarray(noise))
    jax_grads = (jg[0], jg[2], jg[1]["lengthscale"], jg[1]["signal_variance"])
    for g, w, j in zip(got, want, jax_grads):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=1e-9, atol=1e-12)


def test_gram_ad_graph_holds_no_pairwise_difference_tensor(prob):
    """Every tensor autograd saves for the MLL's backward is at most 2-D:
    no (C, C, 3) difference tensor (nor its band) stays in the graph."""
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t

    x, ls = _leaf(prob["x"]), _leaf(LS)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        mll = gpr.log_marginal_likelihood("rbf", x, torch.tensor(prob["y"]),
                                          torch.tensor(prob["noise"]),
                                          {"lengthscale": ls, "signal_variance": SV})
    assert shapes and all(len(s) <= 2 for s in shapes), shapes
    torch.autograd.grad(mll, (x, ls))


def test_blocked_cholesky_ad_gradcheck(prob):
    """gradcheck through gram_ad into the in-place factor: the Gram's
    backward must not read the Gram the factor overwrote."""
    noise = torch.tensor(prob["noise"][:12])

    def factor(x, ls):
        k = kg.gram_ad("rbf", x, {"lengthscale": ls, "signal_variance": SV}, noise, band=6)
        return lin.blocked_cholesky_ad(k, 4)

    assert torch.autograd.gradcheck(factor, (_leaf(prob["x"][:12]), _leaf(LS)))


def test_blocked_cholesky_ad_gradcheck_on_a_symmetric_input():
    b = torch.tensor(np.random.default_rng(2).normal(size=(12, 12)), requires_grad=True)

    def factor(b_):
        return lin.blocked_cholesky_ad(b_ @ b_.T + 12.0 * torch.eye(12, dtype=b_.dtype), 4)

    assert torch.autograd.gradcheck(factor, (b,))


def test_blocked_cholesky_ad_returns_a_nan_diagonal_when_not_positive_definite():
    a = -torch.eye(32, dtype=torch.float64) + 0.0
    l = lin.blocked_cholesky_ad(a, 8)
    assert torch.isnan(l.diagonal()).all()


@pytest.mark.parametrize("n_real", [None, 80])
@pytest.mark.parametrize("route", ["library", "blocked"])
def test_log_marginal_likelihood_matches_jax(prob, n_real, route):
    x, y, noise = prob["x"], prob["y"], prob["noise"]
    chol = {"library": None, "blocked": lambda k: lin.blocked_cholesky_ad(k, 32)}[route]
    jchol = {"library": None, "blocked": lambda k: jlin.blocked_cholesky_ad(k, 32)}[route]
    ls, sv, nz = _leaf(LS), _leaf(SV), _leaf(noise)
    mll = gpr.log_marginal_likelihood("rbf", torch.tensor(x), torch.tensor(y), nz,
                                      {"lengthscale": ls, "signal_variance": sv},
                                      n_real=n_real, chol_impl=chol)
    got = torch.autograd.grad(mll, (ls, sv, nz))

    def jmll(ls_, sv_, n_):
        return jgpr.log_marginal_likelihood("rbf", jnp.asarray(x), jnp.asarray(y), n_,
                                            {"lengthscale": ls_, "signal_variance": sv_},
                                            n_real=n_real, chol_impl=jchol)

    args = (jnp.asarray(LS), jnp.asarray(SV), jnp.asarray(noise))
    want, jg = jax.value_and_grad(jmll, argnums=(0, 1, 2))(*args)
    np.testing.assert_allclose(float(mll.detach()), float(want), rtol=1e-9)
    for g, w in zip(got, jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9, atol=1e-12)


def test_log_marginal_likelihood_is_nan_not_an_exception_when_indefinite(prob):
    x = torch.tensor(np.repeat(prob["x"][:8], 2, axis=0))  # repeated points, no noise
    mll = gpr.log_marginal_likelihood("rbf", x, torch.zeros(16, dtype=torch.float64),
                                      torch.full((16,), -1e-3, dtype=torch.float64),
                                      {"lengthscale": LS, "signal_variance": SV})
    assert torch.isnan(mll)


# ------------------------------------------ the JAX names beside them


def test_registered_kernel_is_accepted_by_the_config_as_jax():
    assert config.ModelConfig(kernel=RQ).kernel == jconfig.ModelConfig(kernel=RQ).kernel == RQ
    with pytest.raises(ValueError, match="unknown kernel"):
        config.ModelConfig(kernel="not_registered")
    with pytest.raises(ValueError, match="cannot shadow"):
        kf.register_kernel("rbf", k_r2=lambda r2, p: r2, k_diag0=lambda p: 1.0)
    assert not kf.supports_derivatives(RQ) and not jkf.supports_derivatives(RQ)


def test_registered_kernel_fits_and_predicts_as_jax(prob):
    x, y, noise = prob["x"], prob["y"], prob["noise"]
    params = {"lengthscale": LS, "signal_variance": SV}
    m = gpr.with_linv(gpr.fit(RQ, torch.tensor(x), torch.tensor(y), torch.tensor(noise), params,
                              block=32, touch_capacity=0))
    jm = jgpr.with_linv(jgpr.fit(RQ, jnp.asarray(x), jnp.asarray(y), jnp.asarray(noise),
                                 jkf.kernel_params(LS, SV), block=32, touch_capacity=0))
    q = np.random.default_rng(4).normal(size=(50, 3))
    for got, want in zip(gpr.predict(m, torch.tensor(q)), jgpr.predict(jm, jnp.asarray(q))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    r2 = torch.linspace(0.0, 4.0, 9, dtype=torch.float64)
    np.testing.assert_allclose(kf.dk_dr2(RQ, r2, params).numpy(),
                               np.asarray(jkf.dk_dr2(RQ, jnp.asarray(r2.numpy()),
                                                     jkf.kernel_params(LS, SV))), rtol=1e-12)


def _spd(n, seed=3):
    x = np.random.default_rng(seed).normal(size=(n, 3))
    return np.asarray(jkg.gram("rbf", jnp.asarray(x), jkf.kernel_params(LS, SV), noise=1e-2))


@pytest.mark.parametrize("block", [32, 64])
def test_blocked_cholesky_and_linv_match_jax(block):
    a = _spd(128)
    at = torch.tensor(a)
    l = lin.blocked_cholesky(at, block)
    np.testing.assert_array_equal(at.numpy(), a)  # a new matrix, as in JAX
    jl = jlin.blocked_cholesky(jnp.asarray(a), block, precision=jax.lax.Precision.HIGHEST)
    np.testing.assert_allclose(l.numpy(), np.asarray(jl), atol=1e-6)
    w = lin.blocked_linv(l, block, precision="highest")
    np.testing.assert_allclose(w.numpy(), np.asarray(jlin.blocked_linv(jl, block)), atol=1e-6)
    with pytest.raises(ValueError, match="multiple of block"):
        lin.blocked_cholesky(at[:100, :100], block)


def test_with_inverse_predicts_as_jax(prob):
    x, y, noise = prob["x"], prob["y"], prob["noise"]
    params = {"lengthscale": LS, "signal_variance": SV}
    m = gpr.with_inverse(gpr.fit("rbf", torch.tensor(x), torch.tensor(y), torch.tensor(noise),
                                 params, block=32, touch_capacity=32))
    jm = jgpr.with_inverse(jgpr.fit("rbf", jnp.asarray(x), jnp.asarray(y), jnp.asarray(noise),
                                    jkf.kernel_params(LS, SV), block=32, touch_capacity=32))
    np.testing.assert_allclose(m.kinv.numpy(), np.asarray(jm.kinv), atol=1e-6)
    q = np.random.default_rng(5).normal(size=(40, 3))
    for got, want in zip(gpr.predict(m, torch.tensor(q)), jgpr.predict(jm, jnp.asarray(q))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
