"""The port's marginal-likelihood hyperparameter optimization (config 3,
`gp.hyperopt`) and the in-core session's `optimize_hyperparameters`
against the JAX package, on the CPU in float64: the history (the MLL at
every iterate) and the optimum at 1e-6 on the JAX tests' own problems
(tests/test_hyperopt.py): Adam from a lengthscale 4x off, Adam learning
the noise, L-BFGS (optax.lbfgs's recursion and zoom line search, ported)
for 5 steps, and for 40 steps marked slow as the JAX test is; the joint
objective learning every scale; the session's value and joint branches
with their touches folded into the refit, held on the posterior at 1e-6,
and the in-core method refusal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_exp_warm  # noqa: F401 -- warms torch.exp before any test (see the module)

import oracle
from gpis_tpu.api.session import ObjectModelSession as JaxSession
from gpis_tpu.config import ModelConfig as JaxModelConfig
from gpis_tpu.data import gpis as jgpis
from gpis_tpu.gp import hyperopt as jho
from gpis_tpu.gp import regression as jgpr
from gpis_tpu.kernels import functions as jkf
from gpis_tpu_torch.api.session import ObjectModelSession
from gpis_tpu_torch.config import ModelConfig
from gpis_tpu_torch.gp import hyperopt as ho

TOL = 1e-6  # BASELINE.md row 2


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    """One intra-op thread a test: these sizes gain nothing from more, and
    the suite's workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sample():
    """tests/test_hyperopt.py's `_padded_gp_sample`: y drawn from an RBF GP
    of lengthscale 0.6 on 60 points, padded to 128 rows."""
    rng = np.random.default_rng(1234)
    n = 60
    x = rng.normal(size=(n, 3))
    k = oracle.gram("rbf", x, 0.6, 1.0, noise=1e-4)
    y = np.linalg.cholesky(k) @ rng.normal(size=n)
    xp, yp, np_ = jgpr._pad_training(jnp.asarray(x), jnp.asarray(y), jnp.full(n, 1e-4), 128,
                                     1e10, jnp.float64)
    return xp, yp, np_, n


def _both(sample, init, **kw):
    xp, yp, np_, n = sample
    t = [torch.tensor(np.asarray(a)) for a in (xp, yp, np_)]
    res = ho.optimize("rbf", *t, {"lengthscale": init, "signal_variance": 1.0}, n_real=n, **kw)
    jres = jho.optimize("rbf", xp, yp, np_, jkf.kernel_params(init, 1.0), n_real=n, **kw)
    return res, jres


def _same(res, jres):
    np.testing.assert_allclose(res.history, jres.history, rtol=TOL)
    np.testing.assert_allclose(res.mll, jres.mll, rtol=TOL)
    for k in ("lengthscale", "signal_variance"):
        np.testing.assert_allclose(res.params[k], float(jres.params[k]), rtol=TOL)
    np.testing.assert_allclose(res.noise.numpy(), np.asarray(jres.noise), rtol=TOL)
    np.testing.assert_allclose(res.noise_scale, float(jres.noise_scale), rtol=TOL)


def test_optimize_adam_matches_jax(sample):
    res, jres = _both(sample, 2.5, steps=80)  # 4x off, as the JAX test starts
    _same(res, jres)
    assert 0.37 < res.params["lengthscale"] < 1.0


def test_optimize_learns_noise_and_signal_as_jax(sample):
    res, jres = _both(sample, 0.6, steps=30, learn_noise=True, learn_signal=True)
    _same(res, jres)
    assert float(res.noise[-1]) == pytest.approx(1e10)  # padding keeps its variance


def test_optimize_lbfgs_matches_jax(sample):
    res, jres = _both(sample, 2.0, steps=5, optimizer="lbfgs", learn_noise=False)
    _same(res, jres)


@pytest.mark.slow
def test_optimize_lbfgs_40_steps_matches_jax(sample):
    res, jres = _both(sample, 2.0, steps=40, optimizer="lbfgs", learn_noise=False)
    _same(res, jres)


def test_optimize_joint_learns_every_scale_as_jax():
    pts = np.asarray(jgpis.fibonacci_sphere(48, radius=1.0))
    normals = pts / np.linalg.norm(pts, axis=1, keepdims=True)
    n = pts.shape[0]
    args = (pts, np.zeros(n), normals, np.full(n, 1e-4), np.full(n, 1e-1))
    kw = dict(n_real=n, steps=12, learn_noise=True, learn_noise_g=True, learn_signal=True)
    res = ho.optimize_joint("rbf", *(torch.tensor(a) for a in args),
                            {"lengthscale": 0.8, "signal_variance": 0.2}, **kw)
    jres = jho.optimize_joint("rbf", *(jnp.asarray(a) for a in args),
                              jkf.kernel_params(0.8, 0.2), **kw)
    _same(res, jres)
    np.testing.assert_allclose(res.noise_g.numpy(), np.asarray(jres.noise_g), rtol=TOL)
    np.testing.assert_allclose(res.noise_scale_g, float(jres.noise_scale_g), rtol=TOL)


# ------------------------------------------------------------- session

PTS = np.asarray(jgpis.fibonacci_sphere(200, radius=1.0))
TOUCH = PTS[:6] * 1.02
Q = np.random.default_rng(3).uniform(-1.5, 1.5, size=(40, 3))


def _sessions(touch_capacity, normals=None):
    kw = dict(kernel="rbf", lengthscale=0.8, noise_surface=1e-3, n_external=32, n_internal=1,
              block=32, dtype="float64", touch_capacity=touch_capacity)
    start = {} if normals is None else {"normals": normals}
    sess = ObjectModelSession(ModelConfig(**kw), device="cpu").start(PTS, **start)
    jsess = JaxSession(JaxModelConfig(**kw)).start(PTS, **start)
    return sess, jsess


@pytest.mark.parametrize("kind", ["value", "value_inference", "joint"])
def test_session_hyperopt_matches_jax(kind):
    """Value (with touches in its slots, and a query-only session without
    slots) and joint (touches folded into the refit's core)."""
    sess, jsess = _sessions(0 if kind == "value_inference" else 16,
                            PTS if kind == "joint" else None)
    if kind != "value_inference":
        sess.update(TOUCH)
        jsess.update(TOUCH)
    res = sess.optimize_hyperparameters(steps=3)
    jres = jsess.optimize_hyperparameters(steps=3)
    np.testing.assert_allclose(res.history, jres.history, rtol=TOL)
    np.testing.assert_allclose(res.params["lengthscale"], float(jres.params["lengthscale"]),
                               rtol=TOL)
    np.testing.assert_allclose(sess.model.params["lengthscale"], res.params["lengthscale"])
    for got, want in zip(sess.query(Q), jsess.query(Q)):
        np.testing.assert_allclose(got, want, atol=TOL)
    mean, _ = sess.query(TOUCH)
    assert np.abs(mean).max() < 0.05  # the touches are still observed after the refit


def test_session_hyperopt_refuses_other_methods_as_jax():
    sess, jsess = _sessions(0)
    for method in ("stream", "distributed"):
        with pytest.raises(ValueError) as e:
            jsess.optimize_hyperparameters(method=method)
        with pytest.raises(ValueError) as got:
            sess.optimize_hyperparameters(method=method)
        assert str(got.value) == str(e.value)
    with pytest.raises(RuntimeError, match="no model fitted yet"):
        ObjectModelSession(device="cpu").optimize_hyperparameters()
