"""The port's out-of-core marginal likelihood and its full-data (stream)
hyperparameter objective (`gp.ooc_hyperopt`, the gradient riding the
TRSM's `on_panel` hook) against the JAX package and against the port's own
dense autograd gradient, on the CPU in float64 at a small size (n <= 256,
panel 64): the MLL and its three gradients for the value and the joint
system at 1e-6, the Adam ascent's history at 1e-6,
`OOCModel.log_marginal_likelihood` (after tactile updates too, and on a
model carried across by `convert`), and the out-of-core session's
subsample and stream branches with their touch tails folded into the
refit (posterior at 1e-6) and their refusals."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_exp_warm  # noqa: F401 -- warms torch.exp before any test (see the module)

from gpis_tpu.api.session import ObjectModelSession as JaxSession
from gpis_tpu.config import ModelConfig as JaxModelConfig
from gpis_tpu.data import gpis as jgpis
from gpis_tpu.gp import ooc_hyperopt as joho
from gpis_tpu.kernels import functions as jkf
from gpis_tpu.linalg import outofcore as jooc
from gpis_tpu_torch import convert
from gpis_tpu_torch.api.session import ObjectModelSession
from gpis_tpu_torch.config import ModelConfig
from gpis_tpu_torch.gp import ooc_hyperopt as oho
from gpis_tpu_torch.gp import regression as gpr
from gpis_tpu_torch.kernels import derivative as kd
from gpis_tpu_torch.linalg import cholesky as lin
from gpis_tpu_torch.linalg import outofcore as ooc

TOL = 1e-6  # BASELINE.md row 2
PANEL, BLOCK = 64, 32
LS, SV, SCALE = 0.7, 1.3, 1.4
KEYS = ("log_ls", "log_noise_scale", "log_sv")


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    """One intra-op thread a test: these sizes gain nothing from more, and
    the suite's workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def problem():
    """250 unit-sphere points (padded to 256), targets, value and gradient
    noises: the JAX tests' problem at a quarter of their size."""
    rng = np.random.default_rng(17)
    n = 250
    x = rng.normal(size=(n, 3))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return dict(x=x, y=rng.normal(size=n) * 0.2, noise=rng.uniform(1e-4, 1e-2, size=n),
                noise_g=rng.uniform(1e-3, 1e-1, size=n))


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _theta():
    return [_t(np.log(v)).requires_grad_(True) for v in (LS, SCALE, SV)]


def _assert_grads(got_mll, got, want_mll, want):
    np.testing.assert_allclose(float(got_mll), float(want_mll), rtol=TOL)
    np.testing.assert_allclose([float(got[k]) for k in KEYS], [float(w) for w in want],
                               rtol=TOL)


@pytest.mark.parametrize("store", ["host", "device"])
def test_ooc_mll_and_grad_matches_dense_autograd_and_jax(problem, store):
    x, y, noise = (_t(problem[k]) for k in ("x", "y", "noise"))
    params = {"lengthscale": LS, "signal_variance": SV}
    mll, g = oho.ooc_mll_and_grad("rbf", x, y, noise, params, panel=PANEL, block=BLOCK,
                                  noise_scale=SCALE, store=store)
    xp, yp, np_, _, c, n, _ = ooc._pad_problem("rbf", x, y, noise, params, panel=PANEL,
                                               pad_noise=1e10)
    real = torch.arange(c) < n
    theta = _theta()
    dense = gpr.log_marginal_likelihood(
        "rbf", xp, yp, torch.where(real, np_ * torch.exp(theta[1]), np_),
        {"lengthscale": torch.exp(theta[0]), "signal_variance": torch.exp(theta[2])},
        n_real=n)
    _assert_grads(mll, g, dense.detach(), torch.autograd.grad(dense, theta))
    jmll, jg = joho.ooc_mll_and_grad("rbf", *(jnp.asarray(problem[k]) for k in ("x", "y", "noise")),
                                     jkf.kernel_params(LS, SV), panel=PANEL, block=BLOCK,
                                     noise_scale=SCALE, store=store)
    _assert_grads(mll, g, jmll, [jg[k] for k in KEYS])


def test_ooc_joint_mll_and_grad_matches_dense_autograd_and_jax(problem):
    n = 62  # C = 64 (J = 256): two padded points, four joint rows each
    x, y, noise_f, noise_g = (_t(problem[k][:n]) for k in ("x", "y", "noise", "noise_g"))
    params = {"lengthscale": LS, "signal_variance": SV}
    mll, g = oho.ooc_joint_mll_and_grad("rbf", x, y, x, noise_f, noise_g, params, panel=PANEL,
                                        block=BLOCK, noise_scale=SCALE, store="host")
    (xp, yj, _, _, nf, ng, _, c, _, _) = ooc._pad_joint_problem(
        "rbf", x, y, x, noise_f, noise_g, params, panel=PANEL, pad_noise=1e10)
    real = torch.arange(c) < n
    theta = _theta()
    nf_eff = torch.where(real, nf * torch.exp(theta[1]), nf)
    k = kd.joint_gram_reference("rbf", xp, {"lengthscale": torch.exp(theta[0]),
                                            "signal_variance": torch.exp(theta[2])},
                                noise_f=nf_eff, noise_g=ng)
    l = torch.linalg.cholesky(k)
    u = lin.solve_lower(l, yj)
    n_tot = torch.cat([nf_eff, ng, ng, ng])
    pad = ~real.repeat(4)
    dense = (-0.5 * u @ u - torch.sum(torch.log(torch.diagonal(l)))
             - 0.5 * 4 * c * np.log(2.0 * np.pi)
             + torch.sum(torch.where(pad, 0.5 * torch.log(2.0 * np.pi * n_tot), 0.0)))
    _assert_grads(mll, g, dense.detach(), torch.autograd.grad(dense, theta))
    ja = [jnp.asarray(problem[k][:n]) for k in ("x", "y", "x", "noise", "noise_g")]
    jmll, jg = joho.ooc_joint_mll_and_grad("rbf", *ja, jkf.kernel_params(LS, SV), panel=PANEL,
                                           block=BLOCK, noise_scale=SCALE, store="host")
    _assert_grads(mll, g, jmll, [jg[k] for k in KEYS])


@pytest.mark.parametrize("joint", [False, True])
def test_optimize_ooc_history_matches_jax(problem, joint):
    n = 62 if joint else 250
    names = ("x", "y", "x", "noise", "noise_g") if joint else ("x", "y", "noise")
    kw = dict(panel=PANEL, block=BLOCK, steps=3, learning_rate=0.1, learn_signal=True,
              store="host")
    opt, jopt = ((oho.optimize_ooc_joint, joho.optimize_ooc_joint) if joint
                 else (oho.optimize_ooc, joho.optimize_ooc))
    res = opt("rbf", *(_t(problem[k][:n]) for k in names),
              {"lengthscale": 1.5, "signal_variance": 1.0}, **kw)
    jres = jopt("rbf", *(jnp.asarray(problem[k][:n]) for k in names),
                jkf.kernel_params(1.5, 1.0), **kw)
    np.testing.assert_allclose(res["history"], jres["history"], rtol=TOL)
    np.testing.assert_allclose(res["mll"], jres["mll"], rtol=TOL)
    np.testing.assert_allclose(res["noise_scale"], float(jres["noise_scale"]), rtol=TOL)
    for key in ("lengthscale", "signal_variance"):
        np.testing.assert_allclose(res["params"][key], float(jres["params"][key]), rtol=TOL)


def test_ooc_model_log_marginal_likelihood_matches_jax(problem):
    """The fit's byproducts (u, sum log diag L) against the JAX model's and
    the dense MLL with n_real; after a tactile update the tail's bordered
    block joins; a JAX model carried across by `convert` reads the JAX
    number."""
    names = ("x", "y", "noise")
    params = {"lengthscale": LS, "signal_variance": SV}
    m = ooc.ooc_fit("rbf", *(_t(problem[k]) for k in names), params, panel=PANEL, block=BLOCK)
    jm = jooc.ooc_fit("rbf", *(jnp.asarray(problem[k]) for k in names),
                      jkf.kernel_params(LS, SV), panel=PANEL, block=BLOCK)
    dense = gpr.log_marginal_likelihood("rbf", m.x, m.y, m.noise, params, n_real=m.n_real)
    np.testing.assert_allclose(m.log_marginal_likelihood(), float(dense), rtol=1e-9)
    np.testing.assert_allclose(m.log_marginal_likelihood(), jm.log_marginal_likelihood(),
                               rtol=1e-9)
    touch = problem["x"][:5] * 1.05
    mt = m.update(_t(touch), 0.0, 1e-4, tail_capacity=8)
    jmt = jm.update(jnp.asarray(touch), 0.0, 1e-4, tail_capacity=8)
    np.testing.assert_allclose(mt.log_marginal_likelihood(), jmt.log_marginal_likelihood(),
                               rtol=1e-9)
    arrays = {k: np.asarray(getattr(jm, k)) for k in ("x", "y", "noise", "alpha", "u")}
    arrays["logdiag_sum"] = jm.logdiag_sum
    panels = [np.asarray(jm.wstore.get(j)) for j in range(m.capacity // PANEL)]
    carried = convert.ooc_model_from_arrays(arrays, panels, kernel="rbf", params=params,
                                            panel=PANEL, n_real=jm.n_real, device="cpu")
    assert carried.log_marginal_likelihood() == pytest.approx(jm.log_marginal_likelihood(),
                                                              rel=1e-12)


def test_ooc_joint_model_log_marginal_likelihood_matches_jax(problem):
    n = 62
    names = ("x", "y", "x", "noise", "noise_g")
    m = ooc.ooc_fit_joint("rbf", *(_t(problem[k][:n]) for k in names),
                          {"lengthscale": LS, "signal_variance": SV}, panel=PANEL, block=BLOCK)
    jm = jooc.ooc_fit_joint("rbf", *(jnp.asarray(problem[k][:n]) for k in names),
                            jkf.kernel_params(LS, SV), panel=PANEL, block=BLOCK)
    np.testing.assert_allclose(m.log_marginal_likelihood(), jm.log_marginal_likelihood(),
                               rtol=1e-9)


def test_ooc_model_without_its_byproducts_refuses_the_mll(problem):
    m = ooc.ooc_fit("rbf", *(_t(problem[k][:100]) for k in ("x", "y", "noise")),
                    {"lengthscale": LS, "signal_variance": SV}, panel=PANEL, block=BLOCK)
    m.logdiag_sum = None
    with pytest.raises(ValueError, match="logdiag_sum"):
        m.log_marginal_likelihood()


# ------------------------------------------------------------- session

PTS = np.asarray(jgpis.fibonacci_sphere(200, radius=1.0))
TOUCH = PTS[:6] * 1.02
Q = np.random.default_rng(3).uniform(-1.5, 1.5, size=(40, 3))


def _sessions(normals):
    kw = dict(kernel="rbf", lengthscale=0.8, noise_surface=1e-3, n_external=32, n_internal=1,
              block=32, dtype="float64", touch_capacity=16)
    start = {"out_of_core": True} if normals is None else {"out_of_core": True, "normals": normals}
    sess = ObjectModelSession(ModelConfig(**kw), device="cpu").start(PTS, **start)
    jsess = JaxSession(JaxModelConfig(**kw)).start(PTS, **start)
    return sess, jsess


@pytest.mark.parametrize("joint", [False, True])
@pytest.mark.parametrize("method", ["subsample", "stream"])
def test_ooc_session_hyperopt_matches_jax(joint, method):
    sess, jsess = _sessions(PTS if joint else None)
    sess.update(TOUCH)
    jsess.update(TOUCH)
    kw = {"subsample": 120} if method == "subsample" else {}
    res = sess.optimize_hyperparameters(method=method, steps=2, **kw)
    jres = jsess.optimize_hyperparameters(method=method, steps=2, **kw)
    np.testing.assert_allclose(res.history, jres.history, rtol=TOL)
    np.testing.assert_allclose(res.params["lengthscale"], float(jres.params["lengthscale"]),
                               rtol=TOL)
    assert sess.model.n_tail == 0 and sess.model.n_real == jsess.model.n_real
    for got, want in zip(sess.query(Q), jsess.query(Q)):
        np.testing.assert_allclose(got, want, atol=TOL)
    assert np.abs(sess.query(TOUCH)[0]).max() < 0.05  # the touches folded into the refit
    with pytest.raises(ValueError) as e:
        jsess.optimize_hyperparameters(method="distributed")
    with pytest.raises(ValueError) as got:
        sess.optimize_hyperparameters(method="distributed")
    assert str(got.value) == str(e.value)


def test_ooc_trsm_accumulates_alpha_and_hands_each_sweep_to_on_panel(problem):
    """`ooc_trsm`'s alpha = W^T (W y) against JAX's and the substitution
    alpha, and its on_panel hook: the sweeps' full-width rows reassemble
    the stored W; store_final=False leaves the last sweep out of the store."""
    names = ("x", "y", "noise")
    x, y, noise = (_t(problem[k]) for k in names)
    params = {"lengthscale": LS, "signal_variance": SV}
    xp, yp, np_, p, c, _, _ = ooc._pad_problem("rbf", x, y, noise, params, panel=PANEL,
                                               pad_noise=1e10)
    jp = jkf.kernel_params(LS, SV)
    runs = []
    for store_final in (True, False):
        st = ooc.DevicePanelStore("cpu")
        ok, u = ooc.ooc_cholesky("rbf", xp, np_, p, st, panel=PANEL, block=BLOCK, y=yp)
        sub = ooc.ooc_alpha_backward(st, u, panel=PANEL)
        wst, rows = ooc.DevicePanelStore("cpu"), {}
        alpha = ooc.ooc_trsm(st, wst, yp, panel=PANEL, block=BLOCK, sweep=2,
                             on_panel=lambda j0, w: rows.update({j0: w.clone()}),
                             store_final=store_final)
        runs.append((alpha, sub, wst, rows))
    jst = jooc.DevicePanelStore()
    assert jooc.ooc_cholesky("rbf", jnp.asarray(xp.numpy()), jnp.asarray(np_.numpy()), jp, jst,
                             panel=PANEL, block=BLOCK)[0]
    jalpha = jooc.ooc_trsm(jst, jooc.DevicePanelStore(), jnp.asarray(yp.numpy()), panel=PANEL,
                           block=BLOCK, sweep=2)
    alpha, sub, wst, rows = runs[0]
    np.testing.assert_allclose(alpha.numpy(), np.asarray(jalpha), atol=1e-8)
    np.testing.assert_allclose(alpha.numpy(), sub.numpy(), atol=1e-8)
    w = torch.cat([rows[j0] for j0 in sorted(rows)])
    assert sorted(rows) == list(range(0, c, 2 * PANEL))
    for j in range(c // PANEL):
        stored = wst.get(j)
        np.testing.assert_array_equal(w[j * PANEL:(j + 1) * PANEL, :stored.shape[1]].numpy(),
                                      stored.numpy())
        assert not w[j * PANEL:(j + 1) * PANEL, stored.shape[1]:].any()
    nb = c // PANEL
    assert all(j in runs[1][2] for j in range(nb - 2)) and not any(
        j in runs[1][2] for j in range(nb - 2, nb))
