"""The port's tactile updates against the JAX package, on the CPU in float64
(the port's wrappers take their plain twins for CPU tensors): the in-core
bordering update with and without W (`gp.regression.update`), its guards
and `reset_touches`; the joint bordering update (`gp.derivative
.update_joint`); the session's `update` on value and joint models,
bordering and the joint overflow refit; and touched JAX models carried
across by `convert`.  The JAX side runs its jnp forms on the CPU at these
sizes; the bar is BASELINE.md row 2, 1e-6 on posterior mean and variance
(the JAX tests' own 1e-8 where a test of theirs is mirrored at it)."""

import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_exp_warm  # noqa: F401 -- warms torch.exp before any test (see the module)

import oracle
from gpis_tpu.api.session import ObjectModelSession as JaxSession
from gpis_tpu.config import ModelConfig as JaxModelConfig
from gpis_tpu.gp import derivative as jgpd
from gpis_tpu.gp import regression as jgpr
from gpis_tpu.kernels import functions as jkf
from gpis_tpu_torch import convert
from gpis_tpu_torch.api.session import ObjectModelSession
from gpis_tpu_torch.config import ModelConfig
from gpis_tpu_torch.data.gpis import fibonacci_sphere
from gpis_tpu_torch.gp import derivative as gpd
from gpis_tpu_torch.gp import regression as gpr
from gpis_tpu_torch.kernels import functions as kf

LS, SV = 0.8, 1.2


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _params():
    return kf.kernel_params(LS, SV), jkf.kernel_params(LS, SV)


def _close(got, want, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol)


def _problem(n, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, 3)), rng.normal(size=n) * 0.3, rng.uniform(1e-4, 1e-2, size=n)


def _fits(n=80, seed=3, touch=64, block=64, linv=False):
    """The same value problem fitted by both packages (W attached with linv)."""
    x, y, noise = _problem(n, seed)
    p, jp = _params()
    m = gpr.fit("rbf", _t(x), _t(y), _t(noise), p, block=block, touch_capacity=touch)
    jm = jgpr.fit("rbf", _j(x), _j(y), _j(noise), jp, block=block, touch_capacity=touch)
    if linv:
        m, jm = gpr.with_linv(m, block=block), jgpr.with_linv(jm, block=block)
    return m, jm, (x, y, noise)


def _touches(seed, *sizes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(k, 3)) * 0.9 for k in sizes]


def _same_posterior(m, jm, q, atol=1e-6):
    mean, var = gpr.predict(m, _t(q))
    jmean, jvar = jgpr.predict(jm, _j(q))
    _close(mean, jmean, atol)
    _close(var, jvar, atol)


# ------------------------------------------------------------ value update


@pytest.mark.parametrize("linv", [False, True])
def test_update_matches_jax_and_oracle(linv):
    """Two batches (the second at a nonzero slot offset), tests/test_gp.py's
    test_update_matches_refit, with and without W: the port's session
    attaches W at every capacity, the JAX session only from 512."""
    m, jm, (x, y, noise) = _fits(linv=linv)
    t1, t2 = _touches(4, 7, 5)
    for tx in (t1, t2):
        m = gpr.update(m, _t(tx), _t(np.zeros(len(tx))), 1e-6)
        jm = jgpr.update(jm, _j(tx), _j(np.zeros(len(tx))), 1e-6)
    assert m.n_touch == int(jm.n_touch) == 12
    assert (m.linv is not None) == (jm.linv is not None) == linv
    q = np.random.default_rng(5).normal(size=(25, 3))
    _same_posterior(m, jm, q)
    _close(m.alpha, jm.alpha)
    _close(m.chol, jm.chol)
    if linv:
        _close(m.linv, jm.linv)
    om = oracle.fit("rbf", np.concatenate([x, t1, t2]), np.concatenate([y, np.zeros(12)]),
                    np.concatenate([noise, np.full(12, 1e-6)]), LS, SV)
    omean, ovar = oracle.predict(om, q)
    mean, var = gpr.predict(m, _t(q))
    _close(mean, omean)
    _close(var, ovar)


def test_update_leaves_the_caller_model_unchanged():
    m, _, _ = _fits(linv=True)
    q = _t(np.random.default_rng(6).normal(size=(20, 3)))
    before = [t.clone() for t in (m.x, m.y, m.noise, m.chol, m.alpha, m.linv)]
    mean0, var0 = gpr.predict(m, q)
    gpr.update(m, _t(_touches(7, 6)[0]), 0.0, 1e-6)
    for a, b in zip(before, (m.x, m.y, m.noise, m.chol, m.alpha, m.linv)):
        assert torch.equal(a, b)
    mean1, var1 = gpr.predict(m, q)
    assert torch.equal(mean0, mean1) and torch.equal(var0, var1)


def test_update_carries_linv():
    """tests/test_gp.py's test_update_carries_linv: W stays L^{-1}, and the
    posterior through it equals the solve path's."""
    m, _, _ = _fits(n=60, linv=True)
    m2 = gpr.update(m, _t(_touches(8, 5)[0]), _t(np.zeros(5)), 1e-6)
    np.testing.assert_allclose((m2.linv @ m2.chol).numpy(), np.eye(m2.capacity), atol=1e-8)
    q = _t(np.random.default_rng(9).normal(size=(12, 3)))
    mean_w, var_w = gpr.predict(m2, q)
    mean_s, var_s = gpr.predict(dataclasses.replace(m2, linv=None), q)
    _close(mean_w, mean_s, 1e-9)
    _close(var_w, var_s, 1e-8)


def test_update_zeroes_the_upper_block_of_w_as_jax_does():
    """The update writes W's block [:n0, n0:] to zero whatever it held (a
    TRSM that leaves its upper triangle unwritten hands over such a W)."""
    m, jm, _ = _fits(linv=True)
    junk = np.random.default_rng(10).normal(size=m.linv.shape)
    junk[:, :m.n0] = 0.0
    junk[m.n0:] = 0.0
    m = dataclasses.replace(m, linv=m.linv + _t(junk))
    jm = dataclasses.replace(jm, linv=jm.linv + _j(junk))
    tx = _touches(11, 4)[0]
    m2, jm2 = gpr.update(m, _t(tx), 0.0, 1e-6), jgpr.update(jm, _j(tx), 0.0, 1e-6)
    _close(m2.linv, jm2.linv)
    assert not m2.linv[:m.n0, m.n0:].any()
    _same_posterior(m2, jm2, np.random.default_rng(12).normal(size=(20, 3)))


def test_update_scalar_target_broadcasts():
    m, _, _ = _fits(n=40, touch=32, block=32)
    tx = _t(_touches(13, 3)[0])
    assert torch.equal(gpr.update(m, tx, 0.0, 1e-6).y, gpr.update(m, tx, _t(np.zeros(3)), 1e-6).y)


@pytest.mark.parametrize("noise", [0.0, 1e-20])
def test_update_noise_floor_matches_jax(noise):
    """A touch noise below 4 eps C k(0) is raised to it, as in JAX."""
    m, jm, _ = _fits()
    tx = _touches(14, 5)[0]
    m2, jm2 = gpr.update(m, _t(tx), 0.0, noise), jgpr.update(jm, _j(tx), 0.0, noise)
    floor = 4.0 * np.finfo(np.float64).eps * m.capacity * SV
    np.testing.assert_allclose(m2.noise.numpy(), np.asarray(jm2.noise), rtol=1e-12, atol=0)
    assert np.allclose(m2.noise[m.n0:m.n0 + 5].numpy(), floor, rtol=1e-12, atol=0)


def _jax_message(call) -> str:
    with pytest.raises(ValueError) as e:
        call()
    return re.escape(str(e.value))


@pytest.mark.parametrize("case", ["batch", "cumulative", "no_slots"])
def test_update_guards_raise_as_jax(case):
    m, jm, (x, y, noise) = _fits(n=40, touch=8, block=8)
    t = m.capacity - m.n0
    rng = np.random.default_rng(15)
    if case == "batch":
        tx = rng.normal(size=(t + 1, 3))
    elif case == "cumulative":
        first = rng.normal(size=(6, 3))
        m = gpr.update(m, _t(first), 0.0, 1e-6)
        jm = jgpr.update(jm, _j(first), 0.0, 1e-6)
        tx = rng.normal(size=(t - 3, 3))
    else:  # fit_inference: no slots, its chol is W
        p, jp = _params()
        m = gpr.fit_inference("rbf", _t(x), _t(y), _t(noise), p, block=8)
        jm = jgpr.fit_inference("rbf", _j(x), _j(y), _j(noise), jp, block=8)
        tx = rng.normal(size=(1, 3))
    want = _jax_message(lambda: jgpr.update(jm, _j(tx), 0.0, 1e-6))
    with pytest.raises(ValueError, match=f"^{want}$"):
        gpr.update(m, _t(tx), 0.0, 1e-6)


@pytest.mark.parametrize("fill", ["some", "all"])
def test_reset_touches_matches_jax(fill):
    """tests/test_gp.py's test_reset_touches and test_reset_touches_full_slots:
    cleared slots are inert padding again, the pre-touch posterior back."""
    m0, jm0, _ = _fits(n=40, touch=8, block=8, linv=True)
    k = 5 if fill == "some" else m0.capacity - m0.n0
    tx = _touches(16, k)[0]
    m1, jm1 = gpr.update(m0, _t(tx), 0.0, 1e-6), jgpr.update(jm0, _j(tx), 0.0, 1e-6)
    m2, jm2 = gpr.reset_touches(m1), jgpr.reset_touches(jm1)
    assert m2.n_touch == int(jm2.n_touch) == 0 and m2.linv is None and jm2.linv is None
    q = np.random.default_rng(17).normal(size=(20, 3))
    _same_posterior(m2, jm2, q)
    mean0, var0 = gpr.predict(m0, _t(q))
    mean2, var2 = gpr.predict(m2, _t(q))
    _close(mean2, mean0, 1e-8)
    _close(var2, var0, 1e-8)


# ------------------------------------------------------------ joint update


def _joint_fits(linv, c=48, touch=8):
    x = np.random.default_rng(18).normal(size=(c, 3))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    p, jp = _params()
    m = gpd.fit_with_normals("rbf", _t(x), _t(np.zeros(c)), _t(x), 1e-4, 1e-3, p, block=16,
                             touch_capacity=touch)
    jm = jgpd.fit_with_normals("rbf", _j(x), _j(np.zeros(c)), _j(x), 1e-4, 1e-3, jp, block=16,
                               touch_capacity=touch)
    if linv:
        m, jm = gpd.with_linv_joint(m), jgpd.with_linv_joint(jm)
    return m, jm


@pytest.mark.parametrize("linv", [False, True])
def test_update_joint_matches_jax(linv):
    """tests/test_derivative.py's test_update_joint_matches_refit: two
    batches bordered into the joint tail, held to JAX's."""
    m, jm = _joint_fits(linv)
    rng = np.random.default_rng(19)
    for k, r in ((3, 1.03), (2, 0.97)):
        tx = rng.normal(size=(k, 3))
        tx = tx / np.linalg.norm(tx, axis=1, keepdims=True) * r
        m = gpd.update_joint(m, _t(tx), _t(np.zeros(k)), 1e-5)
        jm = jgpd.update_joint(jm, _j(tx), _j(np.zeros(k)), 1e-5)
    assert m.n_touch == int(jm.n_touch) == 5
    q = np.random.default_rng(20).normal(size=(32, 3))
    mean, var = gpd.predict(m, _t(q))
    jmean, jvar = jgpd.predict(jm, _j(q))
    _close(mean, jmean)
    _close(var, jvar)
    _close(gpd.predict_gradient(m, _t(q)), jgpd.predict_gradient(jm, _j(q)))
    _close(m.alpha, jm.alpha)
    _close(m.chol, jm.chol)
    if linv:
        _close(m.linv, jm.linv)


@pytest.mark.parametrize("case", ["overflow", "no_slots"])
def test_update_joint_guards_raise_as_jax(case):
    m, jm = _joint_fits(True, touch=8 if case == "overflow" else 0)
    tx = np.zeros((40, 3))
    want = _jax_message(lambda: jgpd.update_joint(jm, _j(tx), _j(np.zeros(40)), 1e-5))
    with pytest.raises(ValueError, match=f"^{want}$"):
        gpd.update_joint(m, _t(tx), _t(np.zeros(40)), 1e-5)


# ----------------------------------------------------------------- session


def _cfg(cls, **kw):
    base = dict(kernel="rbf", lengthscale=0.6, noise_surface=1e-4, n_external=32, block=64,
                touch_capacity=64, dtype="float64")
    return cls(**{**base, **kw})


@pytest.mark.parametrize("n", [100, 600])
def test_session_update_matches_jax_session(n):
    """Value sessions bordered twice.  At n = 100 (capacity 256) the JAX
    session predicts through the factor and the port through W; at 600
    (capacity 768) both carry W."""
    pts = fibonacci_sphere(n, radius=0.5) + np.array([0.2, -0.1, 0.3])
    sess = ObjectModelSession(_cfg(ModelConfig), device="cpu").start(pts)
    jsess = JaxSession(_cfg(JaxModelConfig)).start(pts)
    assert sess.model.capacity == jsess.model.capacity
    assert (jsess.model.linv is not None) == (n == 600) and sess.model.linv is not None
    touch = pts[:6] * 1.2
    _, v0 = sess.query(touch)
    sess.update(touch[:4])
    jsess.update(touch[:4])
    sess.update(touch[4:], targets=np.full(2, 0.25))
    jsess.update(touch[4:], targets=np.full(2, 0.25))
    assert sess.model.n_touch == int(jsess.model.n_touch) == 6
    mean, var = sess.query(touch)
    assert np.all(var < v0)
    np.testing.assert_allclose(mean, [0.0] * 4 + [0.25] * 2, atol=1e-3)
    q = np.concatenate([touch, np.random.default_rng(21).uniform(-0.6, 0.8, size=(40, 3))])
    _close(sess.query(q), jsess.query(q))


def test_session_update_without_slots_raises_as_jax():
    cfg = dict(touch_capacity=0)
    pts = fibonacci_sphere(100, radius=0.5)
    sess = ObjectModelSession(_cfg(ModelConfig, **cfg), device="cpu").start(pts)
    jsess = JaxSession(_cfg(JaxModelConfig, **cfg)).start(pts)
    want = _jax_message(lambda: jsess.update(pts[:2]))
    with pytest.raises(ValueError, match=f"^{want}$"):
        sess.update(pts[:2])


def test_session_joint_update_borders_then_refits_as_jax():
    """tests/test_derivative.py's test_session_joint_incremental_update: the
    bordering while slots last, then the refit that folds every touch into
    the core observations, each step held to the JAX session."""
    kw = dict(lengthscale=0.9, noise_surface=1e-5, n_external=16, block=16, touch_capacity=16)
    pts = fibonacci_sphere(60, radius=0.5)
    sess = ObjectModelSession(_cfg(ModelConfig, **kw), device="cpu").start(pts, normals=pts / 0.5)
    jsess = JaxSession(_cfg(JaxModelConfig, **kw)).start(pts, normals=pts / 0.5)
    t = np.array([[0.55, 0.0, 0.0]])
    rng = np.random.default_rng(2)
    many = rng.normal(size=(20, 3))
    many = many / np.linalg.norm(many, axis=1, keepdims=True) * 0.5
    q = np.concatenate([t, many[:5] * 1.1, rng.uniform(-0.6, 0.6, size=(20, 3))])
    _, v0 = sess.query(t)
    for batch, slots in ((t, 1), (many, 0), (many[:3] * 1.05, 3)):
        sess.update(batch)
        jsess.update(batch)
        assert sess.model.n_touch == int(jsess.model.n_touch) == slots
        _close(sess.query(q), jsess.query(q))
    _, v1 = sess.query(t)
    assert v1[0] < v0[0]
    assert len(sess._touches) == len(jsess._touches) == 3


def test_session_keeps_its_touches_across_start_as_jax():
    """The JAX session's start() does not clear the touches a joint
    overflow refit folds in (a reference quirk, mirrored): a second start
    and an overflow fold the first session's touches in too."""
    kw = dict(lengthscale=0.9, noise_surface=1e-5, n_external=16, block=16, touch_capacity=16)
    pts = fibonacci_sphere(60, radius=0.5)
    sessions = (ObjectModelSession(_cfg(ModelConfig, **kw), device="cpu"),
                JaxSession(_cfg(JaxModelConfig, **kw)))
    many = np.random.default_rng(3).normal(size=(20, 3))
    many = many / np.linalg.norm(many, axis=1, keepdims=True) * 0.45
    for s in sessions:
        s.start(pts, normals=pts / 0.5)
        s.update(many[:4])
        s.start(pts, normals=pts / 0.5)
        s.update(many[4:])  # overflows: the refit folds in all 20
    assert len(sessions[0]._touches) == len(sessions[1]._touches) == 2
    assert sessions[0].model.capacity == sessions[1].model.capacity
    q = np.random.default_rng(4).uniform(-0.6, 0.6, size=(30, 3))
    _close(sessions[0].query(q), sessions[1].query(q))


# ------------------------------------------------------------------ convert


def _arrays(jm, keys):
    return {k: np.asarray(getattr(jm, k)) for k in keys}


@pytest.mark.parametrize("linv", [False, True])
def test_touched_jax_model_converts_and_updates_alike(linv):
    m, jm, _ = _fits(linv=linv)
    t1, t2 = _touches(22, 5, 4)
    jm = jgpr.update(jm, _j(t1), 0.0, 1e-6)
    keys = ("x", "y", "noise", "alpha", "chol", "n_touch") + (("linv",) if linv else ())
    arrays = {**_arrays(jm, keys), "param_lengthscale": LS, "param_signal_variance": SV}
    meta = {"kernel": "rbf", "n0": jm.n0, "pad_noise": jm.pad_noise, "has_linv": linv}
    got = convert.gp_model_from_arrays(arrays, meta, device="cpu")
    assert got.n_touch == 5
    q = np.random.default_rng(23).normal(size=(20, 3))
    _same_posterior(got, jm, q)
    _same_posterior(gpr.update(got, _t(t2), 0.0, 1e-6), jgpr.update(jm, _j(t2), 0.0, 1e-6), q)


def test_touched_jax_joint_model_converts_and_updates_alike():
    m, jm = _joint_fits(True)
    tx = np.random.default_rng(24).normal(size=(5, 3)) * 0.8
    jm = jgpd.update_joint(jm, _j(tx[:3]), 0.0, 1e-5)
    keys = ("x", "y", "normals", "noise_f", "noise_g", "alpha", "chol", "linv", "touch_x",
            "touch_y", "touch_noise")
    arrays = {**_arrays(jm, keys), "param_lengthscale": LS, "param_signal_variance": SV}
    meta = {"kernel": "rbf", "n0": jm.n0, "joint": True, "has_linv": True, "joint_touch": True,
            "n_touch": int(jm.n_touch)}
    got = convert.gp_model_from_arrays(arrays, meta, device="cpu")
    q = np.random.default_rng(25).normal(size=(20, 3))
    for a, b in ((got, jm), (gpd.update_joint(got, _t(tx[3:]), 0.0, 1e-5),
                             jgpd.update_joint(jm, _j(tx[3:]), 0.0, 1e-5))):
        mean, var = gpd.predict(a, _t(q))
        jmean, jvar = jgpd.predict(b, _j(q))
        _close(mean, jmean)
        _close(var, jvar)
