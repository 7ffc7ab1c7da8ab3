"""The port's surface projection (`surface/projection.py`) and the session's
`surface_points` against the JAX package, on the CPU in float64.  JAX takes
the mean's gradient from `jax.grad` under `vmap`; the port from the
analytic gradient, all seeds in one masked batch.  Points are held at 1e-6
and the converged masks for equality, for in-core value and joint models,
an updated out-of-core model (its tail term) and the sessions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_exp_warm  # noqa: F401 -- warms torch.exp before any test (see the module)

from gpis_tpu.api.session import ObjectModelSession as JaxSession
from gpis_tpu.config import ModelConfig as JaxModelConfig
from gpis_tpu.data import gpis as jgpis
from gpis_tpu.gp import derivative as jgpd
from gpis_tpu.gp import regression as jgpr
from gpis_tpu.kernels import functions as jkf
from gpis_tpu.linalg import outofcore as jooc
from gpis_tpu.surface import projection as jproj
from gpis_tpu_torch.api.session import ObjectModelSession
from gpis_tpu_torch.config import ModelConfig
from gpis_tpu_torch.data import gpis
from gpis_tpu_torch.gp import derivative as gpd
from gpis_tpu_torch.gp import regression as gpr
from gpis_tpu_torch.kernels import functions as kf
from gpis_tpu_torch.linalg import outofcore as ooc
from gpis_tpu_torch.surface import projection


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _seeds(n, seed, lo=0.3, hi=2.5):
    """Seeds on spheres of radii from lo to hi: they converge after
    different numbers of steps, some not within a short budget."""
    rng = np.random.default_rng(seed)
    s = rng.normal(size=(n, 3))
    return s / np.linalg.norm(s, axis=1, keepdims=True) * rng.uniform(lo, hi, size=(n, 1))


@pytest.fixture(scope="module")
def sphere_models():
    """tests/test_surface.py's sphere model, in both packages, with W."""
    cfg = ModelConfig(kernel="rbf", lengthscale=0.8, noise_surface=1e-6, dtype="float64")
    pts = gpis.fibonacci_sphere(300, radius=1.0)
    ts = gpis.build_training_set(pts, cfg, device="cpu")
    jts = jgpis.build_training_set(pts, JaxModelConfig(kernel="rbf", lengthscale=0.8,
                                                       noise_surface=1e-6))
    p, jp = kf.kernel_params(0.8, 1.0), jkf.kernel_params(0.8, 1.0)
    m = gpr.with_linv(gpr.fit("rbf", ts.x, ts.y, ts.noise, p, block=128, touch_capacity=128))
    jm = jgpr.with_linv(jgpr.fit("rbf", jts.x, jts.y, jts.noise, jp, block=128,
                                 touch_capacity=128))
    return m, jm


def _same_projection(m, jm, seeds, **kw):
    pts, ok = projection.project_points(m, _t(seeds), **kw)
    jpts, jok = jproj.project_points(jm, _j(seeds), **kw)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(pts.numpy(), np.asarray(jpts), atol=1e-6)
    return pts, ok


@pytest.mark.parametrize("max_iters", [20, 3])
def test_project_points_matches_jax(sphere_models, max_iters):
    m, jm = sphere_models
    pts, ok = _same_projection(m, jm, _seeds(64, 1), max_iters=max_iters)
    if max_iters == 3:
        assert 0 < int(ok.sum()) < len(ok)  # the mask is not trivial
    else:
        assert bool(ok.all())
        np.testing.assert_allclose(gpr.predict_mean(m, pts).numpy(), 0.0, atol=1e-5)


def test_converged_seeds_do_not_move(sphere_models):
    """A seed that has converged within k steps sits at the same point, bit
    for bit, after 20 (the JAX loop stops it; the batch must too)."""
    m, jm = sphere_models
    seeds = _seeds(64, 2)
    early, ok_early = projection.project_points(m, _t(seeds), max_iters=3)
    late, ok_late = projection.project_points(m, _t(seeds), max_iters=20)
    assert 0 < int(ok_early.sum()) < len(seeds) and bool(ok_late[ok_early].all())
    assert torch.equal(late[ok_early], early[ok_early])
    jearly, jok = jproj.project_points(jm, _j(seeds), max_iters=3)
    jlate, _ = jproj.project_points(jm, _j(seeds), max_iters=20)
    np.testing.assert_array_equal(np.asarray(jlate)[np.asarray(jok)],
                                  np.asarray(jearly)[np.asarray(jok)])


def test_project_point_matches_jax(sphere_models):
    m, jm = sphere_models
    x0 = np.array([0.3, -1.2, 0.4])
    for clip in (0.25, 0.05):
        x, ok = projection.project_point(m, _t(x0), step_clip=clip)
        jx, jok = jproj.project_point(jm, _j(x0), step_clip=clip)
        assert bool(ok) == bool(jok)
        np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=1e-6)


def test_surface_normals_match_jax(sphere_models):
    m, jm = sphere_models
    pts = gpis.fibonacci_sphere(32, radius=1.0)
    n = projection.surface_normals(m, _t(pts)).numpy()
    np.testing.assert_allclose(n, np.asarray(jproj.surface_normals(jm, _j(pts))), atol=1e-6)
    assert np.all(np.sum(n * pts, axis=1) > 0.99)


def test_joint_model_projection_matches_jax():
    c = 64
    x = gpis.fibonacci_sphere(c, radius=1.0)
    p, jp = kf.kernel_params(0.8, 1.0), jkf.kernel_params(0.8, 1.0)
    m = gpd.with_linv_joint(gpd.fit_with_normals("rbf", _t(x), _t(np.zeros(c)), _t(x), 1e-4,
                                                 1e-3, p, block=16, touch_capacity=8))
    jm = jgpd.with_linv_joint(jgpd.fit_with_normals("rbf", _j(x), _j(np.zeros(c)), _j(x), 1e-4,
                                                    1e-3, jp, block=16, touch_capacity=8))
    t = np.array([[1.1, 0.0, 0.0], [0.0, -1.05, 0.2]])
    m, jm = gpd.update_joint(m, _t(t), 0.0, 1e-5), jgpd.update_joint(jm, _j(t), 0.0, 1e-5)
    seeds = _seeds(48, 3, 0.5, 2.0)
    for k in (20, 4):
        _same_projection(m, jm, seeds, max_iters=k)
    np.testing.assert_allclose(projection.surface_normals(m, _t(seeds)).numpy(),
                               np.asarray(jproj.surface_normals(jm, _j(seeds))), atol=1e-6)


@pytest.mark.parametrize("joint", [False, True])
def test_updated_out_of_core_projection_matches_jax(joint):
    """The tail's term in the mean and in its gradient: an out-of-core model
    after two touch batches."""
    n = 120 if joint else 300
    x = gpis.fibonacci_sphere(n, radius=1.0)
    y = np.zeros(n)
    p, jp = kf.kernel_params(0.7, 1.1), jkf.kernel_params(0.7, 1.1)
    if joint:
        m = ooc.ooc_fit_joint("rbf", _t(x), _t(y), _t(x), 1e-4, 1e-3, p, panel=128, block=64)
        jm = jooc.ooc_fit_joint("rbf", _j(x), _j(y), _j(x), 1e-4, 1e-3, jp, panel=128, block=64)
    else:
        m = ooc.ooc_fit("rbf", _t(x), _t(y), 1e-4, p, panel=128, block=64)
        jm = jooc.ooc_fit("rbf", _j(x), _j(y), 1e-4, jp, panel=128, block=64)
    rng = np.random.default_rng(4)
    for k in (3, 2):
        t = rng.normal(size=(k, 3))
        t = t / np.linalg.norm(t, axis=1, keepdims=True) * 1.08
        m = m.update(_t(t), 0.0, 1e-5, tail_capacity=8)
        jm = jm.update(_j(t), 0.0, 1e-5, tail_capacity=8)
    seeds = _seeds(40, 5, 0.6, 2.0)
    np.testing.assert_allclose(gpr.predict_mean(m, _t(seeds)).numpy(),
                               np.asarray(jgpr.predict_mean(jm, _j(seeds))), atol=1e-6)
    _same_projection(m, jm, seeds)
    np.testing.assert_allclose(projection.surface_normals(m, _t(seeds)).numpy(),
                               np.asarray(jproj.surface_normals(jm, _j(seeds))), atol=1e-6)


def _session_cfg(cls):
    return cls(kernel="rbf", lengthscale=0.6, noise_surface=1e-4, n_external=32, block=64,
               touch_capacity=64, dtype="float64")


@pytest.mark.parametrize("normals", [False, True])
def test_session_surface_points_match_jax(normals):
    center = np.array([0.3, -0.2, 1.0])
    pts = gpis.fibonacci_sphere(120 if normals else 200) * 1.7 + center
    kw = {"normals": (pts - center) / 1.7} if normals else {}
    sess = ObjectModelSession(_session_cfg(ModelConfig), device="cpu").start(pts, **kw)
    jsess = JaxSession(_session_cfg(JaxModelConfig)).start(pts, **kw)
    sess.update(pts[:3] * 1.01)
    jsess.update(pts[:3] * 1.01)
    for seeds in (None, _seeds(30, 6, 0.5, 3.0) + center):
        got, ok = sess.surface_points(seeds, n=64)
        want, jok = jsess.surface_points(seeds, n=64)
        np.testing.assert_array_equal(ok, np.asarray(jok))
        np.testing.assert_allclose(got, want, atol=1e-6)
        assert ok.sum() >= 0.9 * len(ok)
        np.testing.assert_allclose(sess.query(got)[0], 0.0, atol=1e-5)
